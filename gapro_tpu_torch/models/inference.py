"""Instance extraction from ISBNet proposals (``gapro_tpu/models/inference.py``).

On the device: score = sqrt(softmax(cls)[:, :C] * clip(conf, 0, 1)), flat
top-K over (proposal, class), npoint threshold and matrix NMS at superpoint
resolution, then expansion to points with superpoint refinement (a point
keeps the mask where at least half of its own superpoint does), and the
run boundaries of the kept masks. On the host: the benchmark's records
``{scan_id, label_id, conf, pred_mask}`` (RLE).

The s3dis-only options of the JAX ``TestConfig`` (``sem2ins_classes``,
``x4_split``) are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..core.bucketing import next_bucket
from ..core.segment import segment_mean, segment_sum
from ..ops.nms import matrix_nms, stable_topk
from ..utils.rle import rle_encode_rows


@dataclass(frozen=True)
class TestConfig:
    """Defaults of boxsup_isbnet_scannetv2.yaml's test section."""

    logit_thresh: float = 0.0
    score_thresh: float = 0.2
    npoint_thresh: int = 100
    type_nms: str = "matrix"
    topk: int = 100
    topk_insts: int = 300
    instance_classes: int = 18
    label_offset: int = 1

    @classmethod
    def from_dict(cls, d) -> "TestConfig":
        """A config's ``test`` section -> TestConfig; keys it does not know
        are ignored, and the s3dis options raise until they are ported."""
        d = dict(d or {})
        if d.get("x4_split") or d.get("sem2ins_classes"):
            raise NotImplementedError("the s3dis test options x4_split and sem2ins_classes "
                                      "are not ported yet")
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def select_proposals(cls_logits, conf_logits, mask_logits, box_preds, proposal_valid,
                     spp_weights, cfg: TestConfig):
    """Top-k scoring + npoint filter + matrix NMS for one scene.

    cls_logits [P, C+1], conf_logits [P], mask_logits [P, S], box_preds
    [P, 6], proposal_valid [P], spp_weights [S] (voxels per superpoint) ->
    (mask_spp [K, S] bool, cls [K], score [K], box [K, 6], keep [K]),
    K = cfg.topk.
    """
    C = cfg.instance_classes
    sm = torch.softmax(cls_logits, -1)[:, :C]
    conf = conf_logits.clamp(0.0, 1.0)
    scores = torch.sqrt(torch.clamp(sm * conf[:, None], min=0.0))
    scores = torch.where(proposal_valid[:, None], scores, -1.0)

    flat = scores.reshape(-1)
    top_scores, top_idx = stable_topk(flat, min(cfg.topk_insts, flat.shape[0]))
    p_idx = torch.div(top_idx, C, rounding_mode="floor")
    cls_ids = (top_idx % C).int()

    masks = (mask_logits[p_idx] >= cfg.logit_thresh) & (spp_weights > 0)[None, :]
    npoints = (masks * spp_weights[None, :]).sum(1)
    ok = (npoints >= cfg.npoint_thresh) & (top_scores > 0)
    sel, new_scores, keep = matrix_nms(masks.float(), torch.where(ok, cls_ids, -1),
                                       torch.where(ok, top_scores, -1.0),
                                       spp_weights.float(), cfg.topk)
    return masks[sel], cls_ids[sel], new_scores, box_preds[p_idx[sel]], keep & ok[sel]


def refine_masks_on_points(mask_spp, point_slot, point_spp_compact, n_point_spp: int):
    """Expand [K, S] superpoint masks to points and refine: a point is in
    the mask where the mean over its own superpoint is >= 0.5.
    Returns (refined [K, N] bool, npoints [K])."""
    pm = torch.where(point_slot[None, :] >= 0,
                     mask_spp[:, point_slot.clamp(min=0).long()], False)
    frac = segment_mean(pm.T.float(), point_spp_compact, n_point_spp)  # [n_spp, K]
    refined = (frac >= 0.5).T[:, point_spp_compact.clamp(min=0).long()]
    refined = refined & (point_spp_compact >= 0)[None, :]
    return refined, refined.sum(1)


def isbnet_postprocess(outputs, spp_vox, valid, point2voxel, point_spp_c,
                       n_pspp_cap: int, cfg: TestConfig):
    """The device stage for batch item 0: superpoint weights, slot plumbing,
    top-k/NMS and point refinement -> (refined, npts, keep, scores, cls)."""
    sp_dense_idx = outputs["sp_dense_idx"][0]
    sp_dense_valid = outputs["sp_dense_valid"][0]
    s = sp_dense_idx.shape[0]
    vcap = spp_vox.shape[0]
    dev = spp_vox.device

    valid_vox = valid & (spp_vox >= 0)
    counts_flat = segment_sum(valid_vox.float(), torch.where(valid_vox, spp_vox, -1), vcap)
    spp_weights = torch.where(sp_dense_valid, counts_flat[sp_dense_idx.clamp(min=0).long()], 0.0)

    mask_spp, cls_ids, scores, _, keep = select_proposals(
        outputs["cls_logits"][0], outputs["conf_logits"][0], outputs["mask_logits"][0],
        outputs["query_box_preds"][0], outputs["query_valid"][0], spp_weights, cfg)

    slot_of_flat = torch.full((vcap + 1,), -1, dtype=torch.int32, device=dev)
    slot_of_flat[sp_dense_idx[sp_dense_valid].long()] = torch.arange(
        s, dtype=torch.int32, device=dev)[sp_dense_valid]
    slot_of_flat[vcap] = -1
    vox_slot = torch.where(valid_vox, slot_of_flat[spp_vox.clamp(0, vcap).long()], -1)
    point_slot = torch.where(point2voxel >= 0, vox_slot[point2voxel.clamp(min=0).long()], -1)

    refined, npts = refine_masks_on_points(mask_spp, point_slot, point_spp_c, n_pspp_cap)
    keep = keep & (npts >= cfg.npoint_thresh)
    return refined, npts, keep, scores, cls_ids


def get_instances(scan_id: str, outputs: dict, batch, point_spp: np.ndarray,
                  point2voxel, n_points: int, cfg: TestConfig = TestConfig()) -> List[dict]:
    """Batch-1 proposal extraction -> [{scan_id, label_id, conf,
    pred_mask (rle)}]. ``point2voxel`` lies on the model's device;
    ``point_spp`` holds the raw point superpoint ids (host numpy)."""
    dev = batch.spp.device
    n_pad = point2voxel.shape[0]
    ps = np.full(n_pad, -1, np.int64)
    ps[:min(len(point_spp), n_pad)] = np.asarray(point_spp)[:n_pad]
    ps[n_points:] = -1  # padding rows carry no superpoint
    vp = ps >= 0
    point_spp_c = np.full(n_pad, -1, np.int32)
    n_pspp = 0
    if vp.any():
        uniq, inv = np.unique(ps[vp], return_inverse=True)
        point_spp_c[vp] = inv.astype(np.int32)
        n_pspp = len(uniq)

    refined, _, keep, scores, cls_ids = isbnet_postprocess(
        outputs, batch.spp, batch.valid, point2voxel.int(),
        torch.as_tensor(point_spp_c, device=dev),
        next_bucket(max(n_pspp, 1), min_size=128), cfg)
    kept = torch.nonzero(keep).flatten()
    rles = rle_encode_rows(refined[kept, :n_points])
    scores = scores[kept].cpu().numpy()
    labels = cls_ids[kept].cpu().numpy()
    return [dict(scan_id=scan_id, label_id=int(labels[j]) + cfg.label_offset,
                 conf=float(scores[j]), pred_mask=rles[j])
            for j in range(len(kept))]
