"""Instance extraction from ISBNet and SPFormer proposals
(``gapro_tpu/models/inference.py``).

ISBNet, on the device: score = sqrt(softmax(cls)[:, :C] * clip(conf, 0,
1)), flat top-K over (proposal, class), npoint threshold and matrix NMS at
superpoint resolution, then expansion to points with superpoint refinement
(a point keeps the mask where at least half of its own superpoint does),
and the run boundaries of the kept masks. On the host: the benchmark's
records ``{scan_id, label_id, conf, pred_mask}`` (RLE).

SPFormer (the final decoder head): score = softmax(cls)[:, :C] * score
head, flat top-K (ties to the lower index, as ``lax.top_k``), mask = logit
> 0, the score times the mean sigmoid inside the mask; no NMS. The point
masks cross to the host bit-packed.

S3DIS (``TestConfig.sem2ins_classes``): each of those classes (ceiling and
floor) is one more instance of confidence 1, ahead of the NMS instances,
taken from the devoxelized semantic argmax and aligned to the superpoints
by a majority of at least half (span ``instances.sem2ins``).
``TestConfig.x4_split`` is read by the test CLI, which serves an S3DIS
room in 4 interleaved pieces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from ..core.bucketing import next_bucket
from ..core.segment import segment_mean, segment_sum
from ..ops.nms import matrix_nms, stable_topk
from ..utils import profiling
from ..utils.rle import rle_encode, rle_encode_rows


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
    label_offset: int = 1  # ScanNet: 1; S3DIS: 3
    x4_split: bool = False
    # S3DIS: the classes served as one instance each from the semantic
    # argmax (ceiling 0 and floor 1)
    sem2ins_classes: Tuple[int, ...] = ()

    @classmethod
    def from_dict(cls, d) -> "TestConfig":
        """A config's ``test`` section -> TestConfig; keys it does not know
        are ignored."""
        kw = {k: v for k, v in dict(d or {}).items() if k in cls.__dataclass_fields__}
        if "sem2ins_classes" in kw:
            kw["sem2ins_classes"] = tuple(kw["sem2ins_classes"] or ())
        return cls(**kw)


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

    point_spp_c = torch.as_tensor(point_spp_c, device=dev)
    instances = []
    if cfg.sem2ins_classes:
        with profiling.span("instances.sem2ins"):
            masks = sem2ins_masks(outputs["semantic_scores"], point2voxel, point_spp_c, n_pspp,
                                  n_points, cfg.sem2ins_classes)
            instances = [dict(scan_id=scan_id, label_id=c + 1, conf=1.0, pred_mask=rle)
                         for c, rle in zip(cfg.sem2ins_classes, rle_encode_rows(masks))]
    refined, _, keep, scores, cls_ids = isbnet_postprocess(
        outputs, batch.spp, batch.valid, point2voxel.int(), point_spp_c,
        next_bucket(max(n_pspp, 1), min_size=128), cfg)
    kept = torch.nonzero(keep).flatten()
    rles = rle_encode_rows(refined[kept, :n_points])
    scores = scores[kept].cpu().numpy()
    labels = cls_ids[kept].cpu().numpy()
    return instances + [dict(scan_id=scan_id, label_id=int(labels[j]) + cfg.label_offset,
                             conf=float(scores[j]), pred_mask=rles[j])
                        for j in range(len(kept))]


def sem2ins_masks(semantic_scores, point2voxel, point_spp_c, n_pspp: int, n_points: int,
                  classes) -> torch.Tensor:
    """The points of each class in ``classes`` by the semantic argmax of
    their voxel (a point of no voxel has none), then made whole superpoints:
    a superpoint joins the mask where at least half of its points are in it
    and leaves it otherwise. -> [len(classes), n_points] bool."""
    dev = semantic_scores.device
    p2v = point2voxel[:n_points].long()
    sem = torch.where(p2v >= 0, semantic_scores.argmax(1)[p2v.clamp(min=0)], -1)
    masks = sem[None, :] == torch.as_tensor(classes, device=dev)[:, None]
    if n_pspp == 0:
        return masks
    sc = point_spp_c[:n_points].long()
    ok = sc >= 0
    counts = torch.bincount(sc[ok], minlength=n_pspp)
    inside = torch.stack([torch.bincount(sc[ok & m], minlength=n_pspp) for m in masks])
    spp_mask = 2 * inside >= counts.clamp(min=1)
    return torch.where(ok, spp_mask[:, sc.clamp(min=0)], masks)


def spformer_select(cls_logits, score_logits, mask_logits, spp_weights, topk_insts: int,
                    num_class: int):
    """cls_logits [Q, C+1], score_logits [Q], mask_logits [Q, S], spp_weights
    [S] -> (masks [K, S] bool, cls [K], scores [K], npoints [K]),
    K = ``topk_insts``."""
    C = num_class
    scores = torch.softmax(cls_logits, -1)[:, :C] * score_logits[:, None]  # [Q, C]
    top_scores, top_idx = stable_topk(scores.reshape(-1), topk_insts)
    q_idx = torch.div(top_idx, C, rounding_mode="floor")
    cls_ids = (top_idx % C).int()
    ml = mask_logits[q_idx]  # [K, S]
    masks = (ml > 0) & (spp_weights > 0)[None, :]
    denom = (masks * spp_weights[None, :]).sum(1)
    mask_scores = (torch.sigmoid(ml) * masks * spp_weights[None, :]).sum(1) / (denom + 1e-6)
    return masks, cls_ids, top_scores * mask_scores, denom


def _packbits(masks):
    """[K, N] bool -> [K, ceil(N / 8)] uint8, ``np.packbits(axis=1)``'s
    layout (the first column in the top bit)."""
    k, n = masks.shape
    m = torch.nn.functional.pad(masks.to(torch.uint8), (0, -n % 8)).reshape(k, -1, 8)
    bits = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=masks.device)
    return (m * bits).sum(-1, dtype=torch.uint8)


def spformer_postprocess(outputs, spp_vox, valid, point2voxel, topk_insts: int,
                         num_class: int):
    """The device stage for batch item 0: superpoint weights, selection and
    expansion to points -> (packed point masks [K, ceil(N / 8)], cls [K],
    scores [K], points per mask [K])."""
    sp_dense_idx = outputs["sp_dense_idx"][0]
    sp_dense_valid = outputs["sp_dense_valid"][0]
    s = sp_dense_idx.shape[0]
    vcap = spp_vox.shape[0]
    dev = spp_vox.device

    valid_vox = valid & (spp_vox >= 0)
    counts_flat = segment_sum(valid_vox.float(), torch.where(valid_vox, spp_vox, -1), vcap)
    spp_weights = torch.where(sp_dense_valid, counts_flat[sp_dense_idx.clamp(min=0).long()], 0.0)
    masks, cls_ids, scores, _ = spformer_select(
        outputs["labels"][-1][0], outputs["scores"][-1][0], outputs["masks"][-1][0],
        spp_weights, topk_insts, num_class)

    slot_of_flat = torch.full((vcap + 1,), -1, dtype=torch.int32, device=dev)
    slot_of_flat[sp_dense_idx[sp_dense_valid].long()] = torch.arange(
        s, dtype=torch.int32, device=dev)[sp_dense_valid]
    slot_of_flat[vcap] = -1
    vox_slot = torch.where(valid_vox, slot_of_flat[spp_vox.clamp(0, vcap).long()], -1)
    point_slot = torch.where(point2voxel >= 0, vox_slot[point2voxel.clamp(min=0).long()], -1)
    pm = torch.where(point_slot[None, :] >= 0, masks[:, point_slot.clamp(min=0).long()], False)
    return _packbits(pm), cls_ids, scores, pm.sum(1)


def spformer_get_instances(scan_id: str, outputs: dict, batch, point_spp, point2voxel,
                           n_points: int, num_class: int = 18, topk_insts: int = 100,
                           score_thr: float = 0.0, npoint_thr: int = 100) -> List[dict]:
    """SPFormer's batch-1 proposals -> [{scan_id, label_id, conf, pred_mask
    (rle)}] (``point_spp`` is not read, as in the JAX package).
    ``point2voxel`` lies on the model's device; one copy brings the packed
    masks, classes, scores and point counts to the host."""
    packed, cls_ids, scores, npts = spformer_postprocess(
        outputs, batch.spp, batch.valid, point2voxel.int(), topk_insts, num_class)
    packed, cls_ids, scores, npts = (t.cpu().numpy() for t in (packed, cls_ids, scores, npts))
    masks_pt = np.unpackbits(packed, axis=1, count=point2voxel.shape[0]).astype(bool)
    return [dict(scan_id=scan_id, label_id=int(cls_ids[i]) + 1, conf=float(scores[i]),
                 pred_mask=rle_encode(masks_pt[i][:n_points]))
            for i in range(len(masks_pt)) if scores[i] > score_thr and npts[i] > npoint_thr]
