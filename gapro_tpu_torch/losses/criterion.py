"""ISBNet training criterion with the GaPro losses
(``gapro_tpu/losses/criterion.py``).

* point-wise: semantic CE, L1 corner offsets, gIoU and conf MSE;
* instance level, after Hungarian matching: dice, prob-weighted BCE (the GP
  labels' confidence), IoU MSE, class CE, box L1 and gIoU;
* the level-set loss over RGB inside the GT boxes;
* the KL loss between the predicted (mu, logvar) and the GP label (mu, var).

Every term is a masked static-shape reduction over dense [B, Q, S] / [B, I]
tensors, as in the JAX package. Gradients reach exact ties with
``jnp.maximum``'s and ``jnp.abs``'s rules (``models/common.py``), and no
branch that a mask drops puts NaN into a gradient (``safe_var``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple

import torch

from ..core.batching import gather_dense
from ..core.segment import segment_max, segment_mean, segment_min, segment_weighted_mean
from ..models.common import jabs
from .matcher import box_volume, hungarian_match, softplus


@dataclass(frozen=True)
class CriterionConfig:
    instance_classes: int = 18
    ignore_label: int = -100
    eos_coef: float = 0.1
    voxel_scale: float = 50.0
    semantic_only: bool = False
    trainall: bool = False
    inst_cap: int = 128  # static max GT instances per batch item
    loss_weight: tuple = (
        ("dice_loss", 1.0),
        ("bce_loss", 1.0),
        ("cls_loss", 0.5),
        ("iou_loss", 0.5),
        ("box_loss", 0.5),
        ("giou_loss", 0.5),
        ("levelset_loss", 0.5),
        ("kl_loss", 0.1),
    )


class Targets(NamedTuple):
    """Dense GT per batch item (static shapes)."""

    gt_cls: torch.Tensor  # [B, I] int32 (-1 invalid)
    gt_boxes: torch.Tensor  # [B, I, 6]
    gt_sp_masks: torch.Tensor  # [B, I, S] float (superpoint-pooled >= 0.5)
    gt_valid: torch.Tensor  # [B, I] bool
    sp_prob: torch.Tensor  # [B, S]
    sp_mu: torch.Tensor  # [B, S]
    sp_var: torch.Tensor  # [B, S]
    sp_rgb: torch.Tensor  # [B, S, 3]
    corners_offset_labels: torch.Tensor  # [V, 6]
    num_gts: torch.Tensor  # scalar
    # voxels whose GT instance id >= inst_cap (their instances leave the loss)
    n_inst_overflow_voxels: torch.Tensor


class PointwiseTargets(NamedTuple):
    """The targets of the backbone pre-training stage (``semantic_only``):
    the corner-offset labels alone (``corner_labels_only``)."""

    corners_offset_labels: torch.Tensor  # [V, 6]
    # not counted: the constant 0, as in the JAX package (corner_labels_only
    # gives ids past inst_cap the last instance's corners)
    n_inst_overflow_voxels: int = 0


@torch.no_grad()
def build_targets(voxel_instance, voxel_semantic, coords_float, spp, batch_idx, valid,
                  sp_dense_idx, n_spp: int, inst_cap: int, voxel_prob=None, voxel_mu=None,
                  voxel_var=None, voxel_rgb=None, vox_weights=None,
                  pool: str = "mean") -> Targets:
    """GT construction on the device: per-instance class (the semantic label
    of its lowest-index voxel), box, corner-offset labels, superpoint masks
    (fraction of a superpoint's voxels in the instance >= 0.5) and the
    superpoint pools of the GP labels and colours.

    ``vox_weights`` ([V] member points per voxel) makes the mask fractions
    and the mean pools point-weighted, as SPFormer pools points;
    ``pool="max"`` takes each superpoint's largest label instead of the
    mean."""
    v = voxel_instance.shape[0]
    B, S = sp_dense_idx.shape
    I = inst_cap
    dev = voxel_instance.device

    inst = torch.where(valid & (voxel_instance >= 0), voxel_instance, -1)
    member = inst >= 0

    big = torch.iinfo(torch.int32).max
    vidx = torch.arange(v, dtype=torch.int32, device=dev)
    first_vox = segment_min(torch.where(member, vidx, big), inst, I)
    has_member = first_vox < big
    inst_cls = torch.where(has_member, voxel_semantic[first_vox.clamp(max=v - 1).long()], -1)

    posinf = 1e10
    cmin = segment_min(torch.where(member[:, None], coords_float, posinf), inst, I)
    cmax = segment_max(torch.where(member[:, None], coords_float, -posinf), inst, I)
    boxes = torch.where(has_member[:, None], torch.cat([cmin, cmax], 1), 0.0)

    # ids past the cap read the last instance, as JAX's clamped gathers do
    at = inst.clamp(0, I - 1).long()
    corners = torch.cat([cmin[at] - coords_float, cmax[at] - coords_float], 1)
    corners = torch.where(member[:, None], corners, -100.0)

    inst_batch = segment_max(torch.where(member, batch_idx.int(), -1), inst, I)

    onehot = (inst[:, None] == torch.arange(I, device=dev)[None, :]).float()  # [V, I]
    frac = (segment_mean(onehot, spp, n_spp) if vox_weights is None
            else segment_weighted_mean(onehot, spp, vox_weights, n_spp))
    sp_masks_flat = (frac >= 0.5).float()
    d_masks = gather_dense(sp_masks_flat, sp_dense_idx).transpose(1, 2)  # [B, I, S]

    inst_valid_row = (inst_cls >= 0) & has_member
    gt_valid = inst_valid_row[None, :] & (inst_batch[None, :] ==
                                          torch.arange(B, device=dev)[:, None])
    gt_cls = torch.where(gt_valid, inst_cls[None, :], -1).int()
    gt_boxes = torch.where(gt_valid[..., None], boxes[None], 0.0)
    d_masks = torch.where(gt_valid[..., None], d_masks, 0.0)

    def pool_flat(x):
        x = x.float()
        if pool == "max":
            neg = -1e10
            out = segment_max(torch.where(valid.reshape(valid.shape + (1,) * (x.ndim - 1)), x,
                                          neg), spp, n_spp)
            return torch.where(out <= neg, 0.0, out)
        if vox_weights is None:
            return segment_mean(x, spp, n_spp)
        return segment_weighted_mean(x, spp, vox_weights, n_spp)

    def pool_dense(x):
        if x is None:
            return torch.zeros((B, S), dtype=torch.float32, device=dev)
        return gather_dense(pool_flat(x), sp_dense_idx)

    sp_rgb = (torch.zeros((B, S, 3), dtype=torch.float32, device=dev) if voxel_rgb is None
              else gather_dense(pool_flat(voxel_rgb), sp_dense_idx))
    return Targets(
        gt_cls=gt_cls, gt_boxes=gt_boxes, gt_sp_masks=d_masks, gt_valid=gt_valid,
        sp_prob=pool_dense(voxel_prob), sp_mu=pool_dense(voxel_mu), sp_var=pool_dense(voxel_var),
        sp_rgb=sp_rgb,
        corners_offset_labels=corners, num_gts=gt_valid.sum().int(),
        n_inst_overflow_voxels=(valid & (voxel_instance >= I)).sum().int())


@torch.no_grad()
def corner_labels_only(voxel_instance, coords_float, valid, inst_cap: int):
    """Per-voxel box-corner offset labels without the superpoint and
    instance targets: the backbone pre-training stage (``semantic_only``)
    has no decoder outputs, and no ``sp_dense_idx``, but trains the offset
    head."""
    I = inst_cap
    inst = torch.where(valid & (voxel_instance >= 0), voxel_instance, -1)
    ok = inst >= 0
    posinf = 1e10
    cmin = segment_min(torch.where(ok[:, None], coords_float, posinf), inst, I)
    cmax = segment_max(torch.where(ok[:, None], coords_float, -posinf), inst, I)
    # ids past the cap read the last instance, as JAX's clamped gathers do
    at = inst.clamp(0, I - 1).long()
    corners = torch.cat([cmin[at] - coords_float, cmax[at] - coords_float], 1)
    return torch.where(ok[:, None], corners, -100.0)


def _masked_mean(x, mask, eps=1e-6):
    m = mask.float()
    return (x * m).sum() / (m.sum() + eps)


def pointwise_loss(outputs, voxel_semantic, voxel_instance, corners_labels, coords_float, valid,
                   cfg: CriterionConfig):
    sem_logits = outputs["semantic_scores"]
    n_cls = sem_logits.shape[-1]
    sem_valid = valid & (voxel_semantic != cfg.ignore_label)
    logp = torch.log_softmax(sem_logits, -1)
    tgt = voxel_semantic.clamp(0, n_cls - 1).long()
    ce = -torch.gather(logp, 1, tgt[:, None])[:, 0]
    sem_loss = _masked_mean(ce, sem_valid)

    pos = (valid & (voxel_instance != cfg.ignore_label) & (voxel_instance >= 0)).float()
    npos = pos.sum().clamp(min=1.0)
    co = outputs["corners_offset"]
    offset_loss = (jabs(co - corners_labels) * pos[:, None]).sum() / npos

    box_pred = co + coords_float.repeat(1, 2)
    box_gt = corners_labels + coords_float.repeat(1, 2)
    iou, giou = _giou_corres(box_pred, box_gt)
    giou_loss = ((1.0 - giou) * pos).sum() / npos
    conf_loss = ((outputs["box_conf"] - iou.detach()) ** 2 * pos).sum() / npos
    return {
        "pw_sem_loss": sem_loss,
        "pw_corners_loss": offset_loss * (cfg.voxel_scale / 50.0),
        "pw_giou_loss": giou_loss,
        "pw_conf_loss": conf_loss,
    }


def _giou_corres(boxes1, boxes2):
    """Elementwise iou, giou of [..., 6] box pairs."""
    inter = box_volume(torch.maximum(boxes1[..., :3], boxes2[..., :3]),
                       torch.minimum(boxes1[..., 3:], boxes2[..., 3:]))
    union = (box_volume(boxes1[..., :3], boxes1[..., 3:])
             + box_volume(boxes2[..., :3], boxes2[..., 3:]) - inter)
    iou = inter / (union + 1e-6)
    bound = box_volume(torch.minimum(boxes1[..., :3], boxes2[..., :3]),
                       torch.maximum(boxes1[..., 3:], boxes2[..., 3:]))
    return iou, iou - (bound - union) / (bound + 1e-6)


def _bce_with_logits(logits, targets):
    return softplus(logits) - logits * targets


def match(outputs, targets: Targets):
    """``hungarian_match`` on the model outputs and targets -> [B, I]."""
    return hungarian_match(
        outputs["cls_logits"], outputs["mask_logits"], outputs["conf_logits"],
        outputs["query_box_preds"], targets.gt_cls, targets.gt_sp_masks, targets.gt_boxes,
        targets.gt_valid, outputs["sp_dense_valid"], outputs["query_valid"])


def instance_loss(outputs, targets: Targets, cfg: CriterionConfig, assign=None):
    """Matched instance losses over dense [B, I] / [B, Q, S] tensors.

    ``assign``: an optional [B, I] matched query per GT (-1 unmatched); the
    Hungarian matcher runs when it is None.
    """
    cls_logits = outputs["cls_logits"]  # [B, Q, C+1]
    mask_logits = outputs["mask_logits"]  # [B, Q, S]
    conf_logits = outputs["conf_logits"]  # [B, Q]
    box_preds = outputs["query_box_preds"]  # [B, Q, 6]
    q_valid = outputs["query_valid"]  # [B, Q]
    sp_valid = outputs["sp_dense_valid"]  # [B, S]
    B, Q, _ = cls_logits.shape
    dev = cls_logits.device
    if assign is None:
        assign = match(outputs, targets)
    matched = targets.gt_valid & (assign >= 0)
    a = assign.clamp(min=0).long()
    mf = matched.float()

    m_logits = torch.gather(mask_logits, 1, a[..., None].expand(-1, -1, mask_logits.shape[2]))
    m_conf = torch.gather(conf_logits, 1, a)
    m_box = torch.gather(box_preds, 1, a[..., None].expand(-1, -1, 6))

    svf = sp_valid[:, None, :].float()  # [B, 1, S]
    mvalid = mf[..., None]  # [B, I, 1]
    gt_m = targets.gt_sp_masks

    # per-batch GT counts; every sum is normalised per item, then averaged over B
    num_gt_b = mf.sum(1)
    denom_b = num_gt_b.clamp(min=1e-6)
    batch_has = (num_gt_b > 0).float()

    def per_item(x):  # [B, I] -> batch mean of the per-item sums over matched GTs
        return (x.sum(1) / denom_b * batch_has).sum() / B

    sig = torch.sigmoid(m_logits)
    p = sig * svf * mvalid
    t = gt_m * svf * mvalid
    dice = (1.0 - (2.0 * (p * t).sum(-1) + 1.0) / (p.sum(-1) + t.sum(-1) + 1.0)) * mf
    dice_loss = per_item(dice)

    bce = _bce_with_logits(m_logits, gt_m) * svf * mvalid
    probw = targets.sp_prob[:, None, :] * svf
    bce_num = (bce * probw).sum((1, 2))
    bce_den = (targets.sp_prob * sp_valid).sum(1).clamp(min=1e-6)
    bce_loss = (bce_num / bce_den / denom_b * batch_has).sum() / B

    pred_bin = (sig >= 0.5).float() * svf
    inter = (pred_bin * t).sum(-1)
    union = pred_bin.sum(-1) + t.sum(-1) - inter
    gt_iou = inter / (union + 1e-6)
    iou_loss = per_item((m_conf - gt_iou.detach()) ** 2 * mf)

    # class CE over all queries; unmatched queries are "no object"
    C = cfg.instance_classes
    tgt_cls = torch.full((B, Q), C, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)[:, None].expand_as(a)
    tgt_cls[rows[matched], a[matched]] = targets.gt_cls[matched].long()
    logp = torch.log_softmax(cls_logits, -1)
    ce = -torch.gather(logp, 2, tgt_cls.clamp(0, C)[..., None])[..., 0]
    w = torch.where(tgt_cls == C, cfg.eos_coef, 1.0) * q_valid.float()
    cls_loss = ((ce * w).sum(1) / w.sum(1).clamp(min=1e-6) * batch_has).sum() / B

    l1 = jabs(m_box - targets.gt_boxes).sum(-1) * mf
    box_loss = (cfg.voxel_scale / 50.0) * per_item(l1)
    _, giou = _giou_corres(m_box, targets.gt_boxes)
    giou_loss = per_item((1.0 - giou) * mf)

    # level set over rgb within the GT boxes
    sp_coords = outputs["sp_coords_dense"]  # [B, S, 3]
    gb = targets.gt_boxes
    within = (((sp_coords[:, None] >= gb[:, :, None, :3] - 0.005).all(-1)
               & (sp_coords[:, None] <= gb[:, :, None, 3:] + 0.005).all(-1)).float()
              * svf * mvalid)  # [B, I, S]
    sigm = sig * within
    feats = targets.sp_rgb  # [B, S, 3]
    wsum = torch.maximum(sigm.sum(-1, keepdim=True),
                         torch.tensor(1e-5, dtype=sigm.dtype, device=dev))
    avg = torch.einsum("bis,bsc->bic", sigm, feats) / wsum
    diff = feats[:, None] - avg[:, :, None]
    lvl = (diff * diff).sum(-1) * sigm
    npts = within.sum(-1).clamp(min=1.0)
    lvl_inst = lvl.sum(-1) / npts * mf
    has_pts = (within.sum(-1) > 0).float()
    lvl_loss = ((lvl_inst * has_pts).sum(1) / (num_gt_b + 1e-4) * batch_has).sum() / B

    # KL loss on the GP uncertainty, per superpoint. The labels' -100
    # sentinel rides through a superpoint mean, so test against -50.
    mu_p = gather_dense(outputs["mu_pred"], outputs["sp_dense_idx"])
    logvar_p = gather_dense(outputs["logvar_pred"], outputs["sp_dense_idx"])
    mu_l, var_l = targets.sp_mu, targets.sp_var
    eps = 1e-4
    has_lbl = (mu_l > -50.0) & (var_l > -50.0) & sp_valid
    mz = has_lbl & (var_l <= eps)
    mv = has_lbl & (var_l > eps)
    kl_z = (torch.exp(logvar_p) - 1.0) ** 2 + (mu_p - mu_l) ** 2
    kl_z = (kl_z * mz).sum() / (mz.float().sum() + 1e-4)
    safe_var = torch.where(mv, var_l, 1.0)
    kl_v = ((logvar_p - torch.log(safe_var))
            + ((mu_p - mu_l) ** 2 + safe_var ** 2) * torch.exp(-2.0 * logvar_p) - 0.5)
    kl_v = (kl_v * mv).sum() / (mv.float().sum() + 1e-4)
    zero = torch.zeros((), dtype=kl_z.dtype, device=dev)
    kl_loss = torch.where(mz.sum() > 0, kl_z, zero) + torch.where(mv.sum() > 0, kl_v, zero)

    return {
        "dice_loss": dice_loss,
        "bce_loss": bce_loss,
        "iou_loss": iou_loss,
        "cls_loss": cls_loss,
        "box_loss": box_loss,
        "giou_loss": giou_loss,
        "levelset_loss": lvl_loss,
        "kl_loss": kl_loss,
    }


def isbnet_loss(outputs, prepared, targets: Targets, cfg: CriterionConfig,
                assign=None) -> Dict[str, torch.Tensor]:
    """The full criterion; returns a dict with ``loss``, every weighted term
    and the ``ovf_*`` counters the outputs carry (logged, not part of the
    loss). ``assign`` is passed on to ``instance_loss``. With
    ``semantic_only`` (backbone pre-training) the loss is the pointwise
    terms alone, and ``targets`` need only hold ``corners_offset_labels``
    (``PointwiseTargets``)."""
    losses = {}
    if cfg.semantic_only or cfg.trainall:
        pw = pointwise_loss(outputs, prepared.voxel_semantic, prepared.voxel_instance,
                            targets.corners_offset_labels, prepared.batch.coords_float,
                            prepared.batch.valid, cfg)
        losses.update(pw if cfg.semantic_only else {k: v * 0.25 for k, v in pw.items()})
    if not cfg.semantic_only:
        inst = instance_loss(outputs, targets, cfg, assign=assign)
        for k, w in cfg.loss_weight:
            losses[k] = inst[k] * w
    losses["loss"] = sum(losses.values())
    dev = losses["loss"].device
    for k in ("ovf_fg_voxels", "ovf_spp_slots", "ovf_plan_voxels", "ovf_window_escapees"):
        if k in outputs:
            losses[k] = torch.as_tensor(outputs[k], dtype=torch.float32, device=dev)
    losses["ovf_inst_voxels"] = torch.as_tensor(targets.n_inst_overflow_voxels,
                                                dtype=torch.float32, device=dev)
    return losses
