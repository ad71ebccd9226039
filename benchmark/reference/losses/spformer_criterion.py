# Frozen copy of gapro_tpu_torch/losses/spformer_criterion.py; it does not follow later changes
# to the port.
"""SPFormer's training criterion with the GaPro losses
(``gapro_tpu/losses/spformer_criterion.py``).

For every decoder head (the final one and the auxiliary ones): Hungarian
matching with cost 0.5 cls + 1 bce + 1 dice, then

* class CE over all queries, the no-object class weighted 0.1;
* BCE over the matched instances' superpoints, a plain mean per batch item
  (the reference's GaPro probability weighting cancels out of it);
* dice, averaged over instances and summed over the batch (the final head)
  or averaged over it (the auxiliary heads), as the reference does;
* the score head's MSE against the mask IoU on matches with IoU > 0.5;
* the level-set loss over RGB inside the GT boxes, for boxes holding at
  least 100 superpoints;

and on the final head the KL loss between the predicted (mu, logvar) and
the GP label (mu, var), times 0.1. Targets come from
``criterion.build_targets``.

The matching solves every head's cost matrices on the host with scipy, as
the port's ISBNet matcher does, after one device-to-host copy of all of
them (``spformer_match_layers``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import torch

from ..core.batching import gather_dense
from .criterion import Targets, _bce_with_logits
from .matcher import _INVALID_COST, _lsap_host, bce_cost, dice_cost


@dataclass(frozen=True)
class SPFormerCriterionConfig:
    num_class: int = 18
    non_object_weight: float = 0.1
    loss_weight: tuple = (0.5, 1.0, 1.0, 0.5, 0.2)  # cls, bce, dice, score, levelset
    cost_weight: tuple = (0.5, 1.0, 1.0)  # cls, bce, dice
    kl_weight: float = 0.1
    inst_cap: int = 128


def spformer_match_costs(cls_logits, mask_logits, gt_cls, gt_masks, gt_valid, sp_valid,
                         cfg: SPFormerCriterionConfig):
    """[..., B, Q, C+1] class logits and [..., B, Q, S] mask logits against
    the dense GT -> [..., B, Q, I] costs, non-finite ones and invalid GT
    columns at 1e5. Leading axes (the decoder heads) broadcast over the GT."""
    wc, wb, wd = cfg.cost_weight
    lead = cls_logits.shape[:-3]
    b, q, s = mask_logits.shape[-3:]
    n = math.prod(lead)
    flat = lambda x: x[None].expand((n,) + tuple(x.shape)).reshape((n * b,) + tuple(x.shape[1:]))
    svf = flat(sp_valid.float())
    ml = mask_logits.reshape(n * b, q, s)
    gm = flat(gt_masks)
    d = dice_cost(ml, gm, svf)
    bce = bce_cost(ml, gm, svf)
    sm = torch.softmax(cls_logits.reshape(n * b, q, -1), -1)
    idx = flat(gt_cls).clamp(min=0).long()[:, None, :].expand(-1, q, -1)
    cost = wc * -torch.gather(sm, 2, idx) + wb * bce + wd * d
    cost = torch.where(torch.isfinite(cost), cost, _INVALID_COST)
    cost = torch.where(flat(gt_valid)[:, None, :], cost, _INVALID_COST)
    return cost.reshape(lead + (b, q, -1))


@torch.no_grad()
def spformer_match(cls_logits, mask_logits, gt_cls, gt_masks, gt_valid, sp_valid,
                   cfg: SPFormerCriterionConfig):
    """Assignment [..., B, I]: the matched query of each GT (-1 for invalid
    GTs), for one head ([B, Q, ...]) or a stack of heads ([L, B, Q, ...]).
    The costs of all heads cross to the host in one copy."""
    costs = spformer_match_costs(cls_logits, mask_logits, gt_cls, gt_masks, gt_valid, sp_valid,
                                 cfg)
    host = costs.cpu().numpy()
    assign = _lsap_host(host.reshape((-1,) + host.shape[-2:])).reshape(host.shape[:-2] + (-1,))
    return torch.where(gt_valid, torch.as_tensor(assign, device=costs.device), -1)


def spformer_match_layers(outputs, targets: Targets, cfg: SPFormerCriterionConfig):
    """Every decoder head's assignment, [L+1, B, I]."""
    return spformer_match(outputs["labels"], outputs["masks"], targets.gt_cls,
                          targets.gt_sp_masks, targets.gt_valid, outputs["sp_dense_valid"], cfg)


def _layer_loss(cls_logits, scores, mask_logits, targets: Targets, sp_valid, sp_coords,
                cfg: SPFormerCriterionConfig, final: bool, assign):
    """One decoder head's losses under its assignment [B, I] -> (weighted
    total, terms)."""
    B, Q, _ = cls_logits.shape
    C = cfg.num_class
    dev = cls_logits.device
    matched = targets.gt_valid & (assign >= 0)
    a = assign.clamp(min=0).long()
    mf = matched.float()

    m_logits = torch.gather(mask_logits, 1, a[..., None].expand(-1, -1, mask_logits.shape[2]))
    m_scores = torch.gather(scores, 1, a)

    svf = sp_valid[:, None, :].float()
    mvalid = mf[..., None]
    gt_m = targets.gt_sp_masks
    num_gt_b = mf.sum(1)
    batch_has = (num_gt_b > 0).float()

    # class CE with the no-object weight over all queries
    tgt_cls = torch.full((B, Q), C, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)[:, None].expand_as(a)
    tgt_cls[rows[matched], a[matched]] = targets.gt_cls[matched].long().clamp(0, C - 1)
    ce = -torch.gather(torch.log_softmax(cls_logits, -1), 2, tgt_cls[..., None])[..., 0]
    w = torch.where(tgt_cls == C, cfg.non_object_weight, 1.0)
    cls_loss = (ce * w).sum() / w.sum().clamp(min=1e-6)

    # score MSE on matches with IoU > 0.5
    sig = torch.sigmoid(m_logits)
    pred_bin = (sig >= 0.5).float() * svf
    t = (gt_m > 0.5).float() * svf
    inter = (pred_bin * t).sum(-1)
    union = pred_bin.sum(-1) + t.sum(-1) - inter
    gt_iou = (inter / (union + 1e-6)).detach()
    score_sel = matched & (gt_iou > 0.5)
    n_sel = score_sel.float().sum(1)
    mse = (m_scores - gt_iou) ** 2 * score_sel
    score_loss = (mse.sum(1) / n_sel.clamp(min=1e-6) * (n_sel > 0)).sum() / B

    # BCE: the reference's GaPro weighting cancels out (it passes the legacy
    # reduce= keyword, so the BCE is already a mean), leaving a plain mean
    bce = _bce_with_logits(m_logits, gt_m) * svf * mvalid
    cnt = (num_gt_b * sp_valid.float().sum(-1)).clamp(min=1.0)
    bce_loss = (bce.sum((1, 2)) / cnt * batch_has).sum() / B

    # dice: mean over instances, summed over the batch (the aux heads divide
    # by the batch size, the final head does not, as the reference does)
    p = sig * svf * mvalid
    dice = (1.0 - (2.0 * (p * t).sum(-1) + 1.0) / (p.sum(-1) + t.sum(-1) + 1.0)) * mf
    dice_loss = (dice.sum(1) / num_gt_b.clamp(min=1e-6) * batch_has).sum()
    if not final:
        dice_loss = dice_loss / B

    # level set over rgb within the GT boxes holding >= 100 superpoints
    gb = targets.gt_boxes
    within = (((sp_coords[:, None] >= gb[:, :, None, :3] - 0.005).all(-1)
               & (sp_coords[:, None] <= gb[:, :, None, 3:] + 0.005).all(-1)).float()
              * svf * mvalid)  # [B, I, S]
    enough = (within.sum(-1) >= 100.0).float()
    within = within * enough[..., None]
    sigm = sig * within
    feats = targets.sp_rgb
    wsum = torch.maximum(sigm.sum(-1, keepdim=True),
                         torch.tensor(1e-5, dtype=sigm.dtype, device=dev))
    avg = torch.einsum("bis,bsc->bic", sigm, feats) / wsum
    diff = feats[:, None] - avg[:, :, None]
    lvl = (diff * diff).sum(-1) * sigm
    lvl_inst = lvl.sum(-1) / within.sum(-1).clamp(min=1.0) * mf * enough
    lvl_loss = (lvl_inst.sum(1) / num_gt_b.clamp(min=1e-4) * batch_has).sum() / B

    wcls, wbce, wdice, wscore, wlvl = cfg.loss_weight
    total = (wcls * cls_loss + wbce * bce_loss + wdice * dice_loss + wscore * score_loss
             + wlvl * lvl_loss)
    return total, dict(cls_loss=cls_loss, bce_loss=bce_loss, dice_loss=dice_loss,
                       score_loss=score_loss, levelset_loss=lvl_loss)


def kl_loss_spp(mu_pred, logvar_pred, sp_dense_idx, sp_valid, sp_mu, sp_var, weight=0.1):
    """The GP-uncertainty KL loss per superpoint (final head only). The
    labels' -100 sentinel rides through a superpoint mean, so it is tested
    against -50."""
    mu_p = gather_dense(mu_pred, sp_dense_idx)
    logvar_p = gather_dense(logvar_pred, sp_dense_idx)
    eps = 1e-4
    has = (sp_mu > -50.0) & (sp_var > -50.0) & sp_valid
    mz = has & (sp_var <= eps)
    mv = has & (sp_var > eps)
    kl_z = (torch.exp(logvar_p) - 1.0) ** 2 + (mu_p - sp_mu) ** 2
    kl_z = (kl_z * mz).sum() / (mz.float().sum() + 1e-4)
    safe_var = torch.where(mv, sp_var, 1.0)
    kl_v = ((logvar_p - torch.log(safe_var))
            + ((mu_p - sp_mu) ** 2 + safe_var ** 2) * torch.exp(-2.0 * logvar_p) - 0.5)
    kl_v = (kl_v * mv).sum() / (mv.float().sum() + 1e-4)
    zero = torch.zeros((), dtype=kl_z.dtype, device=kl_z.device)
    return weight * (torch.where(mz.sum() > 0, kl_z, zero) + torch.where(mv.sum() > 0, kl_v, zero))


def spformer_loss(outputs: Dict, targets: Targets, cfg: SPFormerCriterionConfig,
                  assign=None) -> Dict[str, torch.Tensor]:
    """The criterion over the final head and the auxiliary ones; returns
    ``loss``, the final head's terms, ``kl_loss`` and the ``ovf_*``
    counters (logged, not part of the loss). ``assign`` [L+1, B, I] is every
    head's assignment; the matcher runs when it is None."""
    labels, scores, masks = outputs["labels"], outputs["scores"], outputs["masks"]
    sp_valid = outputs["sp_dense_valid"]
    n_layers = labels.shape[0]
    if assign is None:
        assign = spformer_match_layers(outputs, targets, cfg)
    total = 0.0
    out: Dict[str, torch.Tensor] = {}
    for li in range(n_layers):
        final = li == n_layers - 1
        loss, terms = _layer_loss(labels[li], scores[li], masks[li], targets, sp_valid,
                                  outputs["sp_coords_dense"], cfg, final=final,
                                  assign=assign[li])
        total = total + loss
        if final:
            out.update(terms)
    out["kl_loss"] = kl_loss_spp(outputs["mu_pred"], outputs["logvar_pred"],
                                 outputs["sp_dense_idx"], sp_valid, targets.sp_mu, targets.sp_var,
                                 cfg.kl_weight)
    out["loss"] = total + out["kl_loss"]
    dev = out["loss"].device
    for k in ("ovf_spp_slots", "ovf_plan_voxels", "ovf_window_escapees"):
        if k in outputs:
            out[k] = torch.as_tensor(outputs[k], dtype=torch.float32, device=dev)
    out["ovf_inst_voxels"] = targets.n_inst_overflow_voxels.float()
    return out
