"""Hungarian matching between queries and GT instances
(``gapro_tpu/losses/matcher.py``).

Cost = 0.5 cls + 1 dice + 1 bce + 0.2 conf + 0.2 giou over dense padded
[B, Q, I] tensors on the device, NaN/Inf -> 1e5, invalid GT columns and
invalid query rows forced to 1e5. The assignment problem is solved on the
host by scipy's ``linear_sum_assignment``, which is ``_lsap_host``, the JAX
package's own solver off the TPU. Its device auction (``lsap_auction``)
exists only because the TPU's runtime rejects host callbacks, and is not
ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.common import jmax0
from ..utils import profiling

_INVALID_COST = 1e5


def _lsap_host(cost):
    """cost [B, Q, I] numpy -> assignment [B, I] (query index per GT, -1)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost)
    b, _, i = cost.shape
    out = np.full((b, i), -1, np.int32)
    for bi in range(b):
        rows, cols = linear_sum_assignment(cost[bi])
        out[bi, cols] = rows.astype(np.int32)
    return out


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def dice_cost(mask_logits, gt_masks, sp_valid):
    """[B, Q, S] logits vs [B, I, S] masks -> [B, Q, I]; sp_valid [B, S]
    float excludes superpoints."""
    p = torch.sigmoid(mask_logits) * sp_valid[:, None, :]
    t = gt_masks * sp_valid[:, None, :]
    num = 2.0 * torch.einsum("bqs,bis->bqi", p, t)
    den = p.sum(-1)[:, :, None] + t.sum(-1)[:, None, :]
    return 1.0 - (num + 1.0) / (den + 1.0)


def bce_cost(mask_logits, gt_masks, sp_valid):
    """Per-element sigmoid BCE averaged over the valid superpoints."""
    ns = sp_valid.sum(-1).clamp(min=1.0)[:, None, None]
    pos = softplus(-mask_logits) * sp_valid[:, None, :]  # -log sigmoid(x)
    neg = softplus(mask_logits) * sp_valid[:, None, :]  # -log(1 - sigmoid(x))
    t = gt_masks * sp_valid[:, None, :]
    loss = (torch.einsum("bqs,bis->bqi", pos, t)
            + torch.einsum("bqs,bis->bqi", neg, (1.0 - gt_masks) * sp_valid[:, None, :]))
    return loss / ns


def box_volume(lo, hi):
    """Volume of the boxes [lo, hi] ([..., 3] corners), 0 where they are
    empty; ``jnp.clip``'s gradient at a zero side."""
    d = jmax0(hi - lo)
    return d[..., 0] * d[..., 1] * d[..., 2]


def giou_pairwise(boxes1, boxes2):
    """[..., Q, 6] x [..., I, 6] -> iou, giou [..., Q, I]."""
    b1 = boxes1[..., :, None, :]
    b2 = boxes2[..., None, :, :]
    inter = box_volume(torch.maximum(b1[..., :3], b2[..., :3]),
                       torch.minimum(b1[..., 3:], b2[..., 3:]))
    union = box_volume(b1[..., :3], b1[..., 3:]) + box_volume(b2[..., :3], b2[..., 3:]) - inter
    iou = inter / (union + 1e-6)
    bound = box_volume(torch.minimum(b1[..., :3], b2[..., :3]),
                       torch.maximum(b1[..., 3:], b2[..., 3:]))
    return iou, iou - (bound - union) / (bound + 1e-6)


def match_costs(cls_logits, mask_logits, conf_logits, box_preds, gt_cls, gt_masks, gt_boxes,
                gt_valid, sp_valid, query_valid):
    """The [B, Q, I] cost matrices ``hungarian_match`` solves."""
    svf = sp_valid.float()
    d = dice_cost(mask_logits, gt_masks, svf)
    bce = bce_cost(mask_logits, gt_masks, svf)
    sm = torch.softmax(cls_logits, -1)  # [B, Q, C+1]
    idx = gt_cls.clamp(min=0).long()[:, None, :].expand(-1, sm.shape[1], -1)
    cls_c = -torch.gather(sm, 2, idx)
    conf_c = -conf_logits[:, :, None]
    _, giou = giou_pairwise(box_preds, gt_boxes)
    cost = 0.5 * cls_c + d + bce + 0.2 * conf_c + 0.2 * (-giou)
    cost = torch.where(torch.isfinite(cost), cost, _INVALID_COST)
    cost = torch.where(gt_valid[:, None, :], cost, _INVALID_COST)
    return torch.where(query_valid[:, :, None], cost, _INVALID_COST)


@torch.no_grad()
def hungarian_match(cls_logits, mask_logits, conf_logits, box_preds, gt_cls, gt_masks,
                    gt_boxes, gt_valid, sp_valid, query_valid):
    """Assignment [B, I]: the matched query of each GT (-1 for invalid GTs),
    on the device of the inputs. The costs cross to the host once."""
    costs = match_costs(cls_logits, mask_logits, conf_logits, box_preds, gt_cls, gt_masks,
                        gt_boxes, gt_valid, sp_valid, query_valid)
    host = profiling.to_host(costs, "matcher.costs").numpy()
    assign = torch.as_tensor(_lsap_host(host), device=costs.device)
    return torch.where(gt_valid, assign, -1)
