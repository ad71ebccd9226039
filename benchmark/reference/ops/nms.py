# Frozen copy of gapro_tpu_torch/ops/nms.py; it does not follow later changes
# to the port.
"""Matrix NMS for instance proposals (``gapro_tpu/ops/nms.py``).

Masks stay at superpoint resolution with per-superpoint voxel counts as
weights, which equals the voxel-level computation because a mask is constant
within a superpoint. Sorts are stable, as ``jnp.argsort`` and
``lax.top_k`` are, so equal scores keep index order.
"""

from __future__ import annotations

import numpy as np
import torch


def weighted_mask_iou(masks, weights):
    """Pairwise IoU of [P, S] {0,1} masks under per-column weights [S]."""
    mw = masks * weights[None, :]
    inter = mw @ masks.T
    num = mw.sum(1)
    union = num[:, None] + num[None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def stable_topk(x, k: int):
    """Largest ``k`` of a 1-D tensor, descending, ties in index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def matrix_nms(masks, categories, scores, weights, topk: int, sigma: float = 2.0):
    """masks [P, S] float {0,1}, categories [P] (-1 invalid), scores [P]
    (invalid rows <= 0), weights [S] -> (indices [topk] into P, updated
    scores [topk], keep [topk])."""
    p = masks.shape[0]
    order = torch.sort(-scores, stable=True).indices
    m = masks[order]
    c = categories[order]
    s = scores[order]

    ious = weighted_mask_iou(m, weights)
    same_cls = (c[None, :] == c[:, None]) & (c[:, None] >= 0)
    triu = torch.ones((p, p), dtype=torch.float32, device=masks.device).triu(1)
    label_matrix = same_cls.float() * triu
    decay_iou = ious * label_matrix
    compensate = decay_iou.max(0).values[:, None]
    decay = torch.exp(-sigma * decay_iou ** 2) / torch.exp(-sigma * compensate ** 2)
    coeff = torch.where(label_matrix > 0, decay, float("inf")).min(0).values
    coeff = torch.where(torch.isfinite(coeff), coeff, 1.0)

    new_scores = torch.where(s > 0, s * coeff, float("-inf"))
    top_scores, top_idx = stable_topk(new_scores, topk)
    keep = torch.isfinite(top_scores)
    return order[top_idx], torch.where(keep, top_scores, 0.0), keep


def standard_nms_host(masks, categories, scores, weights, threshold=0.2):
    """Greedy class-aware mask NMS on the host (numpy). Returns the kept
    indices, the highest score first."""
    masks = np.asarray(masks, np.float32) * np.asarray(weights)[None, :]
    bin_masks = np.asarray(masks > 0, np.float32)
    inter = masks @ bin_masks.T
    num = masks.sum(1)
    ious = inter / np.maximum(num[:, None] + num[None, :] - inter, 1e-6)
    categories = np.asarray(categories)
    ixs = np.argsort(-np.asarray(scores))
    pick = []
    while len(ixs) > 0:
        i = ixs[0]
        pick.append(int(i))
        rest = ixs[1:]
        ixs = rest[~((ious[i, rest] > threshold) & (categories[rest] == categories[i]))]
    return np.asarray(pick, np.int64)
