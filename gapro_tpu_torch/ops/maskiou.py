"""Proposal-vs-GT mask IoU and mask labels (``gapro_tpu/ops/maskiou.py``).

Replaces the CUDA kernels ``get_mask_iou_on_cluster`` / ``get_mask_label``
(ISBNet/isbnet/ops/src/cal_iou_and_masklabel/cal_iou_and_masklabel.cu;
wrappers ops/functions.py:7-139) with one-hot products, as the JAX package
does (the reference's own numpy trick, gapro/eval_ps_labels.py:35-42).
The products sum 0/1 entries, exact in fp32 under 2^24 points.
"""

from __future__ import annotations

import torch


def mask_iou_on_cluster(proposal_masks, instance_labels, num_instances: int):
    """IoU of binary proposals [P, N] with the GT instance ids [N] (-100 or
    -1 for none) -> [P, num_instances]."""
    onehot = (instance_labels[:, None] == torch.arange(
        num_instances, device=instance_labels.device)[None, :]).float()  # [N, I]
    masks = proposal_masks.float()
    inter = masks @ onehot
    union = masks.sum(1)[:, None] + onehot.sum(0)[None, :] - inter
    return inter / torch.clamp(union, min=1e-6)


def mask_label(proposal_masks, instance_labels, iou_thresh, num_instances: int):
    """Each proposal's soft mask label (get_mask_label's semantics): the
    points of its best-IoU GT instance are positives when that IoU passes
    ``iou_thresh``. Returns (labels [P, N] float, ious [P, I])."""
    ious = mask_iou_on_cluster(proposal_masks, instance_labels, num_instances)
    best = ious.argmax(1)
    best_iou = ious.gather(1, best[:, None])
    pos = (instance_labels[None, :] == best[:, None]) & (best_iou > iou_thresh)
    return pos.float(), ious
