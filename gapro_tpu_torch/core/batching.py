"""Flat <-> dense batch layout conversion (``gapro_tpu/core/batching.py``).

Voxel-level work stays batch-flat; per-scene work (FPS, ball query, dynamic
conv) runs on dense padded [B, n_max, ...] views with validity masks.
"""

from __future__ import annotations

import torch


def flat_to_dense_index(batch_idx, valid, batch_size: int, n_max: int):
    """Positions of flat rows inside dense [B, n_max] slots.

    Returns pos [N] (rank within the row's batch item, -1 for invalid or
    overflow), dense_idx [B, n_max] (flat index per slot, -1 empty) and
    dense_valid [B, n_max].
    """
    n = batch_idx.shape[0]
    dev = batch_idx.device
    b = torch.where(valid, batch_idx.long(), batch_size)
    # one 1-D scan per batch item: a scan down the columns of a [N, B+1]
    # one-hot runs far slower on the card
    pos = torch.full((n,), -1, dtype=torch.long, device=dev)
    for i in range(batch_size):
        member = b == i
        pos = torch.where(member, torch.cumsum(member, 0) - 1, pos)
    pos = torch.where(pos < n_max, pos, -1)

    ok = pos >= 0
    dense_idx = torch.full((batch_size, n_max), -1, dtype=torch.int32, device=dev)
    flat_ids = torch.arange(n, dtype=torch.int32, device=dev)
    dense_idx[batch_idx.long()[ok], pos[ok]] = flat_ids[ok]
    return pos.int(), dense_idx, dense_idx >= 0


def gather_dense(values, dense_idx, fill=0.0):
    """values [N, ...] + dense_idx [B, M] -> [B, M, ...] (``fill`` for empty).

    Empty slots read rows spread over ``values`` rather than row 0, and are
    then masked: autograd's backward adds each slot's (zero) gradient into
    the row it read, and on the card the slots of one row are added one
    after another."""
    spread = torch.arange(dense_idx.numel(), device=dense_idx.device).reshape(
        dense_idx.shape) % values.shape[0]
    out = values[torch.where(dense_idx >= 0, dense_idx.long(), spread)]
    mask = (dense_idx >= 0).reshape(dense_idx.shape + (1,) * (out.ndim - dense_idx.ndim))
    return torch.where(mask, out, torch.as_tensor(fill, dtype=out.dtype, device=out.device))
