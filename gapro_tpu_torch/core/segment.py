"""Segment reductions with static segment counts.

Counterpart of ``gapro_tpu/core/segment.py``. Convention: segment ids < 0 or
>= ``num_segments`` are dropped (routed to discard rows that are sliced off),
so every output has the static ``num_segments`` rows.
"""

from __future__ import annotations

import torch

# Dropped rows are spread over this many discard rows. On the card both
# ``index_put_(accumulate=True)`` and ``scatter_reduce_`` work through the
# rows of one index one after another, so a single discard row would
# serialise every padding row of a batch (tens of thousands at full size).
_DISCARD_ROWS = 1024


def _route_invalid(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Map out-of-range ids to the discard rows past ``num_segments``."""
    ok = (seg_ids >= 0) & (seg_ids < num_segments)
    spread = torch.arange(seg_ids.shape[0], device=seg_ids.device) % _DISCARD_ROWS
    return torch.where(ok, seg_ids.long(), num_segments + spread)


def segment_sum(data, seg_ids, num_segments: int):
    """Sum per segment. ``index_put_`` with ``accumulate`` sums each segment
    in a fixed order on the card too (``index_add_`` there sums by atomics,
    in an order that changes from run to run), so a scene gives the same
    answer on every call."""
    seg = _route_invalid(seg_ids, num_segments)
    out = data.new_zeros((num_segments + _DISCARD_ROWS,) + tuple(data.shape[1:]))
    out.index_put_((seg,), data, accumulate=True)
    return out[:num_segments]


def segment_count(seg_ids, num_segments: int, dtype=torch.float32):
    ones = torch.ones(seg_ids.shape[:1], dtype=dtype, device=seg_ids.device)
    return segment_sum(ones, seg_ids, num_segments)


def segment_mean(data, seg_ids, num_segments: int, eps: float = 1e-12):
    """Mean per segment; empty segments give 0. Accumulates in fp32."""
    dtype = data.dtype
    s = segment_sum(data.float(), seg_ids, num_segments)
    c = segment_count(seg_ids, num_segments)
    c = c.reshape(c.shape + (1,) * (s.ndim - 1))
    return (s / torch.clamp(c, min=eps)).to(dtype)


def segment_weighted_mean(data, seg_ids, weights, num_segments: int, eps: float = 1e-12):
    """Weighted mean per segment; empty or zero-weight segments give 0.
    Accumulates in fp32. With a voxel's member-point count as its weight,
    this is the mean over the points of each segment, every point carrying
    its voxel's value (SPFormer's point-resolution superpoint pooling)."""
    dtype = data.dtype
    w = weights.float()
    data32 = data.float()
    s = segment_sum(data32 * w.reshape(w.shape + (1,) * (data32.ndim - 1)), seg_ids,
                    num_segments)
    c = segment_sum(w, seg_ids, num_segments)
    c = c.reshape(c.shape + (1,) * (s.ndim - 1))
    return (s / torch.clamp(c, min=eps)).to(dtype)


def _segment_extreme(data, seg_ids, num_segments: int, reduce: str):
    seg = _route_invalid(seg_ids, num_segments)
    if data.dtype.is_floating_point:
        fill = float("inf") if reduce == "amin" else float("-inf")
    else:
        info = torch.iinfo(data.dtype)
        fill = info.max if reduce == "amin" else info.min
    out = torch.full((num_segments + _DISCARD_ROWS,) + tuple(data.shape[1:]), fill,
                     dtype=data.dtype, device=data.device)
    idx = seg.reshape(seg.shape + (1,) * (data.ndim - 1)).expand_as(data)
    out.scatter_reduce_(0, idx, data, reduce=reduce, include_self=True)
    return out[:num_segments]


def segment_min(data, seg_ids, num_segments: int):
    """Min per segment; empty segments hold the dtype's max (as
    ``jax.ops.segment_min``)."""
    return _segment_extreme(data, seg_ids, num_segments, "amin")


def segment_max(data, seg_ids, num_segments: int):
    """Max per segment; empty segments hold the dtype's min."""
    return _segment_extreme(data, seg_ids, num_segments, "amax")


def compact_unique(ids: torch.Tensor, num_out: int, valid=None):
    """Static-shape ``unique(return_inverse=True)``.

    Returns (unique values [num_out] padded with -1, inverse [N] int32 with
    -1 for invalid entries, count). Unique values are in sorted order; an
    inverse id may exceed ``num_out`` when the count does, as in the JAX
    package (segment ops then drop it).
    """
    n = ids.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=ids.device)
    inverse = torch.full((n,), -1, dtype=torch.int32, device=ids.device)
    uniq_all, inv = torch.unique(ids[valid].long(), sorted=True, return_inverse=True)
    inverse[valid] = inv.int()
    count = uniq_all.shape[0]
    uniq = torch.full((num_out,), -1, dtype=torch.int32, device=ids.device)
    keep = min(count, num_out)
    uniq[:keep] = uniq_all[:keep].int()
    return uniq, inverse, count
