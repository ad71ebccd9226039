# Frozen copy of gapro_tpu_torch/utils/rle.py; it does not follow later changes
# to the port.
"""Run-length encoding of binary masks (``gapro_tpu/utils/rle.py``).

The reference exporter's wire format: ``{"length": N, "counts": [start,
length, ...]}`` with 1-based run starts. ``rle_encode_rows`` encodes a batch
of masks where they lie: the runs are found on the device and only they
cross to the host, not the [K, N] masks. ``rle_encode`` is the same for
one host mask (``rle_encode_batch`` for the rows of a host array), and
``rle_decode`` the numpy inverse, for evaluation and export.
"""

from __future__ import annotations

import numpy as np
import torch


def rle_encode_rows(masks: torch.Tensor) -> list:
    """[K, N] bool tensor -> K records ``{"length", "counts"}``, each equal
    to the JAX package's ``rle_encode`` of its row (counts as int32, which
    halves what crosses to the host)."""
    k, n = masks.shape
    if k == 0:
        return []
    padded = torch.nn.functional.pad(masks.to(torch.int8), (1, 1))
    rows, cols = torch.nonzero(padded[:, 1:] != padded[:, :-1], as_tuple=True)
    # Boundaries come in (start, end) pairs and every row holds whole pairs,
    # so odd positions of the flat row-major list are ends: make them lengths.
    counts = (cols + 1).int()
    counts[1::2] -= counts[0::2]
    ends = np.cumsum(torch.bincount(rows, minlength=k).cpu().numpy())
    return [dict(length=int(n), counts=c) for c in np.split(counts.cpu().numpy(), ends[:-1])]


def rle_encode(mask) -> dict:
    """[N] bool numpy mask -> ``{"length", "counts"}`` (counts int64), as
    the JAX package's ``rle_encode``."""
    mask = np.asarray(mask).astype(bool)
    padded = np.concatenate([[False], mask, [False]])
    runs = np.flatnonzero(padded[1:] != padded[:-1]) + 1
    runs[1::2] -= runs[::2]
    return dict(length=int(mask.shape[0]), counts=runs.astype(np.int64))


def rle_encode_batch(masks) -> list:
    """``rle_encode`` of each row of a [K, N] host mask array."""
    return [rle_encode(m) for m in np.asarray(masks)]


def rle_decode(rle: dict) -> np.ndarray:
    """A record ``{"length", "counts"}`` (counts as an array or a string of
    integers) -> the [N] bool mask."""
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = np.array([int(x) for x in counts.split()], np.int64)
    counts = np.asarray(counts, np.int64)
    # +1 where a run starts, -1 where it ends (runs are disjoint and apart)
    edges = np.zeros(rle["length"] + 1, np.int32)
    edges[counts[::2] - 1] = 1
    edges[counts[::2] - 1 + counts[1::2]] -= 1
    return np.cumsum(edges[:-1]) > 0
