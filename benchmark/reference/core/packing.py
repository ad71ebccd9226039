# Frozen copy of gapro_tpu_torch/core/packing.py; it does not follow later changes
# to the port.
"""Coordinate key packing and sorted-key lookup.

Counterpart of ``gapro_tpu/core/packing.py``. The JAX package runs with
32-bit ints and packs (batch, z, y, x) into a lexicographic (hi, lo) int32
pair; PyTorch has int64, so the port packs the same order into one key:
``((b * Z + z) * Y + y) * X + x``. Invalid rows get ``KEY_MAX``, which sorts
after every real key.
"""

from __future__ import annotations

import torch

KEY_MAX = torch.iinfo(torch.int64).max


def pack_coords(coords: torch.Tensor, extents, valid=None) -> torch.Tensor:
    """[N, 4] int coords (b, z, y, x) -> [N] int64 keys in lexicographic order."""
    Z, Y, X = (int(e) for e in extents)
    c = coords.long()
    key = ((c[:, 0] * Z + c[:, 1]) * Y + c[:, 2]) * X + c[:, 3]
    if valid is not None:
        key = torch.where(valid, key, KEY_MAX)
    return key


def sorted_lookup(sorted_keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Exact-match lookup: index of each query in ``sorted_keys``, or -1.
    Queries equal to ``KEY_MAX`` never match."""
    m = sorted_keys.shape[0]
    pos = torch.searchsorted(sorted_keys, queries)
    pos_c = pos.clamp(max=max(m - 1, 0))
    found = (pos < m) & (sorted_keys[pos_c] == queries) & (queries != KEY_MAX)
    return torch.where(found, pos_c, -1).int()
