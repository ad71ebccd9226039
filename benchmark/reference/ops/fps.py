# Frozen copy of gapro_tpu_torch/ops/fps.py, its CUDA kernels taken out (plain PyTorch only); it does not follow later changes
# to the port.
"""Furthest point sampling, masked, dense batch (``gapro_tpu/ops/fps.py``).

Semantics: start at the first valid point, keep each point's minimum
squared distance to the chosen set, take the argmax each step (first index
on ties). Invalid points are never chosen while a valid one remains; slots
past the number of valid points repeat the first index and are marked
invalid.

* ``fps_masked``: the plain PyTorch version of kernel K4.
"""

from __future__ import annotations

import torch



def _finish(idx, valid, n_sample):
    n_valid = valid.sum(1)
    sample_valid = torch.arange(n_sample, device=valid.device)[None, :] < n_valid[:, None]
    first = valid.int().argmax(1).int()
    return torch.where(sample_valid, idx, first[:, None]), sample_valid


def fps_masked(xyz, valid, n_sample: int):
    """Plain version of K4: [B, N, 3] + [B, N] bool -> (indices [B, n_sample]
    int32, sample_valid [B, n_sample]).

    The squared distance is written as three products and two adds in this
    order, each rounded on its own, so that the kernel can match it bit for
    bit.
    """
    b = xyz.shape[0]
    rows = torch.arange(b, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.where(valid, torch.tensor(1e10, device=xyz.device), -1.0)
    last = valid.int().argmax(1)
    out = torch.empty((b, n_sample), dtype=torch.int32, device=xyz.device)
    for i in range(n_sample):
        out[:, i] = last
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = dx * dx + dy * dy + dz * dz
        dist = torch.where(valid, torch.minimum(dist, d), -1.0)
        last = dist.argmax(1)
    return _finish(out, valid, n_sample)


def fps(xyz, valid, n_sample: int):
    """FPS as the model calls it: the plain version."""
    return fps_masked(xyz, valid, n_sample)
