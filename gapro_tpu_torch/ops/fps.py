"""Furthest point sampling, masked, dense batch (``gapro_tpu/ops/fps.py``).

Semantics: start at the first valid point, keep each point's minimum
squared distance to the chosen set, take the argmax each step (first index
on ties). Invalid points are never chosen while a valid one remains; slots
past the number of valid points repeat the first index and are marked
invalid.

* ``fps_masked``: the plain PyTorch version of kernel K4.
* ``fps_cuda``: K4's wrapper (``csrc/fps.cu``). For a CPU tensor it takes
  ``fps_masked``; for a CUDA tensor it launches the kernel or raises. It
  counts its launches in ``fps_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build


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


def fps_cuda(xyz, valid, n_sample: int):
    """K4: ``fps_masked`` as one cooperative CUDA launch."""
    if xyz.device.type == "cpu":
        return fps_masked(xyz, valid, n_sample)
    b, n, three = xyz.shape
    if three != 3 or valid.shape != (b, n):
        raise ValueError(f"xyz must be [B, N, 3] and valid [B, N], got "
                         f"{tuple(xyz.shape)} and {tuple(valid.shape)}")
    if xyz.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"xyz must be float32 and valid bool, got {xyz.dtype}, {valid.dtype}")
    if valid.device != xyz.device:
        raise ValueError(f"valid is on {valid.device}, xyz on {xyz.device}")
    xyz = xyz.contiguous()
    valid = valid.contiguous()
    first = valid.int().argmax(1).int()
    out = torch.empty((b, n_sample), dtype=torch.int32, device=xyz.device)
    slots = torch.zeros(3, dtype=torch.int64, device=xyz.device)
    lib = cuda_build.load("fps")
    fn = lib.gapro_fps
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(xyz.device):
        err = fn(xyz.data_ptr(), valid.data_ptr(), first.data_ptr(), b, n, n_sample,
                 out.data_ptr(), slots.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "fps_cuda")
    fps_cuda.launches += 1
    return _finish(out, valid, n_sample)


fps_cuda.launches = 0


def fps(xyz, valid, n_sample: int):
    """Dispatching FPS used by the model: K4 on the card, the plain version
    for CPU tensors."""
    return fps_cuda(xyz, valid, n_sample)
