"""Sparse convolutions (``gapro_tpu/sparse/conv.py``).

* ``subm_conv``: the 3x3x3 submanifold conv as one zero-sentinel gather
  plus one matmul. It is the plain PyTorch version of kernel K1,
  ``csrc/subm_conv.cu``.
* ``subm_conv_cuda``: K1's wrapper. For a CPU tensor it takes ``subm_conv``;
  for a CUDA tensor it launches the kernel or raises. It counts its launches
  in ``subm_conv_cuda.launches``.
* ``down_conv`` / ``inverse_conv``: the stride-2 kernel-2 pair sharing one
  rulebook. The JAX package computes them outside any Pallas kernel, and so
  does the port.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build


def subm_conv(feats, nbr_idx, weights, valid):
    """Plain version of K1.

    feats [V, Cin], nbr_idx [V, 27] int (-1 missing), weights [27, Cin,
    Cout], valid [V] bool -> [V, Cout]; invalid rows are 0.
    """
    v, cin = feats.shape
    k, _, cout = weights.shape
    table = torch.cat([feats, feats.new_zeros((1, cin))], 0)  # row v = zeros
    idx = torch.where(nbr_idx >= 0, nbr_idx, v).long()
    g = table[idx.reshape(-1)].reshape(v, k * cin)
    out = g @ weights.reshape(k * cin, cout)
    return torch.where(valid[:, None], out, 0.0)


def _check_cuda_args(feats, nbr_idx, weights, valid):
    v, cin = feats.shape
    if weights.dim() != 3 or weights.shape[:2] != (27, cin):
        raise ValueError(f"weights must be [27, {cin}, Cout], got {tuple(weights.shape)}")
    if nbr_idx.shape != (v, 27) or valid.shape != (v,):
        raise ValueError(f"nbr_idx must be [{v}, 27] and valid [{v}], got "
                         f"{tuple(nbr_idx.shape)} and {tuple(valid.shape)}")
    for name, t, dt in (("feats", feats, torch.float32), ("nbr_idx", nbr_idx, torch.int32),
                        ("weights", weights, torch.float32), ("valid", valid, torch.bool)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def subm_conv_cuda(feats, nbr_idx, weights, valid):
    """K1: ``subm_conv`` as a hand-written CUDA kernel (fp32)."""
    if feats.device.type == "cpu":
        return subm_conv(feats, nbr_idx, weights, valid)
    _check_cuda_args(feats, nbr_idx, weights, valid)
    v, cin = feats.shape
    cout = weights.shape[2]
    lib = cuda_build.load("subm_conv")
    lib.gapro_subm_conv_splits.argtypes = [ctypes.c_int] * 3
    lib.gapro_subm_conv_splits.restype = ctypes.c_int
    fn = lib.gapro_subm_conv_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(feats.device):
        splits = lib.gapro_subm_conv_splits(v, cin, cout)
        if splits < 1:
            raise RuntimeError("subm_conv_cuda: the device query failed")
        out = torch.empty((v, cout), dtype=torch.float32, device=feats.device)
        # per-split partial sums of the deep levels (see csrc/subm_conv.cu)
        partial = (torch.empty((splits, v, cout), dtype=torch.float32, device=feats.device)
                   if splits > 1 else None)
        err = fn(feats.data_ptr(), nbr_idx.data_ptr(), weights.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), 0 if partial is None else partial.data_ptr(), v, cin, cout,
                 splits, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "subm_conv_cuda")
    subm_conv_cuda.launches += 1
    return out


subm_conv_cuda.launches = 0


def subm_conv_auto(feats, level_plan, weights):
    """The subm conv of one U-Net level: K1 on every level (the TPU's
    8192-capacity floor existed only for its window tables)."""
    return subm_conv_cuda(feats.contiguous(), level_plan.subm_nbr, weights.contiguous(),
                          level_plan.grid.valid)


def down_conv(feats, child_idx, weights, out_valid=None):
    """Stride-2 kernel-2 conv: out[p] = sum_kk feats[child_idx[p, kk]] @ W[kk]."""
    v, cin = feats.shape
    k, _, cout = weights.shape
    table = torch.cat([feats, feats.new_zeros((1, cin))], 0)
    idx = torch.where(child_idx >= 0, child_idx, v).long()
    vc = child_idx.shape[0]
    out = table[idx.reshape(-1)].reshape(vc, k * cin) @ weights.reshape(k * cin, cout)
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0.0)
    return out


def inverse_conv(coarse_feats, parent, offset_id, weights, valid):
    """Transpose of ``down_conv`` on the shared rulebook:
    fine[i] = coarse[parent(i)] @ W[offset(i)]."""
    gathered = coarse_feats[parent.clamp(min=0).long()]
    gathered = torch.where((parent >= 0)[:, None], gathered, 0.0)
    out = None
    for kk in range(8):
        sel = (offset_id == kk)[:, None]
        yk = torch.where(sel, gathered, 0.0) @ weights[kk]
        out = yk if out is None else out + yk
    return torch.where(valid[:, None], out, 0.0)
