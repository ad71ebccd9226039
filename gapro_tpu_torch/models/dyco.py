"""Dynamic-conv mask head (``gapro_tpu/models/dyco.py``).

Each query applies its own 3-layer MLP, whose weights the controller
predicts, to every superpoint: ``relu(W0 [q_loc - sp_coord; |q_dim -
sp_dim|; feat] + b0)`` -> ``relu(W1 . + b1)`` -> ``W2 .``, with -1e4 where
the superpoint is invalid.

* ``dyco_mlp_plain``: the batched-einsum form (``dyco_mlp_xla``), the plain
  PyTorch version of kernel K5.
* ``dyco_cuda``: K5's wrapper (``csrc/dyco.cu``). For a CPU tensor it takes
  ``dyco_mlp_plain``; for a CUDA tensor it launches the kernel or raises. It
  counts its launches in ``dyco_cuda.launches``.
* ``DycoFn``: the forward through ``dyco_cuda``, the backward by recomputing
  ``dyco_mlp_plain`` under autograd, as the JAX package's ``custom_vjp``
  does (``_dyco_bwd``). ``dyco_mlp``, which the model calls, is
  ``DycoFn.apply``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from .common import jabs

_NEG = -1e4  # invalid-superpoint logit fill
_WIDTHS = (8, 16, 32)  # mask widths M the kernel is built for


def dyco_mlp_plain(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid):
    """w0 [B,Q,m+6,m] (rows 0-5 geometry, 6: feats), w1 [B,Q,m,h],
    w2 [B,Q,h,1], b0 [B,Q,m], b1 [B,Q,h]; q_locs/q_dims [B,Q,3];
    sp_feats [B,S,m]; sp_coords/sp_dims [B,S,3]; sp_valid [B,S]
    -> mask logits [B,Q,S]."""
    rel_coords = q_locs[:, :, None, :] - sp_coords[:, None, :, :]
    rel_dims = jabs(q_dims[:, :, None, :] - sp_dims[:, None, :, :])
    rel_geo = torch.cat([rel_coords, rel_dims], -1)  # [B,Q,S,6]
    x = torch.relu(torch.einsum("bqsc,bqcd->bqsd", rel_geo, w0[:, :, :6, :])
                   + torch.einsum("bsc,bqcd->bqsd", sp_feats, w0[:, :, 6:, :])
                   + b0[:, :, None, :])
    x = torch.relu(torch.einsum("bqsc,bqcd->bqsd", x, w1) + b1[:, :, None, :])
    x = torch.einsum("bqsc,bqcd->bqsd", x, w2)[..., 0]  # no bias on the last layer
    return torch.where(sp_valid[:, None, :], x, _NEG)


def _per_query(t, name: str, inner: tuple):
    """``t`` [B, Q, *inner] fp32 whose trailing axes are contiguous (a view
    of the controller's output is), copied only where they are not."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape[2:]) != inner:
        raise ValueError(f"{name} must be [B, Q, {', '.join(map(str, inner))}], got "
                         f"{tuple(t.shape)}")
    want = 1
    for size, stride in zip(reversed(t.shape[2:]), reversed(t.stride()[2:])):
        if size != 1 and stride != want:
            return t.contiguous()
        want *= size
    return t


def dyco_cuda(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid):
    """K5: ``dyco_mlp_plain`` as one CUDA launch."""
    if w0.device.type == "cpu":
        return dyco_mlp_plain(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                              sp_valid)
    b, q, m6, m = w0.shape
    s = sp_feats.shape[1]
    h = m // 2
    if m not in _WIDTHS or m6 != m + 6:
        raise ValueError(f"w0 must be [B, Q, M + 6, M] with M in {_WIDTHS}, got {tuple(w0.shape)}")
    w0 = _per_query(w0, "w0", (m + 6, m))
    w1 = _per_query(w1, "w1", (m, h))
    w2 = _per_query(w2, "w2", (h, 1))
    b0 = _per_query(b0, "b0", (m,))
    b1 = _per_query(b1, "b1", (h,))
    small = {"q_locs": (q_locs, (b, q, 3)), "q_dims": (q_dims, (b, q, 3)),
             "sp_feats": (sp_feats, (b, s, m)), "sp_coords": (sp_coords, (b, s, 3)),
             "sp_dims": (sp_dims, (b, s, 3))}
    for name, (t, shape) in small.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {list(shape)} float32, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if tuple(sp_valid.shape) != (b, s) or sp_valid.dtype != torch.bool:
        raise ValueError(f"sp_valid must be [{b}, {s}] bool, got {tuple(sp_valid.shape)} "
                         f"{sp_valid.dtype}")
    for name, t in (("w1", w1), ("w2", w2), ("b0", b0), ("b1", b1), ("sp_valid", sp_valid),
                    *((k, v[0]) for k, v in small.items())):
        if t.device != w0.device:
            raise ValueError(f"{name} is on {t.device}, w0 on {w0.device}")
    q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid = (
        t.contiguous() for t in (q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid))
    out = torch.empty((b, q, s), dtype=torch.float32, device=w0.device)
    lib = cuda_build.load("dyco")
    fn = lib.gapro_dyco_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 5
                   + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    weights = []
    for t in (w0, w1, w2, b0, b1):
        weights += [t.data_ptr(), t.stride(0), t.stride(1)]
    with torch.cuda.device(w0.device):
        err = fn(*weights, q_locs.data_ptr(), q_dims.data_ptr(), sp_feats.data_ptr(),
                 sp_coords.data_ptr(), sp_dims.data_ptr(), sp_valid.data_ptr(), out.data_ptr(),
                 b, q, s, m, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "dyco_cuda")
    dyco_cuda.launches += 1
    return out


dyco_cuda.launches = 0


class DycoFn(torch.autograd.Function):
    """The mask head with K5 as its forward. The backward recomputes the
    plain version under autograd (``_dyco_bwd`` of the JAX package): the
    kernel and the plain version compute the same function, so that
    function's gradient is exact for both. ``sp_valid`` gets none."""

    @staticmethod
    def forward(ctx, w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid):
        ctx.save_for_backward(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                              sp_valid)
        return dyco_cuda(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                         sp_valid)

    @staticmethod
    def backward(ctx, grad):
        *saved, sp_valid = ctx.saved_tensors
        args = [t.detach().requires_grad_(need)
                for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [a for a in args if a.requires_grad]
        with torch.enable_grad():
            out = dyco_mlp_plain(*args, sp_valid)
        got = iter(torch.autograd.grad(out, wanted, grad)) if wanted else iter(())
        return (*(next(got) if a.requires_grad else None for a in args), None)


def dyco_mlp(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid):
    """The mask head as the model calls it: ``DycoFn`` (K5 forward, plain
    recompute backward) -> mask logits [B, Q, S]."""
    return DycoFn.apply(w0, w1, w2, b0, b1, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                        sp_valid)
