# Frozen copy of gapro_tpu_torch/sparse/conv.py, its CUDA kernels taken out (plain PyTorch only); it does not follow later changes
# to the port.
"""Sparse convolutions, plain PyTorch in float32 (the benchmark's frozen
copy of ``gapro_tpu_torch/sparse/conv.py``'s plain versions).

* ``subm_conv``: the 3x3x3 submanifold conv as one zero-sentinel gather
  plus one matmul.
* ``SubmConvFn``: the conv with the backward ``dfeats = subm_conv(dout,
  nbr, W[26 - k]^T)`` and ``dW[k] = sum_i feats[nbr[i, k]]^T dout[i]``
  (``subm_conv_dw``), saving no [V, 27 * Cin] gather.
* ``down_conv`` / ``inverse_conv``: the stride-2 kernel-2 pair sharing one
  rulebook, under autograd.
"""

from __future__ import annotations

import torch

# A missing entry (-1) reads one of this many zero rows appended to the
# table. Autograd's backward of a row gather adds each entry's gradient into
# the row it read, and on the card the entries of one row are added one
# after another: one shared zero row would serialise every missing entry
# (most of the [Vc, 8] child table, a fifth of the voxel capacity).
_ZERO_ROWS = 1024


def _zero_padded(feats):
    return torch.cat([feats, feats.new_zeros((_ZERO_ROWS, feats.shape[1]))], 0)


def _padded_index(idx, v: int):
    spread = torch.arange(idx.numel(), device=idx.device).reshape(idx.shape) % _ZERO_ROWS
    return torch.where(idx >= 0, idx.long(), v + spread)


def gather_rows(feats, idx):
    """feats [V, C], int idx [...] (-1 missing) -> [..., C], zeros for -1."""
    return _zero_padded(feats)[_padded_index(idx, feats.shape[0])]


def compute_dtype() -> torch.dtype:
    """The operands' type: always float32 here."""
    return torch.float32


def _operands(feats, idx, weights, dtype):
    """The gathered rows ``feats[idx]`` and the weights as a conv multiplies
    them. In bf16 both are rounded to bf16 and held in ``feats``' type,
    where their products are exact: the JAX package's bf16 dot with an fp32
    result. The rows are gathered from the bf16 table, so that autograd
    adds their gradients in bf16, as XLA's transpose of the gather does."""
    return gather_rows(feats, idx), weights


def subm_conv(feats, nbr_idx, weights, valid, dtype=None):
    """Plain version of K1 (fp32) and of K1-bf16.

    feats [V, Cin], nbr_idx [V, 27] int (-1 missing), weights [27, Cin,
    Cout], valid [V] bool -> [V, Cout]; invalid rows are 0. ``dtype`` is
    the operands' type, ``compute_dtype()`` if None.
    """
    v, cin = feats.shape
    k, _, cout = weights.shape
    g, w = _operands(feats, nbr_idx, weights, compute_dtype() if dtype is None else dtype)
    out = g.reshape(v, k * cin) @ w.reshape(k * cin, cout)
    return torch.where(valid[:, None], out, 0.0)


def subm_conv_dw(feats, nbr_idx, dout):
    """Plain version of the dW kernel: ``dW[k] = sum_i feats[nbr[i, k]]^T
    dout[i]`` -> [27, Cin, Cout]. One offset at a time, so that only one
    [V, Cin] gather is held."""
    table, idx = _zero_padded(feats), _padded_index(nbr_idx, feats.shape[0])
    return torch.stack([table[idx[:, k]].T @ dout for k in range(nbr_idx.shape[1])])


class SubmConvFn(torch.autograd.Function):
    """``subm_conv`` with a backward that recomputes its gathers."""

    @staticmethod
    def forward(ctx, feats, weights, nbr_idx, valid):
        ctx.save_for_backward(feats, weights, nbr_idx, valid)
        return subm_conv(feats, nbr_idx, weights, valid)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, nbr_idx, valid = ctx.saved_tensors
        dout = torch.where(valid[:, None], dout, 0.0).contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            dfeats = subm_conv(dout, nbr_idx, weights.flip(0).transpose(1, 2), valid)
        if ctx.needs_input_grad[1]:
            dw = subm_conv_dw(feats, nbr_idx, dout)
        return dfeats, dw, None, None


def subm_conv_auto(feats, level_plan, weights):
    """The subm conv of one U-Net level, with the backward of ``SubmConvFn``."""
    return SubmConvFn.apply(feats.contiguous(), weights.contiguous(), level_plan.subm_nbr,
                            level_plan.grid.valid)


def down_conv(feats, child_idx, weights, out_valid=None):
    """Stride-2 kernel-2 conv: out[p] = sum_kk feats[child_idx[p, kk]] @ W[kk],
    with the operands of ``compute_dtype()``."""
    k, cin, cout = weights.shape
    vc = child_idx.shape[0]
    g, w = _operands(feats, child_idx, weights, compute_dtype())
    out = g.reshape(vc, k * cin) @ w.reshape(k * cin, cout)
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0.0)
    return out


def inverse_conv(coarse_feats, parent, offset_id, weights, valid):
    """Transpose of ``down_conv`` on the shared rulebook:
    fine[i] = coarse[parent(i)] @ W[offset(i)], with the operands of
    ``compute_dtype()``."""
    gathered, weights = _operands(coarse_feats, parent, weights, compute_dtype())
    out = None
    for kk in range(8):
        sel = (offset_id == kk)[:, None]
        yk = torch.where(sel, gathered, 0.0) @ weights[kk]
        out = yk if out is None else out + yk
    return torch.where(valid[:, None], out, 0.0)
