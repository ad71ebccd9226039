"""Cholesky factor and triangular inverse of the SVGP's M x M systems
(``gapro_tpu/gp/linalg.py``).

The JAX package builds both from matmuls because ``solve_triangular`` is a
block-sequential loop on the TPU: an explicit L^{-1} by block doubling,
applied as one product, and a Cholesky whose reverse pass is matmuls given
that inverse (Murray 2016). The port keeps the same two functions and the
same formulation, with the library calls as their plain form:
``torch.linalg.cholesky_ex`` (cuSOLVER) for the factor and
``torch.linalg.solve_triangular`` (cuBLAS) for the inverse. The block
doubling is not carried over.

The fit takes the formulation and not just the functions: 50 Adam steps
amplify rounding (a gradient entry at the noise floor whose sign differs
moves by the full rate at the first step), and with the JAX package's
arithmetic path the port's fits stay within the cross-implementation bounds
of ``tests/test_parity_gp.py``, where solves in place of the inverse did not
(``tests/test_torch_gp.py``).
"""

from __future__ import annotations

import torch


def tri_inv_mm(low: torch.Tensor) -> torch.Tensor:
    """Inverse of the lower-triangular ``low`` [..., N, N]."""
    eye = torch.eye(low.shape[-1], dtype=low.dtype, device=low.device)
    return torch.linalg.solve_triangular(low, eye.expand_as(low), upper=False)


class _CholeskyMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k):
        low = torch.linalg.cholesky_ex(k, check_errors=False).L
        ctx.save_for_backward(low)
        return low

    @staticmethod
    def backward(ctx, dl):
        # Kbar = L^{-T} sym(Phi(L^T Lbar)) L^{-1}, Phi the lower triangle
        # with its diagonal halved
        (low,) = ctx.saved_tensors
        eye = torch.eye(low.shape[-1], dtype=low.dtype, device=low.device)
        il = tri_inv_mm(low)
        p = torch.tril(low.transpose(-1, -2) @ dl)
        p = p - 0.5 * eye * p
        sym = 0.5 * (p + p.transpose(-1, -2))
        return il.transpose(-1, -2) @ (sym @ il)


def cholesky_mm(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the batched SPD ``k`` [..., N, N], with the
    matmul reverse pass of the JAX package.

    ``cholesky_ex`` with ``check_errors=False``: ``cholesky`` reads the
    factorisation's ``info`` back to the host, which would synchronise every
    step of the fit. A matrix that is not positive definite gives NaN rows,
    as ``jnp.linalg.cholesky`` does."""
    return _CholeskyMM.apply(k)
