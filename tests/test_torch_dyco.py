"""The port's dynamic-conv mask head (``models/dyco.py``) against the JAX
package: its einsum form ``dyco_mlp_xla`` and the TPU kernel K5
``_dyco_pallas`` run in interpret mode, as ``tests/test_dyco_pallas.py``
runs it.

The port's ``dyco_mlp`` goes through ``DycoFn``: on CPU tensors the forward
takes the plain version, and the backward recomputes it under autograd, so
both halves of the function the card runs are held here. Tolerance: rtol
2e-5, atol 2e-4, the JAX test's own for sums taken in another order (the
kernel sums the geometry and feature rows in one accumulator; the einsums
sum them apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.models.dyco import _dyco_pallas, dyco_mlp_xla
from gapro_tpu_torch.models import dyco

TOL = dict(rtol=2e-5, atol=2e-4)


def _problem(rng, B, Q, S, m=32, h=16):
    """The inputs of ``tests/test_dyco_pallas.py`` as numpy arrays."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [f(B, Q, m + 6, m), f(B, Q, m, h), f(B, Q, h, 1), f(B, Q, m), f(B, Q, h),
            f(B, Q, 3), np.abs(f(B, Q, 3)), f(B, S, m), f(B, S, 3), np.abs(f(B, S, 3)),
            rng.random((B, S)) > 0.2]


@pytest.mark.parametrize("B,Q,S", [(2, 64, 600), (1, 12, 130)])
def test_dyco_matches_jax(B, Q, S):
    args = _problem(np.random.default_rng(0), B, Q, S)
    before = dyco.dyco_cuda.launches
    got = dyco.dyco_mlp(*(torch.tensor(a) for a in args)).numpy()
    assert dyco.dyco_cuda.launches == before  # CPU tensors launch nothing
    jargs = [jnp.asarray(a) for a in args]
    for want in (dyco_mlp_xla(*jargs), _dyco_pallas(*jargs)):
        assert got.shape == want.shape == (B, Q, S)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert (got[np.broadcast_to(~args[-1][:, None, :], got.shape)] == -1e4).all()


def test_dyco_grads_match_jax():
    """The gradients of all ten differentiable inputs through ``DycoFn``'s
    recompute backward against ``jax.grad`` of the TPU kernel's custom VJP."""
    args = _problem(np.random.default_rng(1), 1, 16, 256)

    def loss_pallas(*a):
        return jnp.sum(jnp.tanh(_dyco_pallas(*a, jnp.asarray(args[-1])) * 1e-2))

    want = jax.grad(loss_pallas, argnums=tuple(range(10)))(*(jnp.asarray(a) for a in args[:-1]))
    targs = [torch.tensor(a, requires_grad=True) for a in args[:-1]]
    loss = torch.tanh(dyco.dyco_mlp(*targs, torch.tensor(args[-1])) * 1e-2).sum()
    got = torch.autograd.grad(loss, targs)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=f"input {i}", **TOL)


def test_dyco_takes_strided_controller_views():
    """The model hands the weights as views of one controller row (split,
    then reshaped); the result equals that of contiguous copies, and only
    the inputs that need a gradient get one."""
    rng = np.random.default_rng(2)
    B, Q, S, m, h = 2, 5, 40, 8, 4
    sizes = [(m + 6) * m, m * h, h, m, h]
    ctrl = torch.tensor(rng.standard_normal((B, Q, sum(sizes))).astype(np.float32),
                        requires_grad=True)
    parts = torch.split(ctrl, sizes, dim=-1)
    w0, w1, w2 = (parts[0].reshape(B, Q, m + 6, m), parts[1].reshape(B, Q, m, h),
                  parts[2].reshape(B, Q, h, 1))
    rest = [torch.tensor(a) for a in _problem(rng, B, Q, S, m, h)[5:]]
    out = dyco.dyco_mlp(w0, w1, w2, parts[3], parts[4], *rest)
    want = dyco.dyco_mlp_plain(*(t.contiguous() for t in (w0, w1, w2, parts[3], parts[4])), *rest)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    out.sum().backward()
    assert ctrl.grad is not None and all(t.grad is None for t in rest)
