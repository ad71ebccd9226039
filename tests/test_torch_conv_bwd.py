"""The port's submanifold-conv backward against the JAX package.

On a random 700-voxel grid of capacity 1024 (rows past 700 invalid), the
backward of the port's ``SubmConvFn`` with its plain versions (dfeats as the
conv of dout with the reversed, transposed weights; dW one offset at a
time) is held against three JAX references for the same random output
gradient: ``jax.grad`` of the XLA ``subm_conv``, and ``subm_conv_window``'s
custom VJP in interpret mode with ``GAPRO_WINDOW_FUSED=1`` (the fused TPU
kernel K2) and ``=0`` (dfeats by the forward kernel, dW by K3). fp32, rtol =
atol = 1e-4: the same products summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.ops.voxelize import voxelize as jax_voxelize
from gapro_tpu.sparse import conv as jax_conv
from gapro_tpu.sparse import window_conv
from gapro_tpu.sparse.plan import build_unet_plan as jax_build_plan
from gapro_tpu.sparse.tensor import SparseGrid as JaxGrid
from gapro_tpu.sparse.window_conv import build_window_tables, subm_conv_window
from gapro_tpu_torch.sparse import conv as port_conv
from gapro_tpu_torch.sparse.plan import ConvTables

TOL = dict(rtol=1e-4, atol=1e-4)
CAP, EXTENTS = 1024, (24, 32, 32)


@pytest.fixture(scope="module")
def level():
    rng = np.random.default_rng(3)
    pts = set()
    while len(pts) < 700:
        pts.add((0, rng.integers(0, 24), rng.integers(0, 32), rng.integers(0, 32)))
    coords = np.pad(np.array(sorted(pts), np.int32), ((0, CAP - 700), (0, 0)),
                    constant_values=-1)
    maps = jax_voxelize(jnp.asarray(coords), EXTENTS, CAP, valid=jnp.arange(CAP) < 700)
    grid = JaxGrid(coords=maps.voxel_coords, valid=maps.valid_voxel,
                   num_voxels=maps.num_voxels, spatial_shape=EXTENTS, batch_size=1)
    return jax_build_plan(grid, 1, 0.5).levels[0]


def _inputs(lp, cin, cout):
    rng = np.random.default_rng(cin * 100 + cout)
    valid = np.asarray(lp.grid.valid)
    feats = np.where(valid[:, None], rng.normal(size=(CAP, cin)), 0).astype(np.float32)
    w = rng.normal(size=(27, cin, cout)).astype(np.float32)
    g = rng.normal(size=(CAP, cout)).astype(np.float32)  # unmasked: the backward masks it
    return feats, np.asarray(lp.subm_nbr), w, valid, g


def _port_grads(feats, nbr, w, valid, g, need_dfeats=True):
    tf = torch.tensor(feats, requires_grad=need_dfeats)
    tw = torch.tensor(w, requires_grad=True)
    tn, tv = torch.tensor(nbr), torch.tensor(valid)
    out = port_conv.SubmConvFn.apply(tf, tw, tn, tv, ConvTables(tn, tv))
    (out * torch.tensor(g)).sum().backward()
    return (tf.grad.numpy() if need_dfeats else None), tw.grad.numpy()


def _jax_grads(fn, feats, w, g):
    loss = lambda f, ww: jnp.sum(fn(f, ww) * jnp.asarray(g))
    df, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(w))
    return np.asarray(df), np.asarray(dw)


@pytest.mark.parametrize("cin,cout", [(6, 32), (16, 8), (32, 32)])
def test_conv_backward_matches_all_jax_forms(level, monkeypatch, cin, cout):
    feats, nbr, w, valid, g = _inputs(level, cin, cout)
    got_df, got_dw = _port_grads(feats, nbr, w, valid, g)
    assert (got_df[~valid] == 0).all()

    jn, jv = jnp.asarray(nbr), jnp.asarray(valid)
    tabs = build_window_tables(jn)
    refs = {"jax.grad(subm_conv)": _jax_grads(
        lambda f, ww: jax_conv.subm_conv(f, jn, ww, jv), feats, w, g)}
    calls = []
    for name in ("_pallas_bwd_fused", "_pallas_dw"):  # record which TPU kernel ran
        fn = getattr(window_conv, name)
        monkeypatch.setattr(window_conv, name,
                            lambda *a, _fn=fn, _name=name: calls.append(_name) or _fn(*a))
    for fused, kernel in (("1", "_pallas_bwd_fused"), ("0", "_pallas_dw")):
        monkeypatch.setenv("GAPRO_WINDOW_FUSED", fused)
        calls.clear()
        refs[f"subm_conv_window, GAPRO_WINDOW_FUSED={fused}"] = _jax_grads(
            lambda f, ww: subm_conv_window(f, tabs, ww, jv), feats, w, g)
        assert calls == [kernel]
    for name, (df, dw) in refs.items():
        np.testing.assert_allclose(got_df, df, err_msg=f"dfeats vs {name}", **TOL)
        np.testing.assert_allclose(got_dw, dw, err_msg=f"dW vs {name}", **TOL)


def test_stem_backward_skips_dfeats(level):
    """The stem's input needs no gradient: the backward then computes dW
    alone, and that dW equals the one computed beside dfeats."""
    feats, nbr, w, valid, g = _inputs(level, 6, 32)
    _, dw_only = _port_grads(feats, nbr, w, valid, g, need_dfeats=False)
    _, dw_both = _port_grads(feats, nbr, w, valid, g)
    np.testing.assert_array_equal(dw_only, dw_both)


def test_plain_pieces_are_the_transposed_conv(level):
    """dfeats is the forward conv of the masked dout with ``w_rev[k] =
    W[26 - k]^T``, and ``subm_conv_dw`` is the weight gradient of the plain
    forward under autograd."""
    feats, nbr, w, valid, g = _inputs(level, 16, 8)
    tf, tw = torch.tensor(feats, requires_grad=True), torch.tensor(w, requires_grad=True)
    tn, tv, tg = torch.tensor(nbr), torch.tensor(valid), torch.tensor(g)
    (port_conv.subm_conv(tf, tn, tw, tv) * tg).sum().backward()
    dout = torch.where(tv[:, None], tg, 0.0)
    w_rev = torch.tensor(w).flip(0).transpose(1, 2).contiguous()
    torch.testing.assert_close(port_conv.subm_conv(dout, tn, w_rev, tv), tf.grad, **TOL)
    torch.testing.assert_close(port_conv.subm_conv_dw(torch.tensor(feats), tn, dout), tw.grad,
                               **TOL)
