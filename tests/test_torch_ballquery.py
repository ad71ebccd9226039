"""The port's ball query against the JAX package. Indices and counts are
discrete: they must be equal.

``ball_query_tiled`` is held against the JAX tiled form on random clouds.
``ball_query_grid`` is held against the JAX grid form on a sparse lattice
(no query near the 512-candidate cap), on a dense cloud where the cap binds
(shown with numpy, and by the grid result differing from the exact tiled
one), and at the grid's border cells. ``ball_query_masked`` must switch
forms at the same N as the JAX dispatch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.ops import ballquery as jax_bq
from gapro_tpu_torch.ops import ballquery as port_bq

CAP = 512  # 4 * cell_cap candidates a query


def _port(fn, q, p, qv, pv, radius, k, **kw):
    idx, cnt = fn(*(torch.as_tensor(a) for a in (q, p, qv, pv)), radius, k, **kw)
    return idx.numpy(), cnt.numpy()


def _jax(fn, q, p, qv, pv, radius, k, *args):
    idx, cnt = fn(*(jnp.asarray(a) for a in (q, p, qv, pv)), radius, k, *args)
    return np.asarray(idx), np.asarray(cnt)


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _cells(xyz, p, pv, radius):
    """The grid's cell coordinates of ``xyz`` (numpy, the JAX float ops)."""
    r = np.float32(radius)
    lo = np.where(pv[..., None], p, np.inf).min(1, keepdims=True)
    origin = np.where(np.isfinite(lo), lo, np.float32(0)) - r
    return np.clip(np.floor((xyz - origin) * (np.float32(1) / r)), 0, 1023).astype(np.int64)


def _candidates(q, p, qv, pv, radius):
    """Valid points in each valid query's 27 neighbour cells: what its 9
    column runs hold before the cap."""
    qc, pc = _cells(q, p, pv, radius), _cells(p, p, pv, radius)
    near = np.repeat(pv[:, None, :], q.shape[1], 1)
    for axis in range(3):
        near &= np.abs(qc[:, :, None, axis] - pc[:, None, :, axis]) <= 1
    return np.where(qv, near.sum(-1), 0)


def _dense_cloud(n, seed=0, b=2, nq=128, radius=0.12):
    """Uniform in the unit cube, a fifth of the points and a tenth of the
    queries invalid; at this radius a query's 27 cells hold about 1200
    valid points, more than twice the cap."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 1, (b, n, 3)).astype(np.float32)
    pv = rng.random((b, n)) > 0.2
    q = p[:, :nq] + rng.normal(0, 0.02, (b, nq, 3)).astype(np.float32)
    qv = rng.random((b, nq)) > 0.1
    return q, p, qv, pv, radius, 16


@pytest.mark.parametrize("chunk", [8192, 96])
def test_ball_query_matches_tiled(chunk):
    """Random clouds; ``chunk`` = 96 forces the running merge across chunks."""
    rng = np.random.default_rng(0)
    b, nq, n, k, radius = 2, 40, 600, 8, 0.3
    pts = rng.uniform(0, 2, (b, n, 3)).astype(np.float32)
    pv = rng.random((b, n)) > 0.2
    q = pts[:, :nq] + rng.normal(0, 0.05, (b, nq, 3)).astype(np.float32)
    qv = rng.random((b, nq)) > 0.1
    want = _jax(jax_bq.ball_query_tiled, q, pts, qv, pv, radius, k)
    _assert_equal(_port(port_bq.ball_query_tiled, q, pts, qv, pv, radius, k, chunk=chunk), want)


def test_ball_query_matches_grid_below_candidate_cap():
    rng = np.random.default_rng(1)
    side, spacing, radius, k = 64, 0.05, 0.13, 16
    sites = rng.choice(side ** 3, 32768, replace=False)
    lattice = np.stack(np.unravel_index(sites, (side,) * 3), 1)
    pts = (lattice * spacing).astype(np.float32)[None]
    q = pts[:, rng.choice(32768, 256, replace=False)]
    pv = np.ones((1, 32768), bool)
    qv = np.ones((1, 256), bool)
    args = (q, pts, qv, pv, radius, k)
    got = _port(port_bq.ball_query_grid, *args)
    assert got[1].min() > 0  # every query finds at least itself
    _assert_equal(got, _jax(jax_bq.ball_query_grid, *args))
    # below the cap the grid form is exact: it equals the tiled form
    _assert_equal(got, _port(port_bq.ball_query_tiled, *args))


def test_ball_query_grid_matches_jax_where_the_cap_binds():
    args = _dense_cloud(32768)
    cands = _candidates(*args[:5])
    assert (cands > CAP).any() and (cands[args[2]] > 0).all()
    got = _port(port_bq.ball_query_grid, *args)
    _assert_equal(got, _jax(jax_bq.ball_query_grid, *args))
    exact = _port(port_bq.ball_query_tiled, *args)
    differ = (got[0] != exact[0]).any(-1)
    assert differ.any()
    assert (cands[differ] > CAP).all()  # only capped queries lose neighbours


def test_ball_query_grid_matches_jax_at_the_grid_border():
    """Points whose minimum lands in cell 0, points past 1023 cells that the
    clip folds into the last cell on every axis, and queries below the
    origin and past the far border."""
    rng = np.random.default_rng(2)
    radius, k, n = 0.1, 12, 4096
    near = 0.3 + rng.uniform(0, 0.6, (n // 2, 3))  # minimum 0.3: cell 0 (checked below)
    near[0] = 0.3
    far = 102.0 + rng.uniform(0, 1.0, (n // 2, 3))  # cells 1017 to past 1023
    p = np.concatenate([near, far]).astype(np.float32)[None]
    pv = np.ones((1, n), bool)
    pv[0, 1::7] = False
    q = np.concatenate([p[0, :40], p[0, n // 2:n // 2 + 40],
                        [[0.0, 0.0, 0.0], [0.25, 0.35, 0.3], [104.0, 104.0, 104.0],
                         [0.3, 103.5, 0.3], [102.35, 102.35, 102.35]]]).astype(np.float32)[None]
    qv = np.ones(q.shape[:2], bool)
    cells = _cells(p, p, pv, radius)[pv]
    assert (cells == 0).any() and (cells == 1023).all(-1).any()
    assert (_cells(q, p, pv, radius) == 0).all(-1).any()
    args = (q, p, qv, pv, radius, k)
    got = _port(port_bq.ball_query_grid, *args)
    _assert_equal(got, _jax(jax_bq.ball_query_grid, *args))
    assert (got[1] > 0).sum() >= 40


@pytest.mark.parametrize("n", [32767, 32768])
def test_ball_query_masked_dispatch_matches_jax(n):
    """Below 4 * 8192 points both packages take the tiled form, from there
    the grid form; on this cloud the two forms differ."""
    args = _dense_cloud(n, seed=3, b=1, nq=64)
    got = _port(port_bq.ball_query_masked, *args)
    _assert_equal(got, _jax(jax_bq.ball_query_masked, *args))
    grid = _port(port_bq.ball_query_grid, *args)
    tiled = _port(port_bq.ball_query_tiled, *args)
    assert (grid[0] != tiled[0]).any()
    _assert_equal(got, grid if n >= 32768 else tiled)


def test_ball_query_grid_drops_aliased_runs_at_the_border():
    """A query in cell y = 0 whose dy = -1 column would alias the run of cell
    (x - 2, 1023) at the packed key's border, and a query in cell z = 0
    whose dz range would start in the previous column's z = 1023 cell.
    Each aliased run holds more points than the whole budget, so a form
    that kept it would examine no real neighbour."""
    rng = np.random.default_rng(4)
    def jitter(centre, spread, m):
        spread = np.broadcast_to(np.asarray(spread, np.float32), (3,))
        return np.asarray(centre, np.float32) + rng.uniform(-spread, spread, (m, 3))

    qa, qb = (0.75, 0.3, 0.55), (1.25, 1.25, 0.3)  # cells (5, 0, 3) and (10, 10, 0)
    near_a = jitter(qa, 0.03, 20)
    near_a[:, 1] = 0.3 + np.abs(near_a[:, 1] - 0.3)
    near_b = jitter(qb, 0.03, 20)
    near_b[:, 2] = 0.3 + np.abs(near_b[:, 2] - 0.3)
    p = np.concatenate([[[0.3, 0.3, 0.3]], near_a, near_b,
                        jitter((0.55, 103.0, 0.55), (0.03, 0.3, 0.05), 600),  # cell (3, 1023, 2..4)
                        jitter((1.15, 1.05, 103.0), (0.03, 0.03, 0.3), 600)]  # cell (9, 8, 1023)
                       ).astype(np.float32)[None]
    pv = np.ones(p.shape[:2], bool)
    q = np.asarray([[qa, qb]], np.float32)
    qc = _cells(q, p, pv, 0.1)
    np.testing.assert_array_equal(qc[0], [[5, 0, 3], [10, 10, 0]])
    args = (q, p, np.ones((1, 2), bool), pv, 0.1, 8)
    got = _port(port_bq.ball_query_grid, *args)
    _assert_equal(got, _jax(jax_bq.ball_query_grid, *args))
    assert (got[1] > 0).all()
