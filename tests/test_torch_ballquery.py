"""The port's exact ball query against the JAX package. Indices and counts
are discrete: they must be equal.

At small N the reference is ``ball_query_tiled`` on random clouds. At
N = 32768 the JAX package switches to ``ball_query_grid``, which examines at
most 512 candidates per query; the port keeps the exact semantics, so the
comparison uses a sparse lattice cloud where no query comes near that cap
and no point lies near the radius (the grid path computes |p - q|^2, the
tiled path |q|^2 + |p|^2 - 2 q.p, and the lattice keeps both exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.ops.ballquery import ball_query_grid, ball_query_tiled
from gapro_tpu_torch.ops.ballquery import ball_query


def _run_port(q, p, qv, pv, radius, k, **kw):
    idx, cnt = ball_query(*(torch.as_tensor(a) for a in (q, p, qv, pv)), radius, k, **kw)
    return idx.numpy(), cnt.numpy()


@pytest.mark.parametrize("chunk", [8192, 96])
def test_ball_query_matches_tiled(chunk):
    """Random clouds; ``chunk`` = 96 forces the running merge across chunks."""
    rng = np.random.default_rng(0)
    b, nq, n, k, radius = 2, 40, 600, 8, 0.3
    pts = rng.uniform(0, 2, (b, n, 3)).astype(np.float32)
    pv = rng.random((b, n)) > 0.2
    q = pts[:, :nq] + rng.normal(0, 0.05, (b, nq, 3)).astype(np.float32)
    qv = rng.random((b, nq)) > 0.1
    want = ball_query_tiled(*(jnp.asarray(a) for a in (q, pts, qv, pv)), radius, k)
    got = _run_port(q, pts, qv, pv, radius, k, chunk=chunk)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


def test_ball_query_matches_grid_below_candidate_cap():
    rng = np.random.default_rng(1)
    side, spacing, radius, k = 64, 0.05, 0.13, 16
    sites = rng.choice(side ** 3, 32768, replace=False)
    lattice = np.stack(np.unravel_index(sites, (side,) * 3), 1)
    pts = (lattice * spacing).astype(np.float32)[None]
    q = pts[:, rng.choice(32768, 256, replace=False)]
    pv = np.ones((1, 32768), bool)
    qv = np.ones((1, 256), bool)
    want = ball_query_grid(*(jnp.asarray(a) for a in (q, pts, qv, pv)), radius, k)
    got = _run_port(q, pts, qv, pv, radius, k)
    assert got[1].min() > 0  # every query finds at least itself
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
