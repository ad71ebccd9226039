"""The port's ``LocalAggregator`` against the JAX module at the point count
where both switch stage 1 to the grid ball query (N = 4 * 8192).

A dense cloud (B = 2, N = 32768, a fifth of the points invalid) at a radius
where a sampled point's 27 neighbour cells hold more than the grid's 512
candidates, so the cap binds on the path. Both packages get the same
weights: the flax init with every leaf redrawn from numpy, loaded into the
port by ``convert.load_flax_variables``. FPS samples and their neighbours
are discrete and must be equal; the features agree to rtol = atol = 1e-4,
the room fp32 leaves for two libraries summing the same products in
different orders. JAX runs its XLA ``fps_masked`` on the CPU, as its own
tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gapro_tpu.models.aggregator import LocalAggregator as JaxAggregator
from gapro_tpu_torch import convert
from gapro_tpu_torch.models.aggregator import LocalAggregator
from gapro_tpu_torch.ops import ballquery as port_bq

TOL = dict(rtol=1e-4, atol=1e-4)
B, N, C = 2, 32768, 4
KW = dict(mlp_dim=8, n_sample=64, radius=0.12, n_neighbor=16, n_neighbor_post=16)


def _inputs():
    rng = np.random.default_rng(0)
    locs = rng.uniform(0, 1, (B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    half = rng.uniform(0.01, 0.1, (B, N, 3)).astype(np.float32)
    boxes = np.concatenate([locs - half, locs + half], -1)
    valid = rng.random((B, N)) > 0.2
    return locs, feats, boxes, valid


def _randomize(variables, seed):
    """Dense kernels uniform with variance 1/fan_in, BN shifts and means in
    +-0.1, BN scales and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        b = np.sqrt(3.0 / leaf.shape[0])
        return rng.uniform(-b, b, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree_util.tree_map(np.asarray, variables))


def test_aggregator_matches_jax_at_grid_dispatch():
    inputs = _inputs()
    jagg = JaxAggregator(**KW)
    jin = [jnp.asarray(a) for a in inputs]
    variables = _randomize(jagg.init(jax.random.PRNGKey(0), *jin), seed=1)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jagg.apply)(variables, *jin))

    model = LocalAggregator(C, **KW)
    convert.load_flax_variables(model, variables)
    model.eval()
    tin = [torch.as_tensor(a) for a in inputs]
    with torch.no_grad():
        got = model(*tin)

    for key in ("inds", "valid"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), getattr(want, key), err_msg=key)
    assert want.valid.all()
    for key in ("locs", "boxes", "feats"):
        np.testing.assert_allclose(getattr(got, key).numpy(), getattr(want, key), err_msg=key,
                                   **TOL)
    # the cap binds at these samples: the grid's neighbours are not the
    # exact ones for some of them
    args = (got.locs, tin[0], got.valid, tin[3], KW["radius"], KW["n_neighbor"])
    grid = port_bq.ball_query_grid(*args)[0]
    assert (grid != port_bq.ball_query_tiled(*args)[0]).any()
