"""The port's sparse convs against the JAX package.

The port's plain ``subm_conv`` is held against all three JAX forms of the
function: the XLA gather-GEMM ``subm_conv``, the windowed Pallas kernel
``subm_conv_window`` and the resident-table Pallas kernel
``subm_conv_pallas`` (both in interpret mode on the CPU, as the JAX
package's own tests run them). fp32 tolerance rtol = atol = 1e-4: the
same products summed in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.ops.voxelize import voxelize as jax_voxelize
from gapro_tpu.sparse import conv as jax_conv
from gapro_tpu.sparse.pallas_conv import subm_conv_pallas
from gapro_tpu.sparse.plan import build_unet_plan as jax_build_plan
from gapro_tpu.sparse.tensor import SparseGrid as JaxGrid
from gapro_tpu.sparse.window_conv import build_window_tables, subm_conv_window
from gapro_tpu_torch.sparse import conv as port_conv

TOL = dict(rtol=1e-4, atol=1e-4)
CAP, EXTENTS = 1024, (24, 32, 32)


@pytest.fixture(scope="module")
def plan():
    """Two-level plan of a random 700-voxel grid (capacity 1024; rows past
    700 are invalid)."""
    rng = np.random.default_rng(3)
    pts = set()
    while len(pts) < 700:
        pts.add((0, rng.integers(0, 24), rng.integers(0, 32), rng.integers(0, 32)))
    coords = np.pad(np.array(sorted(pts), np.int32), ((0, CAP - 700), (0, 0)),
                    constant_values=-1)
    maps = jax_voxelize(jnp.asarray(coords), EXTENTS, CAP, valid=jnp.arange(CAP) < 700)
    grid = JaxGrid(coords=maps.voxel_coords, valid=maps.valid_voxel,
                   num_voxels=maps.num_voxels, spatial_shape=EXTENTS, batch_size=1)
    return jax_build_plan(grid, 2, 0.5)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("cin,cout", [(6, 32), (16, 8)])
def test_subm_conv_matches_all_jax_forms(plan, cin, cout):
    lp = plan.levels[0]
    rng = np.random.default_rng(cin)
    valid = np.asarray(lp.grid.valid)
    feats = np.where(valid[:, None], rng.normal(size=(CAP, cin)), 0).astype(np.float32)
    w = rng.normal(size=(27, cin, cout)).astype(np.float32)
    nbr = np.asarray(lp.subm_nbr)
    got = port_conv.subm_conv(_t(feats), _t(nbr), _t(w), _t(valid)).numpy()
    assert (got[~valid] == 0).all()

    jf, jn, jw, jv = (jnp.asarray(a) for a in (feats, nbr, w, valid))
    forms = {
        "subm_conv": jax_conv.subm_conv(jf, jn, jw, jv),
        "subm_conv_window": subm_conv_window(jf, build_window_tables(jn), jw, jv),
        "subm_conv_pallas": subm_conv_pallas(jf, jn, jw, jv, tile=128, interpret=True),
    }
    for name, want in forms.items():
        np.testing.assert_allclose(got, np.asarray(want), err_msg=name, **TOL)


def test_down_and_inverse_conv_match_jax(plan):
    l0, l1 = plan.levels
    rng = np.random.default_rng(9)
    v0 = np.asarray(l0.grid.valid)
    feats = np.where(v0[:, None], rng.normal(size=(CAP, 8)), 0).astype(np.float32)
    wd = rng.normal(size=(8, 8, 16)).astype(np.float32)
    wu = rng.normal(size=(8, 16, 8)).astype(np.float32)

    want_d = jax_conv.down_conv(jnp.asarray(feats), l0.down_child, jnp.asarray(wd),
                                out_valid=l1.grid.valid)
    got_d = port_conv.down_conv(_t(feats), _t(l0.down_child), _t(wd), out_valid=_t(l1.grid.valid))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)

    want_u = jax_conv.inverse_conv(want_d, l0.parent, l0.offset_id, jnp.asarray(wu), l0.grid.valid)
    got_u = port_conv.inverse_conv(_t(want_d), _t(l0.parent), _t(l0.offset_id), _t(wu),
                                   _t(l0.grid.valid))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **TOL)
