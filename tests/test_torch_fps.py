"""The port's FPS against the JAX package, and the compaction K4 runs on.
FPS indices are discrete: they must be equal.

K4 (``fps_cuda`` on the card) walks each item's valid points compacted to
the front (``compact_valid``) and maps the indices back. On the CPU the
same composition, with the plain version in the kernel's place, must equal
``fps_masked`` on the original input bit for bit: exact ties, fewer valid
points than samples, an item with none, and items of different counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.ops.fps import fps_masked as jax_fps
from gapro_tpu.ops.fps_pallas import fps_masked_pallas
from gapro_tpu_torch.ops import fps as port_fps


def _cases():
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(3, 500, 3)).astype(np.float32)
    valid = rng.random((3, 500)) > 0.3
    few = np.zeros((1, 100), bool)
    few[0, 40:43] = True  # fewer valid points than samples
    xyz_few = np.random.default_rng(1).normal(size=(1, 100, 3)).astype(np.float32)
    # every point three times over on a coarse lattice: exact ties at every step
    lattice = rng.integers(0, 4, (2, 120, 3)).astype(np.float32)
    dup = np.concatenate([lattice, lattice[:, ::-1], lattice], 1)
    dup_valid = rng.random((2, 360)) > 0.25
    none = rng.normal(size=(2, 200, 3)).astype(np.float32)
    none_valid = rng.random((2, 200)) > 0.5
    none_valid[1] = False  # an item with no valid point
    ragged_valid = np.zeros((3, 400), bool)
    for i, (lo, hi, p) in enumerate(((0, 400, 0.9), (100, 160, 0.7), (390, 400, 1.0))):
        ragged_valid[i, lo:hi] = rng.random(hi - lo) < p  # counts far apart
    ragged = rng.uniform(-2, 2, (3, 400, 3)).astype(np.float32)
    return {"random": (xyz, valid, 64), "few_valid": (xyz_few, few, 8),
            "duplicates": (dup, dup_valid, 96), "no_valid_item": (none, none_valid, 32),
            "ragged_counts": (ragged, ragged_valid, 48)}


@pytest.mark.parametrize("case", list(_cases()))
def test_fps_matches_jax(case):
    xyz, valid, k = _cases()[case]
    got_i, got_v = port_fps.fps_masked(torch.as_tensor(xyz), torch.as_tensor(valid), k)
    for ref in (jax_fps, fps_masked_pallas):
        want_i, want_v = ref(jnp.asarray(xyz), jnp.asarray(valid), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i), err_msg=ref.__name__)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v), err_msg=ref.__name__)


@pytest.mark.parametrize("case", ["random", "duplicates", "few_valid", "no_valid_item",
                                  "ragged_counts"])
def test_fps_on_compacted_points_matches(case):
    xyz, valid, k = _cases()[case]
    xyz, valid = torch.as_tensor(xyz), torch.as_tensor(valid)
    cxyz, table, count = port_fps.compact_valid(xyz, valid)
    np.testing.assert_array_equal(count.numpy(), valid.sum(1).numpy())
    for i in range(len(xyz)):
        n = int(count[i])
        np.testing.assert_array_equal(table[i, :n].numpy(), np.flatnonzero(valid[i].numpy()))
        np.testing.assert_array_equal(cxyz[i, :n].numpy(), xyz[i, valid[i]].numpy())
        # the invalid points follow in their order: every point has one slot
        np.testing.assert_array_equal(table[i, n:].numpy(), np.flatnonzero(~valid[i].numpy()))
        np.testing.assert_array_equal(cxyz[i, n:].numpy(), xyz[i, ~valid[i]].numpy())
    cvalid = torch.arange(xyz.shape[1])[None, :] < count[:, None]
    idx, sample_valid = port_fps.fps_masked(cxyz, cvalid, k)
    want_i, want_v = port_fps.fps_masked(xyz, valid, k)
    np.testing.assert_array_equal(table.gather(1, idx.long()).numpy(), want_i.numpy())
    np.testing.assert_array_equal(sample_valid.numpy(), want_v.numpy())


@pytest.mark.parametrize("n,cluster,cap", [(2048, 1, 2048), (16385, 2, 8196), (40000, 4, 10000),
                                           (262144, 16, 16384), (1048576, 16, 16384)])
def test_fps_launch_shape(n, cluster, cap):
    """The cluster holds N points on chip, up to 16 blocks of 16384; past
    that the rest stays in global memory."""
    shape = port_fps.launch_shape(n)
    assert (shape["cluster"], shape["cap"]) == (cluster, cap)
    assert shape["on_chip"] == cluster * cap >= min(n, 16 * 16384)
