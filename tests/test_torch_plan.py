"""The port's voxelization, batch preparation and U-Net plan against the JAX
package. Every output here is discrete (or a mean of the same inputs in
the same order), and must be equal: voxel order, point->voxel map, the
neighbour, parent, offset and child tables, and the overflow counts."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gapro_tpu.core.bucketing import next_bucket as jax_next_bucket
from gapro_tpu.data import make_synthetic_scene, remap_semantic_for_training
from gapro_tpu.models.prepare import points_to_batch_np, prepare_voxel_batch
from gapro_tpu.ops.voxelize import voxelize as jax_voxelize
from gapro_tpu.sparse.plan import build_unet_plan as jax_build_plan
from gapro_tpu.sparse.tensor import SparseGrid as JaxGrid
from gapro_tpu_torch import data as port_data
from gapro_tpu_torch.core.bucketing import next_bucket as port_next_bucket
from gapro_tpu_torch.models import prepare as port_prepare
from gapro_tpu_torch.ops.voxelize import voxelize as port_voxelize
from gapro_tpu_torch.sparse.plan import build_unet_plan as port_build_plan
from gapro_tpu_torch.sparse.plan import level_capacities
from gapro_tpu_torch.sparse.tensor import SparseGrid as PortGrid


def _eq(got, want, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)


def _check_plans(jplan, tplan):
    assert len(jplan.levels) == len(tplan.levels)
    for i, (jl, tl) in enumerate(zip(jplan.levels, tplan.levels)):
        _eq(tl.grid.coords, jl.grid.coords, f"level {i} coords")
        _eq(tl.grid.valid, jl.grid.valid, f"level {i} valid")
        assert tl.grid.num_voxels == int(jl.grid.num_voxels)
        assert tl.grid.spatial_shape == tuple(jl.grid.spatial_shape)
        _eq(tl.subm_nbr, jl.subm_nbr, f"level {i} subm_nbr")
        assert tl.dropped_next == int(jl.dropped_next), f"level {i} dropped_next"
        if jl.parent is None:
            assert tl.parent is None and tl.down_child is None
        else:
            _eq(tl.parent, jl.parent, f"level {i} parent")
            _eq(tl.offset_id, jl.offset_id, f"level {i} offset_id")
            _eq(tl.down_child, jl.down_child, f"level {i} down_child")


def test_prepare_tiny_scene_matches_jax():
    s = make_synthetic_scene(seed=0, n_objects=3, points_per_object=200, n_floor=300, n_wall=200)
    scene = dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp, semantic=s.semantic_label,
                 instance=s.instance_label)
    pb = points_to_batch_np([scene], voxel_scale=10, n_cap=2048)
    jp = prepare_voxel_batch(jax.tree_util.tree_map(jnp.asarray, pb), 2048, 1, 3, 256, 0.7)
    tpb = port_prepare.points_to_batch_np([scene], voxel_scale=10, n_cap=2048)
    for name, a, b in zip(pb._fields, pb, tpb):
        _eq(b, a, name)
    tp = port_prepare.prepare_voxel_batch(port_prepare.upload_point_batch(tpb, "cpu"),
                                          2048, 1, 3, 256, 0.7)
    _check_plans(jp.batch.plan, tp.batch.plan)
    for name in ("point2voxel", "voxel_semantic", "voxel_instance", "voxel_rgb"):
        _eq(getattr(tp, name), getattr(jp, name), name)
    for name in ("feats", "coords_float", "batch_idx", "valid", "spp", "vox_npoints"):
        _eq(getattr(tp.batch, name), getattr(jp.batch, name), name)


def test_multibatch_grid_plan_matches_jax():
    """Random 3-item grid; the 0.3 step of the schedule overflows level 2 so
    that ``dropped_next`` is exercised."""
    shrink, levels = (0.6, 0.3, 0.6), 4
    rng = np.random.default_rng(3)
    n, cap, extents = 900, 1280, (16, 24, 24)
    coords = np.stack([rng.integers(0, 3, n), rng.integers(0, 16, n),
                       rng.integers(0, 24, n), rng.integers(0, 24, n)], 1).astype(np.int32)
    coords = np.pad(coords, ((0, 100), (0, 0)), constant_values=-1)
    valid = np.arange(n + 100) < n

    jm = jax_voxelize(jnp.asarray(coords), extents, cap, valid=jnp.asarray(valid))
    tm = port_voxelize(torch.as_tensor(coords), extents, cap, valid=torch.as_tensor(valid))
    for name in ("voxel_coords", "point2voxel", "voxel_first_point", "valid_voxel"):
        _eq(getattr(tm, name), getattr(jm, name), name)
    assert tm.num_voxels == int(jm.num_voxels) and tm.overflow == int(jm.overflow)

    jgrid = JaxGrid(coords=jm.voxel_coords, valid=jm.valid_voxel, num_voxels=jm.num_voxels,
                    spatial_shape=extents, batch_size=3)
    tgrid = PortGrid(coords=tm.voxel_coords, valid=tm.valid_voxel, num_voxels=tm.num_voxels,
                     spatial_shape=extents, batch_size=3)
    jplan = jax_build_plan(jgrid, levels, shrink)
    tplan = port_build_plan(tgrid, levels, shrink)
    _check_plans(jplan, tplan)
    assert tplan.levels[1].dropped_next > 0


def test_full_width_level_capacities():
    """The bench scene's capacities under the shipped schedule."""
    caps = level_capacities(262144, 7, (0.67, 0.3, 0.25, 0.25, 0.25, 0.25))
    assert caps == [262144, 176128, 52992, 13312, 3328, 1024, 256]


def test_numpy_copies_match_jax():
    """The port keeps its own copies of the JAX package's numpy helpers:
    the synthetic scene, the ScanNet label remap and the bucket sizes."""
    want = make_synthetic_scene(seed=2, n_objects=4, points_per_object=100, n_floor=200,
                                n_wall=120)
    got = port_data.make_synthetic_scene(seed=2, n_objects=4, points_per_object=100,
                                         n_floor=200, n_wall=120)
    for name in want._fields:
        _eq(getattr(got, name), getattr(want, name), name)
    _eq(port_data.remap_semantic_for_training(want.semantic_label),
        remap_semantic_for_training(want.semantic_label), "remap")
    for n in (1, 100, 128, 129, 200, 1000, 70000, 262144):
        assert port_next_bucket(n) == jax_next_bucket(n), n
