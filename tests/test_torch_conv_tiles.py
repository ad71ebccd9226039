"""The tables the port's conv kernels read besides the neighbour table
(``sparse/plan.py``: ``ConvTables``), and the precision their products run in.

* The dW kernel's per-offset pair lists hold exactly the pairs of ``nbr``,
  in increasing row order, with counts ``(nbr >= 0).sum(0)``.
* K1's row order is a permutation with the valid rows first, stably sorted
  by their 27-bit neighbour mask; each tile mask is the OR of its rows'.
* On the bench scene's plan the sort cuts the (row, offset) slots K1
  computes over the pairs that hold a neighbour (``chip_smoke.py``'s count,
  against its tables in the grid's own row order).
* Building the tables changes no table of the plan: it stays equal to the
  JAX package's.
* A numpy emulation of TF32 rounding: the split form (3xTF32) the kernels
  use lands within 1e-5 of the scale of the fp32 result at the conv's
  widths, where one TF32 pass misses K1's 1e-4.

Each table is checked against a numpy version written here, on the tiny
scene, a 3-item grid and the bench scene.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.ops.voxelize import voxelize as jax_voxelize
from gapro_tpu.sparse.plan import build_unet_plan as jax_build_plan
from gapro_tpu.sparse.tensor import SparseGrid as JaxGrid
from gapro_tpu_torch import data as port_data
from gapro_tpu_torch.models import prepare
from gapro_tpu_torch.ops.voxelize import voxelize
from gapro_tpu_torch.sparse.plan import (TILE_ROWS, ConvTables, build_unet_plan, neighbour_masks,
                                         pair_lists)
from gapro_tpu_torch.sparse.tensor import SparseGrid

from chip_smoke import K1_RTOL, computed_slots, spatial_tables, tc_bounds
from tests.test_torch_plan import _check_plans
BENCH_SHRINK = (0.67, 0.3, 0.25, 0.25, 0.25, 0.25)


def _tiny_plan():
    s = port_data.make_synthetic_scene(seed=0, n_objects=3, points_per_object=200, n_floor=300,
                                       n_wall=200)
    pb = prepare.points_to_batch_np([dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp)], voxel_scale=10,
                                    n_cap=2048)
    return prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, "cpu"), 2048, 1, 3, 256,
                                       0.7).batch.plan


def _multibatch_coords():
    """The 3-item grid of ``tests/test_torch_plan.py``, 100 padding points."""
    rng = np.random.default_rng(3)
    n = 900
    coords = np.stack([rng.integers(0, 3, n), rng.integers(0, 16, n), rng.integers(0, 24, n),
                       rng.integers(0, 24, n)], 1).astype(np.int32)
    return np.pad(coords, ((0, 100), (0, 0)), constant_values=-1), np.arange(n + 100) < n


def _multibatch_plan():
    coords, valid = _multibatch_coords()
    m = voxelize(torch.as_tensor(coords), (16, 24, 24), 1280, valid=torch.as_tensor(valid))
    grid = SparseGrid(coords=m.voxel_coords, valid=m.valid_voxel, num_voxels=m.num_voxels,
                      spatial_shape=(16, 24, 24), batch_size=3)
    return build_unet_plan(grid, 4, (0.6, 0.3, 0.6))


@pytest.fixture(scope="module", params=["tiny", "batch3"])
def plan(request):
    return _tiny_plan() if request.param == "tiny" else _multibatch_plan()


@pytest.fixture(scope="module")
def bench_plan():
    """Bench scene 0 of the full-width cells: 240,000 points, voxel scale 50,
    capacity 262,144, the shipped level schedule."""
    s = port_data.make_synthetic_scene(seed=0, n_objects=12, points_per_object=15000,
                                       n_floor=40000, n_wall=20000)
    pb = prepare.points_to_batch_np([dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp)], voxel_scale=50,
                                    n_cap=len(s.xyz))
    return prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, "cpu"), 262144, 1, 7, 4096,
                                       BENCH_SHRINK).batch.plan


def _masks_np(nbr):
    return ((nbr >= 0).astype(np.int64) << np.arange(27)).sum(1)


def test_pair_lists_hold_the_pairs_of_nbr(plan):
    for lvl, lp in enumerate(plan.levels):
        nbr = lp.subm_nbr.numpy()
        pi, pj, counts = (t.numpy() for t in lp.conv.pairs())
        v = nbr.shape[0]
        assert pi.shape == pj.shape == (27, v) and pi.dtype == pj.dtype == np.int32
        np.testing.assert_array_equal(counts, (nbr >= 0).sum(0), err_msg=f"level {lvl}")
        for k in range(27):
            rows = np.nonzero(nbr[:, k] >= 0)[0]
            n = len(rows)
            np.testing.assert_array_equal(pi[k, :n], rows, err_msg=f"level {lvl} offset {k}")
            np.testing.assert_array_equal(pj[k, :n], nbr[rows, k])
            assert (pi[k, n:] == 0).all() and (pj[k, n:] == 0).all()


def test_row_order_is_a_stable_mask_sort(plan):
    for lvl, lp in enumerate(plan.levels):
        nbr, valid = lp.subm_nbr.numpy(), lp.grid.valid.numpy()
        order = lp.conv.rows()[0].numpy()
        masks = _masks_np(nbr)
        np.testing.assert_array_equal(neighbour_masks(lp.subm_nbr).numpy(), masks)
        assert order.dtype == np.int32
        np.testing.assert_array_equal(np.sort(order), np.arange(len(order)))
        n_valid = int(valid.sum())
        assert valid[order[:n_valid]].all() and not valid[order[n_valid:]].any()
        np.testing.assert_array_equal(
            order, np.argsort(masks + (~valid << 27), kind="stable"), err_msg=f"level {lvl}")
        assert (np.diff(masks[order[:n_valid]]) >= 0).all()


def test_tile_masks_are_the_or_of_their_rows(plan):
    for lp in plan.levels:
        for tables in (lp.conv, spatial_tables(lp.subm_nbr)):
            order, tiles = (t.numpy() for t in tables.rows())
            m = _masks_np(lp.subm_nbr.numpy())[order]
            want = [np.bitwise_or.reduce(m[i:i + TILE_ROWS]) for i in range(0, len(m), TILE_ROWS)]
            np.testing.assert_array_equal(tiles, want)


def test_tables_are_built_lazily(plan):
    """A fresh plan holds no table; K1's rows do not build dW's pair lists,
    so inference never pays for them."""
    tables = ConvTables(plan.levels[0].subm_nbr, plan.levels[0].grid.valid)
    assert tables._rows is None and tables._pairs is None
    first = tables.rows()
    assert tables._pairs is None and tables.rows() is first
    assert tables.pairs() is tables.pairs()
    # the stand-alone function gives the same lists
    for a, b in zip(tables.pairs(), pair_lists(plan.levels[0].subm_nbr)):
        assert torch.equal(a, b)


def test_tables_leave_the_plan_equal_to_jax():
    coords, valid = _multibatch_coords()
    jm = jax_voxelize(jnp.asarray(coords), (16, 24, 24), 1280, valid=jnp.asarray(valid))
    jgrid = JaxGrid(coords=jm.voxel_coords, valid=jm.valid_voxel, num_voxels=jm.num_voxels,
                    spatial_shape=(16, 24, 24), batch_size=3)
    tplan = _multibatch_plan()
    for lp in tplan.levels:
        lp.conv.rows()
        lp.conv.pairs()
    _check_plans(jax_build_plan(jgrid, 4, (0.6, 0.3, 0.6)), tplan)


@pytest.mark.parametrize("lvl", range(7))
def test_sort_cuts_computed_slots_on_the_bench_plan(bench_plan, lvl):
    """K1 computes TILE_ROWS rows for every offset present in a tile. Over
    the pairs that hold a neighbour, the mask sort cuts those slots at levels
    0 to 4 (level 0: 3.74 to 2.20 at Cin = 32); at levels 5 and 6 (1,024 and
    256 rows) it gains nothing."""
    lp = bench_plan.levels[lvl]
    cin = 32 * (lvl + 1)
    nnz = int((lp.subm_nbr >= 0).sum())
    spatial = spatial_tables(lp.subm_nbr)
    got, base = (computed_slots(t.rows()[1], cin) / nnz for t in (lp.conv, spatial))
    assert 1 <= got and 1 <= base
    if lvl <= 4:
        assert got < base
    if lvl == 0:
        assert (round(got, 2), round(base, 2)) == (2.20, 3.74)
        # the stem (Cin = 6, padded to 8) packs four offsets into a chunk
        assert computed_slots(lp.conv.rows()[1], 6) / nnz < computed_slots(
            spatial.rows()[1], 6) / nnz


@pytest.mark.parametrize("nbytes,flops,by", [(95.8e6, 2.89e9, "bytes"), (20e6, 13.9e9, "operations")])
def test_conv_bound_counts_the_functions_operations(nbytes, flops, by):
    """The conv kernels' bound is the function's own 2 nnz Cin Cout
    operations at the TF32 rate (495 TFLOP/s) or its bytes at 3.35 TB/s,
    whichever is larger; the cost of the 3xTF32 form the kernels take (three
    products for each) and the fp32 bound stand beside it."""
    got = tc_bounds(nbytes, flops)
    assert got["bound"] == pytest.approx(max(nbytes / 3.35e12, flops / 495e12) * 1e3)
    assert got["by"] == by
    assert got["x3"] == pytest.approx(max(nbytes / 3.35e12, 3 * flops / 495e12) * 1e3)
    assert got["fp32"] == pytest.approx(max(nbytes / 3.35e12, flops / 67e12) * 1e3)


def _tf32(x):
    """Rounds fp32 ``x`` to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


@pytest.mark.parametrize("cin,cout", [(8, 32), (32, 32), (64, 64), (96, 96), (384, 192)])
def test_3xtf32_meets_k1_tolerance_where_one_pass_does_not(cin, cout):
    """One output row of K1 sums 27 * Cin products of gathered features (a
    third of them absent, as zeros) and weights of the model's initial
    scale. Against the exact sum (float64) of the fp32 inputs: 3xTF32
    (a_lo.b_hi + a_hi.b_lo + a_hi.b_hi; the products of TF32 values are exact
    in fp32) within 1e-5 of the result's scale; one TF32 pass (a_hi.b_hi)
    beyond K1_RTOL."""
    rng = np.random.default_rng(cin)
    rows, depth = 256, 27 * cin
    a = rng.normal(size=(rows, depth)).astype(np.float32)
    a[rng.random((rows, depth)) < 1 / 3] = 0
    bound = np.sqrt(3.0 / depth)
    b = rng.uniform(-bound, bound, size=(depth, cout)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = max(1.0, float(np.abs(exact).max()))
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    f64 = lambda x: x.astype(np.float64)
    three = (f64(a_lo) @ f64(b_hi) + f64(a_hi) @ f64(b_lo) + f64(a_hi) @ f64(b_hi)).astype(np.float32)
    one = (f64(a_hi) @ f64(b_hi)).astype(np.float32)
    assert np.abs(three - exact).max() <= 1e-5 * scale
    assert np.abs(one - exact).max() > K1_RTOL * scale
    # the emulation rounds as the hardware does: 10 mantissa bits, ties away
    assert _tf32(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)
    assert _tf32(np.float32(-(1 + 2 ** -11))) == np.float32(-(1 + 2 ** -10))
    assert _tf32(np.float32(1 + 2 ** -12)) == np.float32(1)
