"""The library functions that only tests call, the port's against the JAX
package's on the same numpy inputs (CPU), on the cases
``test_core.py``, ``test_extra_ops.py``, ``test_pointops.py``,
``test_voxelize.py`` and ``test_inference.py`` use and on random ones.

Tolerances: indices, labels, masks and counts are equal; float outputs
that are sums taken in another order (interpolation, vote fractions,
distances) within 1e-6 relative and absolute; IoUs of 0/1 masks are
exact sums, equal. ``random_downsample`` draws from a ``torch.Generator``
where JAX takes a PRNG key, so it is held to its contract instead: the
count, a subset of the valid rows without repeats, the same draw from the
same seed, and every valid row reachable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.core import batching as jbatching
from gapro_tpu.core import segment as jsegment
from gapro_tpu.ops import components as jcomponents
from gapro_tpu.ops import fps as jfps
from gapro_tpu.ops import interpolate as jinterp
from gapro_tpu.ops import maskiou as jmaskiou
from gapro_tpu.ops import nms as jnms
from gapro_tpu.ops.voxelize import devoxelize as jax_devoxelize
from gapro_tpu.utils import rle as jrle
from gapro_tpu_torch.core import batching, segment
from gapro_tpu_torch.ops import components, fps, interpolate, maskiou, nms, voxelize
from gapro_tpu_torch.utils import rle


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return np.asarray(x)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if torch.is_tensor(got) else got, _j(want))


def _close(got, want, tol=1e-6):
    np.testing.assert_allclose(got.numpy(), _j(want), rtol=tol, atol=tol)


# ---- core/segment.py ----------------------------------------------------------

def _segment_case(case):
    if case == "test_core":
        data = np.array([5.0, 1.0, 3.0, 1.0, 9.0, 2.0], np.float32)
        return data, np.array([0, 0, 1, 1, 2, 2]), 3
    rng = np.random.default_rng(0)
    data = rng.integers(0, 20, 2000).astype(np.float32)  # ties on purpose
    seg = rng.integers(-2, 60, 2000)  # dropped ids and empty segments
    return data, seg, 64


@pytest.mark.parametrize("case", ["test_core", "random with ties and empties"])
def test_segment_argmin_and_prod_mask(case):
    data, seg, n = _segment_case(case)
    _eq(segment.segment_argmin(_t(data), _t(seg), n),
        jsegment.segment_argmin(jnp.asarray(data), jnp.asarray(seg), n))
    mask = data > 2
    _eq(segment.segment_prod_mask(_t(mask), _t(seg), n),
        jsegment.segment_prod_mask(jnp.asarray(mask), jnp.asarray(seg), n))


@pytest.mark.parametrize("seed", [0, 1])
def test_superpoint_major_voting(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, 20, 3000)
    labels[rng.random(3000) < 0.1] = -100
    spp = rng.integers(-1, 200, 3000)
    got = segment.superpoint_major_voting(_t(labels), _t(spp), 20, 256)
    want = jsegment.superpoint_major_voting(jnp.asarray(labels), jnp.asarray(spp), 20, 256)
    _eq(got[0], want[0])
    _close(got[1], want[1])


# ---- core/batching.py: the contract -------------------------------------------

def test_random_downsample_contract():
    n, k = 500, 64
    valid = torch.from_numpy(np.random.default_rng(0).random(n) < 0.6)
    draws = []
    for seed in (0, 0, 1):
        idx, ok = batching.random_downsample(torch.Generator().manual_seed(seed), valid, k)
        assert idx.dtype == torch.int32 and idx.shape == ok.shape == (k,)
        assert bool(ok.all()) and bool(valid[idx.long()].all())
        assert len(set(idx.tolist())) == k
        draws.append(idx)
    assert torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    reached = set()
    for seed in range(200):
        reached |= set(batching.random_downsample(torch.Generator().manual_seed(seed), valid,
                                                  k)[0].tolist())
    assert reached == set(torch.nonzero(valid)[:, 0].tolist())
    # fewer valid rows than asked: the tail repeats the first pick, masked
    few = torch.zeros(n, dtype=torch.bool)
    few[[3, 70, 400]] = True
    idx, ok = batching.random_downsample(torch.Generator().manual_seed(0), few, 8)
    assert ok.tolist() == [True] * 3 + [False] * 5
    assert set(idx[:3].tolist()) == {3, 70, 400} and (idx[3:] == idx[0]).all()
    # the JAX function's contract, the same checks
    jidx, jok = jbatching.random_downsample(jax.random.PRNGKey(0), jnp.asarray(few.numpy()), 8)
    assert _j(jok).tolist() == ok.tolist() and set(_j(jidx)[:3].tolist()) == {3, 70, 400}


# ---- ops/voxelize.py -------------------------------------------------------------

def test_devoxelize():
    rng = np.random.default_rng(0)
    vf = rng.normal(size=(50, 4)).astype(np.float32)
    p2v = rng.integers(-1, 50, 300).astype(np.int32)
    _eq(voxelize.devoxelize(_t(vf), _t(p2v)), jax_devoxelize(jnp.asarray(vf), jnp.asarray(p2v)))


# ---- ops/fps.py -----------------------------------------------------------------------

def _fps_inputs(seed, n=300, b=2):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(b, n, 3)).astype(np.float32)
    valid = rng.random((b, n)) < 0.8
    valid[-1, : n // 2] = False
    return xyz, valid


@pytest.mark.parametrize("case", ["test_extra_ops", "random"])
def test_fps_weights_masked(case):
    if case == "test_extra_ops":
        xyz = np.random.default_rng(2).normal(size=(1, 40, 3)).astype(np.float32)
        valid = np.ones((1, 40), bool)
        w = np.ones((1, 40), np.float32)
        w[0, 7] = 100.0
        n_sample = 4
    else:
        xyz, valid = _fps_inputs(3)
        w = np.random.default_rng(4).random(valid.shape).astype(np.float32) + 0.5
        n_sample = 64
    got = fps.fps_weights_masked(_t(xyz), _t(w), _t(valid), n_sample)
    want = jfps.fps_weights_masked(jnp.asarray(xyz), jnp.asarray(w), jnp.asarray(valid), n_sample)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_fps_with_dist_masked():
    xyz, valid = _fps_inputs(5, n=120)
    d2 = np.sum((xyz[:, :, None] - xyz[:, None]) ** 2, -1).astype(np.float32)
    start = np.array([0, 119], np.int32)
    got = fps.fps_with_dist_masked(_t(d2), _t(valid), _t(start), 32)
    want = jfps.fps_with_dist_masked(jnp.asarray(d2), jnp.asarray(valid), jnp.asarray(start), 32)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("dims", [3, 6])
def test_fps_ia_masked(dims):
    xyz, valid = _fps_inputs(6)
    feats = np.concatenate([xyz, xyz[..., : dims - 3] * 3.0], -1) if dims > 3 else xyz
    got = fps.fps_ia_masked(_t(feats), _t(valid), 48)
    want = jfps.fps_ia_masked(jnp.asarray(feats), jnp.asarray(valid), 48)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_fps_ia_masked_uses_all_dims():
    feats = np.zeros((1, 8, 6), np.float32)
    feats[0, 4:, 3] = 10.0  # the same xyz, split by a feature dim
    got = fps.fps_ia_masked(_t(feats), torch.ones(1, 8, dtype=torch.bool), 2)
    want = jfps.fps_ia_masked(jnp.asarray(feats), jnp.ones((1, 8), bool), 2)
    _eq(got[0], want[0])
    assert got[0][0, 1] >= 4


@pytest.mark.parametrize("case", ["test_pointops", "random"])
def test_fps_hybrid_masked(case):
    if case == "test_pointops":
        xyz = np.random.default_rng(0).normal(size=(1, 64, 3)).astype(np.float32)
        off = xyz.copy()
        off[0, :32, 0] += 100.0
        valid = np.ones((1, 64), bool)
        n_sample = 16
    else:
        xyz, valid = _fps_inputs(7)
        off = xyz + np.random.default_rng(8).normal(size=xyz.shape).astype(np.float32)
        off[:, ::7] = 0.0  # |p|^2 <= 1e-3: sits the offset steps out
        n_sample = 40
    got = fps.fps_hybrid_masked(_t(xyz), _t(off), _t(valid), n_sample, 2.0)
    want = jfps.fps_hybrid_masked(jnp.asarray(xyz), jnp.asarray(off), jnp.asarray(valid),
                                  n_sample, 2.0)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


# ---- ops/components.py ---------------------------------------------------------

def test_connected_components():
    nbr = np.full((12, 2), -1, np.int32)
    for i in range(4):
        nbr[i, 0], nbr[i + 1, 1] = i + 1, i
    for i in range(5, 9):
        nbr[i, 0], nbr[i + 1, 1] = i + 1, i
    valid = np.zeros(12, bool)
    valid[:10] = True
    cases = [(nbr, valid)]
    rng = np.random.default_rng(0)
    rnd = rng.integers(-1, 400, (400, 3)).astype(np.int32)
    cases.append((rnd, rng.random(400) < 0.9))
    for n_idx, v in cases:
        _eq(components.connected_components(_t(n_idx), _t(v)),
            jcomponents.connected_components(jnp.asarray(n_idx), jnp.asarray(v)))


@pytest.mark.parametrize("case", ["test_extra_ops", "three classes"])
def test_cluster_points(case):
    rng = np.random.default_rng(1)
    if case == "test_extra_ops":
        xyz = np.concatenate([rng.normal(0, 0.05, (60, 3)),
                              rng.normal(0, 0.05, (60, 3)) + [0.1, 0, 0]]).astype(np.float32)
        sem = np.array([3] * 60 + [7] * 60)
        valid = np.ones(120, bool)
        radius, min_points = 0.3, 10
    else:
        xyz = rng.random((600, 3)).astype(np.float32) * 2.0
        sem = rng.integers(0, 3, 600)
        valid = rng.random(600) < 0.95
        radius, min_points = 0.15, 5
    got = components.cluster_points(_t(xyz), _t(valid), _t(sem), radius, k=16,
                                    min_points=min_points)
    want = jcomponents.cluster_points(jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(sem),
                                      radius, 16, min_points)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


# ---- ops/interpolate.py --------------------------------------------------------

@pytest.mark.parametrize("case", ["test_extra_ops", "masked"])
def test_knn_and_three_interpolate(case):
    rng = np.random.default_rng(0)
    ref = rng.normal(size=(2, 50, 3)).astype(np.float32)
    q = ref[:, :10] + 1e-3
    rv = np.ones((2, 50), bool)
    qv = np.ones((2, 10), bool)
    if case == "masked":
        rv[1, ::3] = False
        qv[0, 4] = False
    d, idx = interpolate.knn(_t(q), _t(ref), _t(qv), _t(rv), 3)
    jd, jidx = jinterp.knn(jnp.asarray(q), jnp.asarray(ref), jnp.asarray(qv), jnp.asarray(rv), 3)
    _eq(idx, jidx)
    _close(d, jd)
    feats = rng.normal(size=(2, 50, 4)).astype(np.float32)
    out = interpolate.three_interpolate(_t(feats), idx, d, _t(qv))
    _close(out, jinterp.three_interpolate(jnp.asarray(feats), jidx, jd, jnp.asarray(qv)))


def test_knn_ties_keep_index_order():
    ref = np.zeros((1, 6, 3), np.float32)  # every ref at one place
    q = np.ones((1, 2, 3), np.float32)
    d, idx = interpolate.knn(_t(q), _t(ref), torch.ones(1, 2, dtype=torch.bool),
                             torch.ones(1, 6, dtype=torch.bool), 3)
    _eq(idx, jinterp.knn(jnp.asarray(q), jnp.asarray(ref), jnp.ones((1, 2), bool),
                         jnp.ones((1, 6), bool), 3)[1])


def test_gather_and_group_points():
    v = np.arange(60.0, dtype=np.float32).reshape(2, 15, 2)
    idx = np.array([[2, 0, 14], [1, 1, 3]], np.int32)
    gidx = np.random.default_rng(0).integers(0, 15, (2, 4, 3)).astype(np.int32)
    _eq(interpolate.gather_points(_t(v), _t(idx)), jinterp.gather_points(jnp.asarray(v),
                                                                          jnp.asarray(idx)))
    _eq(interpolate.group_points(_t(v), _t(gidx)), jinterp.group_points(jnp.asarray(v),
                                                                        jnp.asarray(gidx)))


# ---- ops/maskiou.py -----------------------------------------------------------------

@pytest.mark.parametrize("case", ["test_extra_ops", "random"])
def test_mask_iou_and_label(case):
    if case == "test_extra_ops":
        inst = np.array([0, 0, 0, 1, 1, -100])
        props = np.array([[1, 1, 1, 0, 0, 0], [0, 0, 1, 1, 1, 1]], np.float32)
        n_inst = 2
    else:
        rng = np.random.default_rng(0)
        inst = rng.integers(-1, 12, 2000)
        props = (rng.random((30, 2000)) < 0.3).astype(np.float32)
        props[3] = inst == 5
        n_inst = 12
    _eq(maskiou.mask_iou_on_cluster(_t(props), _t(inst), n_inst),
        jmaskiou.mask_iou_on_cluster(jnp.asarray(props), jnp.asarray(inst), n_inst))
    got = maskiou.mask_label(_t(props), _t(inst), 0.4, n_inst)
    want = jmaskiou.mask_label(jnp.asarray(props), jnp.asarray(inst), 0.4, n_inst)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


# ---- ops/nms.py and utils/rle.py (host numpy) ----------------------------------------

@pytest.mark.parametrize("case", ["test_inference", "random"])
def test_standard_nms_host(case):
    if case == "test_inference":
        masks = np.zeros((3, 10), np.float32)
        masks[0, :6] = masks[1, :5] = masks[2, 6:] = 1
        cats, scores, weights = np.array([0, 0, 0]), np.array([0.9, 0.5, 0.7]), np.ones(10)
    else:
        rng = np.random.default_rng(0)
        masks = (rng.random((40, 300)) < 0.2).astype(np.float32)
        masks[20:] = np.maximum(masks[:20], (rng.random((20, 300)) < 0.05))
        cats, scores = rng.integers(0, 3, 40), rng.random(40)
        weights = rng.integers(1, 5, 300).astype(np.float32)
    got = nms.standard_nms_host(masks, cats, scores, weights, threshold=0.2)
    want = jnms.standard_nms_host(masks, cats, scores, weights, threshold=0.2)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_rle_encode_batch():
    rng = np.random.default_rng(0)
    masks = rng.random((6, 257)) < 0.4
    masks[0] = False
    masks[1] = True
    got, want = rle.rle_encode_batch(masks), jrle.rle_encode_batch(masks)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["length"] == w["length"]
        assert g["counts"].dtype == w["counts"].dtype
        np.testing.assert_array_equal(g["counts"], w["counts"])
