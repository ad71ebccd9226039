"""The port's host collate (``models/prepare.py:points_to_batch_np``, one
pass over preallocated fields) against the JAX package's
concatenate-and-pad collate: every field of the ``PointBatch`` equal in
dtype, shape and value, over batches of one and four scenes, with and
without ``xyz_scaled``, bucketed and at a given capacity, on superpoint
ids that take the presence table and ids that take the sort; and the
counters that say which of the two each scene took."""

import numpy as np
import pytest

from gapro_tpu.models.prepare import points_to_batch_np as jax_collate
from gapro_tpu_torch.models import prepare
from gapro_tpu_torch.utils import profiling

OPTIONAL = ("semantic", "instance", "prob", "mu", "var")


def _spp(rng, n, kind):
    """Superpoint ids of one scene, and the compaction they should take."""
    if kind == "dense":
        return rng.integers(0, max(n // 8, 1), n), "dense"
    if kind == "offset":  # dense, far from 0
        return rng.integers(10 ** 9, 10 ** 9 + n // 4, n), "dense"
    if kind == "negative":
        return rng.integers(-n // 4, n // 4, n), "dense"
    if kind == "int32":
        return rng.integers(-7, n // 8, n).astype(np.int32), "dense"
    if kind == "sparse":  # a few ids scattered over a range far wider than the scene
        return rng.choice(rng.integers(0, 1000 * n, n // 10), n), "sorted"
    if kind == "huge":
        return rng.choice(rng.integers(-2 ** 62, 2 ** 62, 64), n), "sorted"
    if kind == "float":
        return rng.integers(0, n // 8, n).astype(np.float64) * 0.5, "sorted"
    # a range of exactly the table's limit (ids 0 and span - 1 present), or one past it
    span = prepare._SPP_TABLE_SPAN * n + (kind == "past_limit")
    ids = rng.integers(0, span, n)
    ids[:2] = 0, span - 1
    return ids, "dense" if kind == "at_limit" else "sorted"


def _scene(rng, n, *, spp="dense", scaled=True, negative=False, keys=OPTIONAL,
           instances="some", near_integers=False):
    lo = -4.0 if negative else 0.0
    xyz = rng.uniform(lo, 6.0, (n, 3))
    ids, path = _spp(rng, n, spp)
    scene = dict(xyz=xyz, rgb=rng.uniform(-1, 1, (n, 3)).astype(np.float32), spp=ids)
    if scaled:  # as the transforms leave it, or negative where the coordinates are
        scene["xyz_scaled"] = (xyz - (0 if negative else xyz.min(0))) * 47.3
        if near_integers:  # just under an integer: float64's floor, not float32's
            scene["xyz_scaled"][::2] = np.round(scene["xyz_scaled"][::2]) - 1e-9
    inst = rng.integers(-1, 6, n)
    inst[inst < 0] = -100
    if instances == "none":
        inst[:] = -100
    labels = dict(semantic=rng.integers(-1, 18, n), instance=inst,
                  prob=rng.uniform(0.5, 1, n).astype(np.float32),
                  mu=rng.normal(size=n).astype(np.float32),
                  var=rng.uniform(0, 0.5, n).astype(np.float32))
    scene.update({k: v for k, v in labels.items() if k in keys})
    return scene, path


def _batch(seed, n_scenes, n_cap=None, **kw):
    rng = np.random.default_rng(seed)
    made = [_scene(rng, int(rng.integers(200, 900)), **kw) for _ in range(n_scenes)]
    scenes, paths = [s for s, _ in made], [p for _, p in made]
    if n_cap == "given":
        n_cap = sum(len(s["xyz"]) for s in scenes) + 37
    return scenes, dict(voxel_scale=20, n_cap=n_cap), paths


CASES = {
    f"{n}scene-{'scaled' if scaled else 'unscaled'}-{'cap' if cap else 'bucketed'}":
        dict(n_scenes=n, scaled=scaled, n_cap="given" if cap else None)
    for n in (1, 4) for scaled in (True, False) for cap in (False, True)
}
CASES.update({
    **{f"spp-{kind}": dict(n_scenes=4, spp=kind)
       for kind in ("offset", "negative", "int32", "sparse", "huge", "float", "at_limit",
                    "past_limit")},
    "spp-sparse-unscaled-cap": dict(n_scenes=4, spp="sparse", scaled=False, n_cap="given"),
    "instances-all-ignored": dict(n_scenes=4, instances="none"),
    "optional-keys-missing": dict(n_scenes=4, keys=()),
    "optional-keys-some": dict(n_scenes=4, keys=("instance", "mu")),
    "negative-coords": dict(n_scenes=4, negative=True),
    "scaled-near-integers": dict(n_scenes=4, negative=True, near_integers=True),
    "negative-coords-unscaled": dict(n_scenes=4, negative=True, scaled=False),
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_collate_matches_jax(case):
    scenes, kw, _ = _batch(sorted(CASES).index(case), **CASES[case])
    got, want = prepare.points_to_batch_np(scenes, **kw), jax_collate(scenes, **kw)
    assert got._fields == want._fields
    for name, g, w in zip(want._fields, got, want):
        assert isinstance(g, np.ndarray), name
        assert (g.dtype, g.shape) == (w.dtype, w.shape), name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_first_scene_instances_ignored_then_shifted():
    """Instance ids past an all-ignored scene start again at 0; the next
    scene's ids >= 0 are shifted past them, its negative ids kept."""
    rng = np.random.default_rng(5)
    scenes = [_scene(rng, 300, instances=s)[0] for s in ("none", "some", "some")]
    scenes[2]["instance"][:3] = -1, -100, 0
    got = prepare.points_to_batch_np(scenes, voxel_scale=20)
    want = jax_collate(scenes, voxel_scale=20)
    np.testing.assert_array_equal(got.instance, want.instance)
    top = scenes[1]["instance"].max()
    assert got.instance[:300].max() == -100 and got.instance[300:600].max() == top
    assert got.instance[600:603].tolist() == [-1, -100, top + 1]


def test_capacity_too_small_raises():
    scenes, kw, _ = _batch(0, 2)
    with pytest.raises(ValueError):
        prepare.points_to_batch_np(scenes, voxel_scale=20, n_cap=len(scenes[0]["xyz"]))


@pytest.mark.parametrize("kind", ["dense", "negative", "at_limit", "sparse", "float",
                                  "past_limit"])
def test_spp_path_counted(kind):
    """With tracing on, each scene counts once under the compaction it
    took: the table where its ids are dense integers, else the sort."""
    scenes, kw, paths = _batch(11, 3, spp=kind)
    scenes.append(_scene(np.random.default_rng(12), 250)[0])  # dense ids
    paths.append("dense")
    profiling.enable(True)
    profiling.drain()
    try:
        prepare.points_to_batch_np(scenes, **kw)
        counts = profiling.drain()["counts"]
    finally:
        profiling.enable(False)
        profiling.drain()
    assert counts.get("collate.spp_dense", 0) + counts.get("collate.spp_sorted", 0) == 4
    assert counts.get("collate.spp_dense", 0) == paths.count("dense")
    assert counts.get("collate.spp_sorted", 0) == paths.count("sorted")

