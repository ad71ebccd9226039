"""The port's GP labeler (``gapro_tpu_torch/labeler/``) against the JAX
package's, on the CPU.

* ``boxes.py``: identical outputs (both are the same numpy).
* The device stage: pooled features within 1e-6 (the same superpoint sums
  taken in another order) and the thresholded occupancy identical, on a
  small synthetic scene with walls and the floor slab.
* The job list (pairs, rows, ops, buckets, row draws): identical.
* The write-back: bit for bit, with the same fake posterior, a
  deterministic numpy function of each job's rows, injected into both
  packages' batched fit, so resolution is held apart from solver drift.
* The whole ``generate_scene_labels_stream``, window 2, four small scenes:
  within ``chip_smoke.py:labeler_gate``'s bounds (the job lists identical;
  fits within the cross-implementation bound of ``tests/test_parity_gp.py``;
  points no fit decides identical; confident flips at most 5%).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import gapro_tpu.labeler.boxes as jb
import gapro_tpu.labeler.pipeline as jp
from gapro_tpu.data import make_synthetic_scene
import gapro_tpu_torch.labeler.boxes as tb
import gapro_tpu_torch.labeler.pipeline as tp

FIXTURES = Path(__file__).resolve().parent / "fixtures" / "scannetv2"


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The port's fits on one CPU thread: PyTorch's CPU reductions split
    their sums by the thread team, whose size changes with the machine's
    load, and 50 Adam steps amplify the changed rounding to the size of the
    bound."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _synthetic(seed, **kw):
    s = make_synthetic_scene(seed=seed, **kw)
    _, cls, boxes, vols, _ = jb.instance_info(s.xyz, s.instance_label, s.semantic_label,
                                              with_corners=False)
    return dict(coords=s.xyz, gp_feats=np.concatenate([s.xyz, s.rgb], 1), spp=s.spp,
                instance_cls=cls, instance_box=boxes, instance_box_volume=vols)


def _walls(coords, n=3, seed=0):
    rng = np.random.default_rng(seed)
    mx = coords.max(0)
    boxes = []
    for _ in range(n):
        x = rng.random() * mx[0]
        boxes.append([x, 0.0, 0.0, x + 0.1, mx[1], mx[2]])
    boxes = np.asarray(boxes, np.float32)
    return boxes, np.prod(boxes[:, 3:] - boxes[:, :3], axis=1).astype(np.float32)


def _random_scene(seed, n_points=4000, n_inst=10, walls=False):
    """Uniform points in a 4 m cube, grid-cell superpoints, boxes of mixed
    sizes so some nest in others (the in-box shortcuts)."""
    rng = np.random.default_rng(seed)
    coords = (rng.random((n_points, 3)) * 4.0).astype(np.float32)
    feats = rng.random((n_points, 3)).astype(np.float32)
    cell = np.floor(coords / 0.3).astype(np.int64)
    _, spp = np.unique(cell[:, 0] * 10000 + cell[:, 1] * 100 + cell[:, 2], return_inverse=True)
    centers = rng.random((n_inst, 3)).astype(np.float32) * 3.5 + 0.25
    half = rng.random((n_inst, 3)).astype(np.float32) * 0.8 + 0.15
    boxes = np.clip(np.concatenate([centers - half, centers + half], 1), 0.0, 4.0)
    vols = np.prod(np.clip(boxes[:, 3:] - boxes[:, :3], 1e-3, None), axis=1)
    kw = dict(coords=coords, gp_feats=feats, spp=spp * 3 + 1,  # ids that are not dense
              instance_cls=rng.integers(0, 18, size=n_inst).astype(np.int64),
              instance_box=boxes, instance_box_volume=vols.astype(np.float32))
    if walls:
        kw["wall_box"], kw["wall_box_volume"] = _walls(coords, seed=seed)
    return kw


def test_boxes_match_jax():
    s = make_synthetic_scene(seed=3, n_objects=5, points_per_object=300, n_floor=600, n_wall=400)
    for corners in (True, False):
        a = jb.instance_info(s.xyz, s.instance_label, s.semantic_label, with_corners=corners)
        b = tb.instance_info(s.xyz, s.instance_label, s.semantic_label, with_corners=corners)
        assert a[0] == b[0] and all(np.array_equal(x, y) for x, y in zip(a[1:], b[1:]))
    assert tb.instance_info(s.xyz, np.full(len(s.xyz), -100), s.semantic_label) is None
    for x, y in zip(jb.floor_box(s.xyz), tb.floor_box(s.xyz)):
        assert np.array_equal(x, y)
    plane = json.loads((FIXTURES / "scannet_planes" / "scene0000_00.json").read_text())
    mat = np.eye(4)
    mat[:3, 3] = [0.5, -1.0, 0.2]
    for m in (None, mat):
        a, b = jb.wall_boxes_from_planes(plane, m), tb.wall_boxes_from_planes(plane, m)
        assert len(a[0]) > 0 and all(np.array_equal(x, y) for x, y in zip(a, b))
    boxes = _random_scene(0)["instance_box"]
    for x, y in zip(jb.box_giou_cross(boxes, boxes[:4]), tb.box_giou_cross(boxes, boxes[:4])):
        assert np.array_equal(x, y)
    for i in range(len(boxes)):
        for j in range(len(boxes)):
            assert jb.is_box1_in_box2(boxes[i], boxes[j], 0.1) == tb.is_box1_in_box2(
                boxes[i], boxes[j], 0.1)


def _jax_handle(kw, cfg=jp.LabelerConfig()):
    return jp.submit_scene(cfg=cfg, device=jax.devices()[0], **kw)


@pytest.mark.parametrize("which", ["synthetic", "random"])
def test_occupancy_and_pooling_match_jax(which):
    if which == "synthetic":
        kw = _synthetic(1, n_objects=6, points_per_object=600, n_floor=1500, n_wall=1000)
        kw["wall_box"], kw["wall_box_volume"] = _walls(kw["coords"])
    else:
        kw = _random_scene(2, walls=True)
    hj = _jax_handle(kw)
    ht = tp.submit_scene(device="cpu", **kw)
    assert (ht.n_spps, ht.n_boxes, ht.n_fg) == (hj.n_spps, hj.n_boxes, hj.n_fg)
    for f in ("boxes", "boxes_cls", "boxes_volume", "spp_inverse"):
        assert np.array_equal(getattr(ht, f), getattr(hj, f)), f
    occ_j = jp._unpack_occ(np.asarray(hj.occ_bits), hj.n_boxes)[: hj.n_spps]
    occ_t = ht.occ.numpy()
    assert occ_t.shape == occ_j.shape and np.array_equal(occ_t, occ_j)
    assert occ_t.any(1).sum() > 0 and (occ_t.sum(1) > 1).any()  # overlaps exist
    feats_j = np.asarray(hj.feats)[: hj.n_spps]
    np.testing.assert_allclose(ht.feats.numpy(), feats_j, rtol=1e-6, atol=1e-6)


def _same_jobs(a, b):
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert (x.b1, x.b2, x.scene) == (y.b1, y.b2, y.scene)
        for f in ("b1_inds", "b2_inds", "intersect_inds"):
            assert np.array_equal(getattr(x, f), getattr(y, f))


@pytest.mark.parametrize("seed", [0, 1])
def test_job_list_matches_jax(seed):
    kw = _random_scene(seed, walls=bool(seed))
    cfg = tp.LabelerConfig(max_train=64, max_test=16)  # both caps bind
    rj = jp.enumerate_scene(_jax_handle(kw), jp.LabelerConfig(max_train=64, max_test=16))
    rt = tp.enumerate_scene(tp.submit_scene(cfg=cfg, device="cpu", **kw), cfg)
    _same_jobs(rt.jobs, rj.jobs)
    assert len(rt.ops_list) == len(rj.ops_list)
    for x, y in zip(rt.ops_list, rj.ops_list):
        assert x[0] == y[0] and all(np.array_equal(u, v) for u, v in zip(x[1:], y[1:]))
    for f in ("inst", "det", "prob", "occ_spp", "n_bbs_per_spp"):
        assert np.array_equal(getattr(rt, f), getattr(rj, f)), f
    assert tp._job_buckets(rt.jobs, cfg) == jp._job_buckets(rj.jobs, cfg)
    for (tbk, qbk), idxs in tp._job_buckets(rt.jobs, cfg).items():
        for j in idxs:
            for x, y in zip(tp._subsampled_job_rows(rt.jobs[j], tbk, qbk, j),
                            jp._subsampled_job_rows(rj.jobs[j], tbk, qbk, j)):
                assert np.array_equal(x, y)
    tp.reset_overflow_stats()
    jp.reset_overflow_stats()
    tp._count_overflows(rt.jobs, cfg)
    jp._count_overflows(rj.jobs, cfg)
    assert tp.OVERFLOW_STATS == jp.OVERFLOW_STATS and sum(tp.OVERFLOW_STATS.values()) > 0


def _fake_posterior(job):
    """A deterministic numpy function of the job's rows."""
    ii = np.asarray(job.intersect_inds, np.int64)
    salt = len(job.b1_inds) * 13 + len(job.b2_inds) * 29
    probs = (((ii * 7 + salt) % 101) / 101.0).astype(np.float32)
    labels = probs >= 0.5
    probs_new = np.where(labels, probs, np.float32(1.0) - probs)
    mu = (probs * 4.0 - 2.0).astype(np.float32)
    var = (0.05 + (ii % 7) * 0.05).astype(np.float32)
    return probs, probs_new, labels, mu, var


def _fake_fit_jobs_batched(jobs, feats_spp, cfg):
    return [_fake_posterior(j) for j in jobs]


@pytest.mark.parametrize("seed,walls", [(0, False), (1, True), (2, True)])
def test_writeback_matches_jax_bit_for_bit(seed, walls, monkeypatch):
    monkeypatch.setattr(jp, "_fit_jobs_batched", _fake_fit_jobs_batched)
    monkeypatch.setattr(tp, "_fit_jobs_batched", _fake_fit_jobs_batched)
    kw = _random_scene(seed, walls=walls)
    want = jp.generate_scene_labels(**kw)
    got = tp.generate_scene_labels(device="cpu", **kw)
    assert len(got) == len(want) == 6
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert (got[3] != -100).any()  # some superpoints were written by a fit


def test_stream_matches_jax():
    scenes = [_synthetic(s) for s in range(4)]
    scenes[1]["wall_box"], scenes[1]["wall_box_volume"] = _walls(scenes[1]["coords"])
    runs = {}
    for name, mod, kw in (("jax", jp, dict(devices=[jax.devices()[0]])),
                          ("torch", tp, dict(device="cpu"))):
        with chip_smoke.record_fits(mod, {}) as rec:
            out = list(mod.generate_scene_labels_stream(iter(scenes), window=2, **kw))
        assert [s is t for (s, _), t in zip(out, scenes)] == [True] * 4
        rec["labels"] = [labels for _, labels in out]
        runs[name] = rec
    numbers, bad = chip_smoke.labeler_gate(runs["torch"], runs["jax"], window=2)
    assert not bad, (bad, numbers)
    assert numbers["jobs"] > 10 and numbers["confident"] > 0
