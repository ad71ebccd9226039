"""The port's pseudo-label metrics (``gapro_tpu_torch/eval/pseudo.py``) and
``utils/rle.py:rle_encode`` against the JAX package's, on the same numpy
labels made from a seed: the mIoU, the confusion matrix, the prediction
records and the RLE exactly, the AP dictionary equal. ``gen_ps``'s
semantic remap is held against the JAX CLI's real-data remap
(``tools/gen_ps.py:151-153``), and its deviation from the JAX CLI's
synthetic branch (``tools/gen_ps.py:81-83``) is pinned down.
"""

import math

import numpy as np
import pytest

import gapro_tpu.eval.pseudo as jps
from gapro_tpu.data import make_synthetic_scene
from gapro_tpu.utils.rle import rle_encode as j_rle_encode
import gapro_tpu_torch.eval.pseudo as tps
from gapro_tpu_torch.tools.gen_ps import gt_training_semantics
from gapro_tpu_torch.utils.rle import rle_decode, rle_encode


def _masks():
    rng = np.random.default_rng(0)
    out = [rng.random(n) < p for n, p in ((1000, 0.5), (1000, 0.02), (777, 0.98), (1, 1.0))]
    edges = np.zeros(50, bool)
    edges[:3] = edges[-4:] = True
    return out + [edges, np.zeros(40, bool), np.ones(40, bool), np.zeros(0, bool)]


@pytest.mark.parametrize("i", range(len(_masks())))
def test_rle_encode_matches_jax(i):
    mask = _masks()[i]
    got, want = rle_encode(mask), j_rle_encode(mask)
    assert got["length"] == want["length"]
    assert got["counts"].dtype == want["counts"].dtype
    assert np.array_equal(got["counts"], want["counts"])
    assert np.array_equal(rle_decode(got), mask)


def _labels(seed, kind="normal"):
    """GT (remapped semantics, instances) of a synthetic room and pseudo
    labels made from them: some points moved to another instance, some
    instances of another class, some points ignored."""
    s = make_synthetic_scene(seed=seed, n_objects=6, points_per_object=300, n_floor=800,
                             n_wall=400)
    rng = np.random.default_rng(seed)
    sem = gt_training_semantics(s.semantic_label)
    inst = s.instance_label.copy()
    ps_inst = inst.copy()
    move = rng.random(len(inst)) < 0.15
    ps_inst[move] = rng.integers(-1, inst.max() + 2, move.sum())
    ps_inst[ps_inst < 0] = -100
    cls = rng.integers(0, 19, ps_inst.max() + 1)
    keep = rng.random(len(cls)) < 0.7
    ps_sem = np.where(ps_inst >= 0, cls[np.maximum(ps_inst, 0)], 18)
    own = ps_inst >= 0
    ps_sem[own & keep[np.maximum(ps_inst, 0)]] = sem[own & keep[np.maximum(ps_inst, 0)]]
    ps_sem[rng.random(len(ps_sem)) < 0.03] = -100
    if kind == "no_gt":
        inst = np.full_like(inst, -100)
    elif kind == "no_pseudo":
        ps_inst = np.full_like(ps_inst, -100)
    return sem.astype(np.int32), inst.astype(np.int32), ps_sem.astype(np.int32), \
        ps_inst.astype(np.int32)


CASES = [(0, "normal"), (1, "normal"), (2, "no_gt"), (3, "no_pseudo")]


@pytest.mark.parametrize("seed,kind", CASES)
def test_miou_and_confusion_match_jax(seed, kind):
    sem, inst, ps_sem, ps_inst = _labels(seed, kind)
    got = tps.pseudo_label_miou_scene(sem, inst, ps_sem, ps_inst)
    want = jps.pseudo_label_miou_scene(sem, inst, ps_sem, ps_inst)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for n in (18, 19, 20):
        assert np.array_equal(tps.semantic_confusion(sem, ps_sem, n),
                              jps.semantic_confusion(sem, ps_sem, n))
    if kind == "normal":
        assert len(got) and 0.0 < got.mean() < 1.0


@pytest.mark.parametrize("seed,kind", CASES)
def test_predictions_match_jax(seed, kind):
    _, _, ps_sem, ps_inst = _labels(seed, kind)
    got = tps.pseudo_labels_as_predictions(ps_sem, ps_inst, "s0007")
    want = jps.pseudo_labels_as_predictions(ps_sem, ps_inst, "s0007")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert {k: g[k] for k in ("scan_id", "label_id", "conf")} == \
            {k: w[k] for k in ("scan_id", "label_id", "conf")}
        assert g["pred_mask"]["length"] == w["pred_mask"]["length"]
        assert np.array_equal(g["pred_mask"]["counts"], w["pred_mask"]["counts"])


def _same(g, w, where="") -> None:
    """Equal nested dictionaries of numbers (NaN equal to NaN)."""
    if isinstance(w, dict):
        assert isinstance(g, dict) and set(g) == set(w), where
        for k in w:
            _same(g[k], w[k], f"{where}/{k}")
    else:
        assert g == w or (math.isnan(g) and math.isnan(w)), (where, g, w)


def test_pseudo_label_ap_matches_jax():
    scenes = [_labels(seed) for seed in range(3)]
    want = jps.pseudo_label_ap(scenes)
    _same(tps.pseudo_label_ap(scenes), want)
    assert 0.0 < want["all_ap_50%"] <= 1.0


def test_training_semantics_remap():
    """``gt_training_semantics`` is the JAX CLI's real-data remap
    (``tools/gen_ps.py:151-153``, copied here); the JAX CLI's synthetic
    branch (``tools/gen_ps.py:81-83``) also sends raw classes 2 and 3 to
    background, and the port's ``--synthetic`` does not."""
    raw = np.array([-100, 0, 1, 2, 3, 4, 10, 19], np.int64)
    want = raw.copy()
    want[want != -100] -= 2
    want[(want == -1) | (want == -2)] = 18
    got = gt_training_semantics(raw)
    assert np.array_equal(got, want)
    assert got.tolist() == [-100, 18, 18, 0, 1, 2, 8, 17]
    jax_synthetic = raw.copy()
    jax_synthetic[jax_synthetic >= 2] -= 2
    jax_synthetic[(jax_synthetic == 0) | (jax_synthetic == 1)] = 18
    assert jax_synthetic.tolist() == [-100, 18, 18, 18, 18, 2, 8, 17]
