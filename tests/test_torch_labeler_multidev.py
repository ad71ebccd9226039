"""The port's GP labeler sweep across devices (``gapro_tpu_torch/labeler/
pipeline.py:generate_scene_labels_stream``), on the CPU.

* Three CPU devices, and ``batch_submit``, give the labels of one device:
  sem, inst and the superpoint map equal, prob, mu and var within 1e-4
  (``tests/test_labeler_multidev.py``'s bounds for the JAX stream). The
  fit groups and each job's row draw do not depend on the device list, so
  here they are in fact equal bit for bit; 1e-4 is the JAX test's bound.
* ``submit_scenes_batched``: each scene's pooled features and occupancy
  equal its ``submit_scene``'s, for scenes of two shape groups.
* The three-device sweep against the JAX stream over the 8-device CPU
  mesh, 3 scenes, 20 Adam steps: within ``chip_smoke.py:labeler_gate``'s
  bounds, as ``tests/test_torch_labeler.py`` holds the one-device sweep.

The card's test of the sweep is in ``tests/test_torch_card_tools.py``.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import gapro_tpu.labeler.pipeline as jp
from gapro_tpu.data.synthetic import make_synthetic_scene
from gapro_tpu.labeler import instance_info
import gapro_tpu_torch.labeler.pipeline as tp

CPU3 = [torch.device("cpu")] * 3


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The port's fits on one CPU thread, as in ``tests/test_torch_labeler.py``:
    CPU sums split by the thread team, and the Adam steps amplify it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scenes(n, seed0=0, n_floor=800):
    out = []
    for seed in range(seed0, seed0 + n):
        sc = make_synthetic_scene(seed=seed, n_objects=4, points_per_object=300, n_floor=n_floor,
                                  n_wall=500, room=5.0)
        _, cls, boxes, vols, _ = instance_info(sc.xyz, sc.instance_label, sc.semantic_label)
        out.append(dict(coords=sc.xyz, gp_feats=np.concatenate([sc.xyz, sc.rgb], 1),
                        spp=sc.spp, instance_cls=cls, instance_box=boxes,
                        instance_box_volume=vols))
    return out


def _stream(scenes, **kw):
    cfg = tp.LabelerConfig(training_iter=20)
    return [lab for _, lab in tp.generate_scene_labels_stream(iter(scenes), cfg, window=2, **kw)]


def _assert_same_labels(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in (0, 1, 5):  # sem, inst, the superpoint map
            np.testing.assert_array_equal(g[k], w[k])
        for a, b in zip(g[2:5], w[2:5]):  # prob, mu, var
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def five_scenes():
    scenes = _scenes(5)
    return scenes, _stream(scenes, device="cpu")


@pytest.mark.parametrize("kw", [dict(devices=CPU3), dict(devices=CPU3, batch_submit=True),
                                dict(device="cpu", batch_submit=True, submit_threads=1)],
                         ids=["three devices", "three devices, batch_submit",
                              "batch_submit, one thread"])
def test_stream_device_lists_give_one_devices_labels(five_scenes, kw):
    scenes, single = five_scenes
    _assert_same_labels(_stream(scenes, **kw), single)


def test_submit_scenes_batched_equals_submit_scene():
    cfg = tp.LabelerConfig()
    # two shape groups: three small scenes and one past the next point bucket
    scenes = _scenes(3) + _scenes(1, seed0=7, n_floor=3000)
    handles = tp.submit_scenes_batched(scenes, cfg, device="cpu")
    for kw, h in zip(scenes, handles):
        one = tp.submit_scene(cfg=cfg, device="cpu", **kw)
        assert (h.n_spps, h.n_boxes, h.n_fg) == (one.n_spps, one.n_boxes, one.n_fg)
        assert torch.equal(h.feats, one.feats)
        np.testing.assert_array_equal(h.occ.numpy(), one.occ.numpy())
        np.testing.assert_array_equal(h.spp_inverse, one.spp_inverse)


def test_multidevice_stream_matches_jax():
    scenes = _scenes(3)
    runs = {}
    for name, mod, kw in (("jax", jp, dict(devices=jax.devices())),
                          ("torch", tp, dict(devices=CPU3))):
        cfg = mod.LabelerConfig(training_iter=20)
        with chip_smoke.record_fits(mod, {}) as rec:
            out = list(mod.generate_scene_labels_stream(iter(scenes), cfg, window=2, **kw))
        rec["labels"] = [labels for _, labels in out]
        runs[name] = rec
    assert len(jax.devices()) >= 2
    numbers, bad = chip_smoke.labeler_gate(runs["torch"], runs["jax"], window=2)
    assert not bad, (bad, numbers)
    assert numbers["jobs"] > 0
