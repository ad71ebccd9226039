"""The port's ``gen_ps`` CLI (``gapro_tpu_torch/tools/gen_ps.py``) on the CPU.

On ``tests/fixtures/scannetv2`` (train split: scene0000_00 with its planes
and axis-align matrix) the saved 5-tuple is held against the JAX package's
``generate_scene_labels_stream`` on the same scene, within
``chip_smoke.py:labeler_gate``'s bounds (the fixture's boxes overlap
nowhere a fit would decide, so the two must agree exactly; the fits are
held in ``tests/test_torch_labeler.py``). ``--synthetic 1 --eval_pslabel
--eval_ap`` prints scenes/s and the mIoU and AP that the JAX package's
metrics give on the port's labels.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import gapro_tpu.eval.pseudo as jps
import gapro_tpu.labeler.pipeline as jp
from gapro_tpu.data import scannet_io as jio
from gapro_tpu.labeler import instance_info, wall_boxes_from_planes
import gapro_tpu_torch.labeler.pipeline as tp
from gapro_tpu_torch.data import scannet_io
from gapro_tpu_torch.tools import gen_ps

ROOT = Path(__file__).resolve().parent / "fixtures" / "scannetv2"
SCAN = "scene0000_00"


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


def _jax_scene():
    xyz, rgb, sem, inst = jio.load_scene(str(ROOT / "train" / f"{SCAN}_inst_nostuff.pth"))
    mat = jio.load_axis_align_matrix(str(ROOT / "scans_transform" / SCAN / f"{SCAN}.txt"))
    xyz = jio.apply_axis_align(xyz, mat)
    wall = wall_boxes_from_planes(jio.load_plane_quads(str(ROOT / "scannet_planes" /
                                                           f"{SCAN}.json")), mat)
    _, cls, boxes, vols, _ = instance_info(xyz, inst, sem, with_corners=False)
    return dict(coords=xyz, gp_feats=np.concatenate([xyz, rgb], 1),
                spp=jio.load_superpoints(str(ROOT / "superpoints" / f"{SCAN}.pth")),
                instance_cls=cls, instance_box=boxes, instance_box_volume=vols,
                wall_box=wall[1], wall_box_volume=wall[2])


def test_io_matches_jax(tmp_path):
    meta = str(ROOT / "scans_transform" / SCAN / f"{SCAN}.txt")
    mat = scannet_io.load_axis_align_matrix(meta)
    assert np.array_equal(mat, jio.load_axis_align_matrix(meta)) and not np.allclose(mat, np.eye(4))
    assert np.array_equal(scannet_io.load_axis_align_matrix(str(tmp_path / "none.txt")), np.eye(4))
    xyz = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    assert np.array_equal(scannet_io.apply_axis_align(xyz, mat), jio.apply_axis_align(xyz, mat))
    planes = str(ROOT / "scannet_planes" / f"{SCAN}.json")
    assert scannet_io.load_plane_quads(planes) == jio.load_plane_quads(planes)
    assert scannet_io.load_plane_quads(str(tmp_path / "none.json")) is None
    labels = (np.arange(5), -np.arange(5), np.linspace(0, 1, 5), np.ones(3), np.zeros(3))
    scannet_io.save_pseudo_labels(str(tmp_path / "a" / "x.pth"), *labels)
    jio.save_pseudo_labels(str(tmp_path / "b" / "x.pth"), *labels)
    for x, y in zip(scannet_io.load_pseudo_labels(str(tmp_path / "a" / "x.pth")),
                    jio.load_pseudo_labels(str(tmp_path / "b" / "x.pth"))):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_cli_real_data_matches_jax(tmp_path, capsys):
    save = tmp_path / "ps"
    with chip_smoke.record_fits(tp, {}) as got:
        assert gen_ps.main(["--data_root", str(ROOT), "--save_folder", str(save),
                            "--split", "train", "--device", "cpu", "--eval_pslabel"]) == 0
    out = capsys.readouterr().out
    assert f"{SCAN}: mIoU" in out and "scenes/sec" in out
    saved = scannet_io.load_pseudo_labels(str(save / f"{SCAN}.pth"))
    with chip_smoke.record_fits(jp, {}) as want:
        (_, labels), = jp.generate_scene_labels_stream(iter([_jax_scene()]),
                                                      devices=[jax.devices()[0]])
    want["labels"] = [labels]
    got["labels"] = [tuple(saved) + (labels[5],)]
    numbers, bad = chip_smoke.labeler_gate(got, want, window=4)
    assert not bad, (bad, numbers)
    assert [len(a) for a in saved] == [len(labels[0])] * 3 + [len(labels[3])] * 2
    # a second run finds the output and skips the scene
    assert gen_ps.main(["--data_root", str(ROOT), "--save_folder", str(save),
                        "--device", "cpu"]) == 0
    assert "scenes/sec" not in capsys.readouterr().out


def test_cli_synthetic_prints_ap_and_rate(capsys, monkeypatch):
    """The printed mIoU and AP are the JAX package's metrics
    (``gapro_tpu.eval.pseudo``) on the port's labels, under the port's
    semantic remap (``gen_ps.gt_training_semantics``; the JAX CLI's
    synthetic branch remaps otherwise, ``tests/test_torch_pseudo.py``)."""
    made = []

    def recorded(**kw):
        out = gen_ps_generate(**kw)
        made.append(out)
        return out

    gen_ps_generate = gen_ps.generate_scene_labels
    monkeypatch.setattr(gen_ps, "generate_scene_labels", recorded)
    assert gen_ps.main(["--synthetic", "1", "--device", "cpu", "--eval_pslabel",
                        "--eval_ap", "--training_iter", "20"]) == 0
    out = capsys.readouterr().out
    line = [s for s in out.splitlines() if "scenes/sec" in s]
    assert line and line[0].startswith("1 scenes in")
    (sem, inst, *_), = made
    scene = gen_ps.make_synthetic_scene(seed=0)
    gt_sem = gen_ps.gt_training_semantics(scene.semantic_label)
    ious = jps.pseudo_label_miou_scene(gt_sem, scene.instance_label, sem, inst)
    ap = jps.pseudo_label_ap([(gt_sem, scene.instance_label, sem, inst)])
    assert f"scene 0 ({len(scene.xyz)} pts): mIoU {np.mean(ious):.4f}" in out
    assert f"Mean instance iou of pseudo labels: {float(np.mean(ious)):.4f}" in out
    assert (f"Pseudo-label AP {ap['all_ap']:.4f} AP50 {ap['all_ap_50%']:.4f} "
            f"AP25 {ap['all_ap_25%']:.4f}") in out
    assert 0.0 < np.mean(ious) <= 1.0
