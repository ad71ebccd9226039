"""The port's visualization CLI (``gapro_tpu_torch/tools/visualization.py``)
against the JAX tool (``tools/visualization.py``, run in this process as
its command line runs it): each of the eight tasks in PLY and in HTML,
the two files byte for byte equal.

* ``--synthetic 1``: the tasks that read the scene alone (``input_rgb``,
  ``semantic_gt``, ``instance_gt``, ``superpoint``);
* a synthetic scene written to a data root in ScanNet's layout
  (``val/<scan>_inst_nostuff.pth``, ``superpoints/<scan>.pth``): all eight
  tasks, the predictions from the port's test CLI on the tiny
  configuration (``--out``, the benchmark export ``export_benchmark``
  writes, and ``--save_pointwise``), ``instance_pred`` at a
  ``--conf_thresh`` between the exported confidences, so that masks lie on
  both sides of it.
"""

import os
import os.path as osp
import runpy
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gapro_tpu_torch.data import make_synthetic_scene
from gapro_tpu_torch.tools import test as port_test
from gapro_tpu_torch.tools import train as port_train
from gapro_tpu_torch.tools import visualization
from gapro_tpu_torch.train.config import load_config
from gapro_tpu_torch.utils.rle import rle_encode

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
SCAN = "scene0000_00"
SCENE_TASKS = ("input_rgb", "semantic_gt", "instance_gt", "superpoint")
FORMATS = ("ply", "html")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["visualization.py", *args])
    runpy.run_path(osp.join(ROOT, "tools", "visualization.py"), run_name="__main__")


@pytest.fixture(scope="module")
def scannet(tmp_path_factory):
    """A data root holding one synthetic scene in ScanNet's layout, the
    tiny configuration on it, and the port's test CLI's exports of it."""
    tmp = tmp_path_factory.mktemp("vis")
    droot = tmp / "scannetv2"
    for sub in ("val", "superpoints"):
        (droot / sub).mkdir(parents=True)
    s = make_synthetic_scene(seed=1, n_objects=4, points_per_object=400, n_floor=800,
                             n_wall=500)
    torch.save((s.xyz, s.rgb, s.semantic_label.astype(np.int64),
                s.instance_label.astype(np.int64)),
               droot / "val" / f"{SCAN}_inst_nostuff.pth")
    torch.save(np.asarray(s.spp, np.int64), droot / "superpoints" / f"{SCAN}.pth")
    text = open(osp.join(ROOT, "configs", "tiny_synthetic.yaml")).read()
    for old, new in (("data_root: dataset/scannetv2", f"data_root: {droot}"),
                     ("min_npoint: 500", "min_npoint: 10")):
        assert old in text
        text = text.replace(old, new)
    config = str(tmp / "cfg.yaml")
    with open(config, "w") as f:
        f.write(text)
    # untrained box confidences all lie below 0, where the scores clip to 0
    # and no instance is kept: raise the conf head's bias, as chip_smoke.py
    # does (CONF_SHIFT)
    model, _ = port_train.build_model(load_config(config), "cpu")
    with torch.no_grad():
        model.inst_conf_head.dense2.bias += chip_smoke.CONF_SHIFT
    ck = str(tmp / "ck")
    torch.save(dict(model=model.state_dict()), ck)
    preds = tmp / "preds"
    port_test.main([config, ck, "--out", str(preds), "--save_pointwise", str(preds), "--no_eval",
                    "--device", "cpu"])
    confs = sorted(float(ln.split()[2]) for ln in open(preds / f"{SCAN}.txt").read().splitlines()
                   if ln)
    assert len(confs) >= 2 and confs[0] < confs[-1], confs
    return dict(tmp=tmp, droot=str(droot), preds=str(preds), n=len(s.xyz),
                instances=len(np.unique(s.instance_label[s.instance_label >= 0])),
                thresh=(confs[len(confs) // 2 - 1] + confs[len(confs) // 2]) / 2)


def _both(monkeypatch, out, args):
    """The JAX tool's and the port's file for ``args``."""
    _jax_tool(monkeypatch, *args, "--out", str(out / "jax"))
    got = visualization.main([*args, "--out", str(out / "port")])
    want = osp.join(out, "jax", osp.basename(got))
    assert osp.isfile(want), want
    return open(got, "rb").read(), open(want, "rb").read()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("task", SCENE_TASKS)
def test_synthetic_scene_byte_equal(tmp_path, monkeypatch, task, fmt):
    got, want = _both(monkeypatch, tmp_path, ["--synthetic", "1", "--task", task, "--format", fmt])
    assert got == want


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("task", visualization.TASKS)
def test_scannet_scene_byte_equal(scannet, tmp_path, monkeypatch, task, fmt):
    args = ["--data_root", scannet["droot"], "--scene", SCAN, "--task", task, "--format", fmt,
            "--prediction_path", scannet["preds"], "--conf_thresh", str(scannet["thresh"])]
    got, want = _both(monkeypatch, tmp_path, args)
    assert got == want
    if fmt == "ply":  # offset_vertices_pred adds each instance's box, 12 edges x 24 points
        n = int(got.split(b"element vertex ")[1].split(b"\n")[0])
        boxes = 12 * 24 * scannet["instances"] if task == "offset_vertices_pred" else 0
        assert n == scannet["n"] + boxes


def test_instance_pred_marks_the_masks_over_the_threshold(scannet):
    """``instance_pred``'s ids: exactly the points of the exported masks at
    or above ``--conf_thresh``, the later mask winning a shared point."""
    preds = scannet["preds"]
    lines = [ln.split() for ln in open(osp.join(preds, f"{SCAN}.txt")).read().splitlines() if ln]
    ids = visualization.instance_ids(preds, SCAN, scannet["n"], scannet["thresh"])
    want = np.full(scannet["n"], -1)
    kept = [rel for rel, _, conf in lines if float(conf) >= scannet["thresh"]]
    for k, rel in enumerate(kept):
        want[np.loadtxt(osp.join(preds, rel)).astype(bool)] = k
    assert 0 < len(kept) < len(lines)
    np.testing.assert_array_equal(ids, want)
    assert sorted(os.listdir(osp.join(preds, "pred_mask"))) == sorted(
        osp.basename(rel) for rel, _, _ in lines)


def test_export_benchmark_byte_equal_jax(tmp_path):
    """The test CLI's benchmark export, which ``instance_pred`` reads: the
    port's ``export_benchmark`` (each mask written in one pass) against the
    JAX CLI's (``np.savetxt``), file for file and byte for byte, masks with
    no point and with every point among them."""
    jax_export = runpy.run_path(osp.join(ROOT, "tools", "test.py"))["export_benchmark"]
    rng = np.random.default_rng(0)
    n = 5000
    masks = [rng.random(n) < p for p in (0.3, 0.0, 1.0, 0.01)]
    insts = [dict(pred_mask=rle_encode(m), label_id=int(rng.integers(0, 18)),
                  conf=float(rng.random())) for m in masks]
    port_test.export_benchmark(str(tmp_path / "port"), SCAN, insts, n)
    jax_export(str(tmp_path / "jax"), SCAN, insts, n)
    files = sorted(osp.relpath(osp.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 1 + len(masks)
    for rel in files:
        assert open(tmp_path / "port" / rel, "rb").read() == \
            open(tmp_path / "jax" / rel, "rb").read(), rel
