"""GaPro's self-training loop on the port's CLIs, against the JAX tools.

On a writable copy of ``tests/fixtures/scannetv2`` (the directories
linked, the tiny ISBNet configuration pointed at it, validated on its
``train`` scene), with the same redrawn weights in both packages (the JAX
tools read them from a JAX checkpoint, the port's from its own):

* ``export_features``: the per-point mask-tower features of each package's
  ``export_features`` within 1e-4 of their scale (fp32 sums in another
  order through the U-Net and the tower, as ``tests/test_torch_isbnet.py``
  holds the forward);
* ``--save_pointwise``: the port's test CLI's ``semantic_pred/``,
  ``offset_pred/`` and ``offset_vertices_pred/`` files against the JAX
  CLI's: the same names, shapes and dtypes, the semantics equal, the
  offsets within 1e-4 of their scale;
* the round trip of ``tests/test_selftrain_roundtrip.py`` on the port's
  CLIs, each ``main(argv)`` called in this process: export ->
  ``gen_ps --use_deepfeat`` -> one training epoch on the labels it wrote.
"""

import os
import os.path as osp
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from gapro_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from gapro_tpu_torch import convert
from gapro_tpu_torch.data.dataset import ScanNetDataset, VoxelCfg
from gapro_tpu_torch.data.scannet_io import load_pseudo_labels, load_scene
from gapro_tpu_torch.tools import export_features, gen_ps
from gapro_tpu_torch.tools import test as port_test
from gapro_tpu_torch.tools import train as port_train
from gapro_tpu_torch.train.config import load_config

from tests.test_torch_isbnet import _randomize

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIX = osp.join(ROOT, "tests", "fixtures", "scannetv2")
SCAN = "scene0000_00"
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The port's CPU work here on two threads: the test workers share the
    machine's cores, and torch's default of one thread a core each
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(monkeypatch, name, *args):
    """Run the JAX package's ``tools/<name>.py`` as its command line does,
    in this process."""
    monkeypatch.setattr(sys, "argv", [name + ".py", *args])
    runpy.run_path(osp.join(ROOT, "tools", name + ".py"), run_name="__main__")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The data root, the tiny configuration on it, and one set of redrawn
    weights saved as both packages' checkpoints."""
    tmp = tmp_path_factory.mktemp("selftrain")
    droot = tmp / "scannetv2"
    droot.mkdir()
    for sub in ("train", "val", "superpoints", "scans_transform", "scannet_planes"):
        os.symlink(osp.join(FIX, sub), droot / sub)
    text = open(osp.join(ROOT, "configs", "tiny_synthetic.yaml")).read()
    for old, new in (("data_root: dataset/scannetv2", f"data_root: {droot}"),
                     ("prefix_val: val", "prefix_val: train"),
                     ("label_type: null", "label_type: gp_deepfeat_ps"),
                     ("min_npoint: 500", "min_npoint: 10")):
        assert old in text
        text = text.replace(old, new)
    config = str(tmp / "cfg.yaml")
    with open(config, "w") as f:
        f.write(text)
    cfg = load_config(config)
    model, _ = port_train.build_model(cfg, "cpu")
    variables = jax.tree_util.tree_map(np.asarray,
                                       _randomize(convert.to_flax_variables(model), seed=3))
    jax_ck = jax_save_checkpoint(str(tmp / "jax_ck"), variables, epoch=1)
    convert.load_flax_variables(model, variables)
    port_ck = str(tmp / "port_ck")
    torch.save(dict(model=model.state_dict()), port_ck)
    return dict(tmp=tmp, droot=droot, config=config, cfg=cfg, jax_ck=jax_ck, port_ck=port_ck)


def test_export_features_matches_jax(setup, monkeypatch):
    """Each package's per-point features of the fixture's scene."""
    tmp = setup["tmp"]
    _jax_tool(monkeypatch, "export_features", setup["config"], setup["jax_ck"], "--save_dir",
              str(tmp / "jax_feats"))
    export_features.main([setup["config"], setup["port_ck"], "--save_dir",
                          str(tmp / "port_feats"), "--device", "cpu"])
    load = lambda d: np.asarray(torch.load(osp.join(d, SCAN + ".pth"), weights_only=False))
    want, got = load(tmp / "jax_feats"), load(tmp / "port_feats")
    n = len(load_scene(osp.join(FIX, "train", SCAN + "_inst_nostuff.pth"))[0])
    assert got.dtype == np.float32 and got.shape == want.shape == (n, 8)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= TOL * scale


def test_save_pointwise_matches_jax(setup, monkeypatch):
    """The port's ``--save_pointwise`` files against the JAX CLI's."""
    tmp = setup["tmp"]
    _jax_tool(monkeypatch, "test", setup["config"], setup["jax_ck"], "--save_pointwise",
              str(tmp / "jax_pw"), "--no_eval")
    port_test.main([setup["config"], setup["port_ck"], "--save_pointwise", str(tmp / "port_pw"),
                    "--no_eval", "--device", "cpu"])
    for sub, dtype, width in (("semantic_pred", np.int32, None), ("offset_pred", np.float32, 3),
                              ("offset_vertices_pred", np.float32, 6)):
        assert os.listdir(tmp / "port_pw" / sub) == os.listdir(tmp / "jax_pw" / sub) == \
            [SCAN + ".npy"]
        want = np.load(tmp / "jax_pw" / sub / (SCAN + ".npy"))
        got = np.load(tmp / "port_pw" / sub / (SCAN + ".npy"))
        assert got.dtype == want.dtype == dtype and got.shape == want.shape, sub
        assert (got.ndim == 1) if width is None else (got.shape[1] == width), sub
        if width is None:
            np.testing.assert_array_equal(got, want)
        else:
            assert float(np.abs(got - want).max()) <= TOL * max(1.0, float(np.abs(want).max()))


def test_selftrain_roundtrip_on_port_clis(setup):
    """export -> ``gen_ps --use_deepfeat`` -> one training epoch on the
    written labels, as ``tests/test_selftrain_roundtrip.py`` runs the JAX
    CLIs."""
    tmp, droot = setup["tmp"], setup["droot"]
    feats = str(tmp / "roundtrip_feats")
    export_features.main([setup["config"], setup["port_ck"], "--save_dir", feats,
                          "--device", "cpu"])
    xyz = load_scene(osp.join(FIX, "train", SCAN + "_inst_nostuff.pth"))[0]
    f = np.asarray(torch.load(osp.join(feats, SCAN + ".pth"), weights_only=False))
    assert f.shape == (len(xyz), 8) and np.isfinite(f).all()

    ps_dir = droot / "gp_deepfeat_ps"
    assert gen_ps.main(["--data_root", str(droot), "--split", "train", "--save_folder",
                        str(ps_dir), "--use_deepfeat", "--deepfeat_folder", feats,
                        "--training_iter", "5", "--eval_pslabel", "--device", "cpu"]) == 0
    sem, inst, prob, mu, var = load_pseudo_labels(str(ps_dir / (SCAN + ".pth")))
    assert len(sem) == len(inst) == len(prob) == len(xyz)
    assert np.isfinite(mu).all() and np.isfinite(var).all()
    assert ((var >= 0) | (var == -100)).all() and (inst >= 0).any()
    item = ScanNetDataset(str(droot), prefix="train", training=True, label_type="gp_deepfeat_ps",
                          voxel_cfg=VoxelCfg(scale=20, max_npoint=50000, min_npoint=10)).load(0)
    np.testing.assert_array_equal(item["instance"], inst)
    assert item["mu"].shape == (len(xyz),)

    work = str(tmp / "run")
    port_train.main([setup["config"], "--work_dir", work, "--epochs", "1", "--batch_size", "1",
                     "--skip_validate", "--device", "cpu"])
    lines = open(osp.join(work, "metrics.jsonl")).read().strip().splitlines()
    assert len(lines) == 1 and "kl_loss" in lines[0]
