"""The port's train and test CLIs (``gapro_tpu_torch/tools``) on the CPU,
on the tiny synthetic configuration: what the train CLI writes, exact
resumption, the checkpoints' retention and partial loads, the test CLI's
AP line, and the full-width configuration ``chip_smoke.py`` builds in code
(the card's machine has no PyYAML) against its YAML."""

import json
import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from gapro_tpu_torch.data.dataset import SyntheticDataset
from gapro_tpu_torch.tools import train as port_train
from gapro_tpu_torch.train import checkpoint
from gapro_tpu_torch.train.config import AttrDict, load_config
from gapro_tpu_torch.train.state import create_train_state

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(ROOT, "configs", "tiny_synthetic.yaml")
SMALL = dict(n_objects=3, points_per_object=300, n_floor=400, n_wall=300)


def _cli(module, *args):
    r = subprocess.run([sys.executable, "-m", f"gapro_tpu_torch.tools.{module}", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("cli") / "run")
    _cli("train", TINY, "--synthetic", "2", "--epochs", "2", "--device", "cpu",
         "--work_dir", work)
    return work


def test_train_cli_writes_checkpoints_and_metrics(cli_run):
    for name in ("best", "latest", "epoch_00001", "epoch_00002", "train.log"):
        assert osp.exists(osp.join(cli_run, name)), name
    assert os.readlink(osp.join(cli_run, "latest")) == "epoch_00002"
    lines = [json.loads(x) for x in open(osp.join(cli_run, "metrics.jsonl"))]
    assert [r["epoch"] for r in lines] == [1, 2]
    for rec in lines:
        for k in ("dice_loss", "bce_loss", "cls_loss", "loss", "ovf_spp_slots", "val_ap",
                  "val_ap50", "val_ap25"):
            assert k in rec and np.isfinite(rec[k]), (k, rec)
    ck = checkpoint.load_checkpoint(osp.join(cli_run, "latest"))
    assert ck["epoch"] == 2 and ck["step"] == 2
    assert {"model", "optimizer"} <= set(ck)


def test_test_cli_prints_ap(cli_run, tmp_path):
    out = str(tmp_path / "bench")
    r = _cli("test", TINY, osp.join(cli_run, "best"), "--synthetic", "2", "--device", "cpu",
             "--out", out)
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert {"all_ap", "all_ap_50%", "all_ap_25%", "all_rc"} <= set(res)
    assert "classes" not in res
    assert osp.exists(osp.join(out, "synthetic0000.txt"))


def _tiny_cfg(epochs):
    cfg = load_config(TINY)
    cfg.train["epochs"] = epochs
    return cfg


def _dataset(cfg):
    return SyntheticDataset(n_scenes=4, training=True, voxel_cfg=port_train.voxel_cfg(cfg),
                            **SMALL)


def test_resume_is_exact(tmp_path):
    """Resuming restores the weights, BatchNorm statistics, optimizer state,
    step and epoch exactly, and the resumed run goes on at the next epoch.
    (Two runs from the same start are not compared: the CPU's scatter-adds
    in the backward sum in a thread-dependent order.)"""
    cfg = _tiny_cfg(1)
    first = port_train.train(cfg, str(tmp_path / "a"), device="cpu", dataset=_dataset(cfg),
                             skip_validate=True)
    model, _ = port_train.build_model(cfg, "cpu", seed=5)
    st = create_train_state(model, lr=1.0, weight_decay=cfg.train.weight_decay)
    assert port_train.restore(str(tmp_path / "a" / "latest"), st) == 1
    assert st.step == first["state"].step == 2
    want = first["model"].state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    got_opt, want_opt = st.optimizer.state_dict(), first["state"].optimizer.state_dict()
    assert got_opt["param_groups"] == want_opt["param_groups"]
    for i, s in want_opt["state"].items():
        for k, v in s.items():
            assert torch.equal(torch.as_tensor(got_opt["state"][i][k]), torch.as_tensor(v)), (i, k)

    cfg2 = _tiny_cfg(2)
    resumed = port_train.train(cfg2, str(tmp_path / "a"), device="cpu", dataset=_dataset(cfg2),
                               skip_validate=True, resume=str(tmp_path / "a" / "latest"))
    assert [r["epoch"] for r in resumed["records"]] == [2] and resumed["state"].step == 4
    assert os.readlink(str(tmp_path / "a" / "latest")) == "epoch_00002"


def test_retention_and_partial_load(tmp_path):
    """Epochs that are neither a power of two nor a multiple of save_freq
    are pruned when the next one is written; a partial load keeps the
    target's entries that the file lacks or shapes otherwise."""
    work = str(tmp_path / "ck")
    w = torch.arange(6.0).reshape(2, 3)
    for e in range(1, 7):
        checkpoint.save_checkpoint(work, dict(model={"w": w * e}, epoch=e), e, save_freq=4,
                                   best=(e == 3))
    kept = sorted(f for f in os.listdir(work) if f.startswith("epoch_"))
    assert kept == ["epoch_00001", "epoch_00002", "epoch_00004", "epoch_00006"]
    assert checkpoint.load_checkpoint(osp.join(work, "latest"))["epoch"] == 6
    assert torch.equal(checkpoint.load_checkpoint(osp.join(work, "best"))["model"]["w"], w * 3)

    cfg = _tiny_cfg(1)
    src, _ = port_train.build_model(cfg, "cpu", seed=1)
    dst, _ = port_train.build_model(cfg, "cpu", seed=2)
    sd = src.state_dict()
    wrong, missing = "controller.weight", "semantic_linear.dense1.bias"
    sd[wrong] = sd[wrong][:-1]
    del sd[missing]
    torch.save(dict(model=sd), str(tmp_path / "partial"))
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    checkpoint.load_model_weights(str(tmp_path / "partial"), dst)
    for k, v in dst.state_dict().items():
        assert torch.equal(v, before[k] if k in (wrong, missing) else sd[k]), k


def test_unported_options_raise():
    cfg = _tiny_cfg(1)
    cfg.model["semantic_only"] = True
    with pytest.raises(NotImplementedError):
        port_train.build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError):
        port_train.main([TINY, "--dp", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError):
        port_train.main([TINY, "--only_backbone", "--device", "cpu"])


def test_in_code_full_width_config_equals_yaml():
    assert AttrDict.wrap(chip_smoke.ISBNET_SCANNETV2) == load_config(
        osp.join(ROOT, "configs", "isbnet_scannetv2.yaml"))
