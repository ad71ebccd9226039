"""The port's train and test CLIs (``gapro_tpu_torch/tools``) on the CPU,
on the tiny synthetic configurations: what the train CLI writes, exact
resumption, the checkpoints' retention and partial loads, the test CLI's
AP line, ISBNet's two stages (``--only_backbone``, then ``--pretrain``),
SPFormer's train and test CLIs with box AP, ``--dp`` (no option of the
JAX CLI raises now), and the full-width configurations ``chip_smoke.py`` builds in code (the
card's machine has no PyYAML) against their YAML."""

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
TINY_SPF = osp.join(ROOT, "configs", "tiny_spformer_synthetic.yaml")
SMALL = dict(n_objects=3, points_per_object=300, n_floor=400, n_wall=300)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The port's CPU work here on two threads (and two in each CLI process,
    ``_cli``): the test workers share the machine's cores, and torch's
    default of one thread a core each oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cli(module, *args):
    r = subprocess.run([sys.executable, "-m", f"gapro_tpu_torch.tools.{module}", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, OMP_NUM_THREADS="2"))
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


@pytest.mark.parametrize("option", ["dp"])
def test_unported_options_raise(option, tmp_path, monkeypatch):
    """Every option of the JAX CLI is ported and none raises
    ``NotImplementedError``: ``--dp 2`` hands the run to the data-parallel
    trainer with 2 ranks (``tests/test_torch_dp.py`` runs it, and holds its
    step and the CLI's rules)."""
    calls = []
    monkeypatch.setattr(port_train, "train_dp", lambda cfg, work_dir, dp, **kw: calls.append(
        (dp, kw["device"], kw["synthetic"])))
    port_train.main([TINY, "--dp", "2", "--synthetic", "2", "--device", "cpu", "--work_dir",
                     str(tmp_path / option)])
    assert calls == [(2, "cpu", 2)]


@pytest.fixture(scope="module")
def backbone_run(tmp_path_factory):
    """``--only_backbone`` on the tiny configuration with a
    ``criterion.semantic_only`` key (False): the CLI sets it, as the JAX CLI
    does, and trains the backbone stage for two epochs."""
    tmp = tmp_path_factory.mktemp("backbone")
    text = open(TINY).read().replace("criterion:\n", "criterion:\n  semantic_only: False\n", 1)
    assert "semantic_only: False\n  instance_classes" in text
    config = str(tmp / "tiny_backbone.yaml")
    with open(config, "w") as f:
        f.write(text)
    work = str(tmp / "run")
    _cli("train", config, "--only_backbone", "--synthetic", "2", "--epochs", "2", "--device",
         "cpu", "--work_dir", work)
    return work


def test_only_backbone_trains_and_validates_by_miou(backbone_run):
    lines = [json.loads(x) for x in open(osp.join(backbone_run, "metrics.jsonl"))]
    assert [r["epoch"] for r in lines] == [1, 2]
    for rec in lines:
        assert set(rec) >= {"pw_sem_loss", "pw_corners_loss", "pw_giou_loss", "pw_conf_loss",
                            "loss", "val_miou", "val_acc", "val_offset_mae"}, rec
        assert "dice_loss" not in rec and "val_ap" not in rec
        assert all(np.isfinite(v) for v in rec.values())
    best = max(lines, key=lambda r: r["val_miou"])
    ck = checkpoint.load_checkpoint(osp.join(backbone_run, "best"))
    assert ck["epoch"] == best["epoch"]
    assert {k.split(".")[0] for k in ck["model"]} == {
        "backbone", "semantic_linear", "offset_vertices_linear", "box_conf_linear"}


def test_pretrain_loads_exactly_the_shared_keys(backbone_run, tmp_path):
    """The full stage started from the backbone checkpoint: every key the
    two models share takes the checkpoint's value (BatchNorm statistics
    included), every other key keeps its initial value; and the train CLI
    loads it through ``--pretrain``."""
    ck = checkpoint.load_checkpoint(osp.join(backbone_run, "best"))["model"]
    model, _ = port_train.build_model(_tiny_cfg(1), "cpu", seed=3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    checkpoint.load_model_weights(osp.join(backbone_run, "best"), model)
    after = model.state_dict()
    shared = set(ck) & set(after)
    assert shared == set(ck) and len(set(after) - shared) > 0
    for k, v in after.items():
        assert torch.equal(v, ck[k] if k in shared else before[k]), k
    work = str(tmp_path / "full")
    _cli("train", TINY, "--synthetic", "2", "--epochs", "1", "--device", "cpu",
         "--pretrain", osp.join(backbone_run, "best"), "--work_dir", work)
    log = open(osp.join(work, "train.log")).read()
    assert "loaded pretrain" in log
    assert f"kept {len(set(after) - shared)} target entries" in log


def test_only_backbone_without_the_criterion_key_raises(tmp_path):
    """``configs/tiny_synthetic.yaml`` has no ``criterion.semantic_only``:
    ``--only_backbone`` then leaves the criterion's flag False, as the JAX
    CLI does, and the first step raises where the JAX package fails (it
    looks for ``sp_dense_idx`` in a semantic_only model's outputs)."""
    with pytest.raises(ValueError, match="criterion.semantic_only"):
        port_train.main([TINY, "--only_backbone", "--synthetic", "2", "--epochs", "1",
                         "--device", "cpu", "--work_dir", str(tmp_path / "run")])


def test_spformer_train_and_test_clis(tmp_path):
    """SPFormer's tiny configuration trains two epochs (the poly schedule,
    validation by AP), and the test CLI prints the AP and the box AP lines."""
    work = str(tmp_path / "spf")
    _cli("train", TINY_SPF, "--synthetic", "2", "--epochs", "2", "--device", "cpu",
         "--work_dir", work)
    lines = [json.loads(x) for x in open(osp.join(work, "metrics.jsonl"))]
    assert [r["epoch"] for r in lines] == [1, 2]
    for rec in lines:
        for k in ("cls_loss", "bce_loss", "dice_loss", "score_loss", "levelset_loss", "kl_loss",
                  "loss", "ovf_spp_slots", "val_ap"):
            assert k in rec and np.isfinite(rec[k]), (k, rec)
    cfg = load_config(TINY_SPF)
    assert lines[1]["lr"] == pytest.approx(
        cfg.train.lr * 0.5 ** 0.9)  # poly: base * (1 - 1/2)^0.9, base batch 2
    r = _cli("test", TINY_SPF, osp.join(work, "best"), "--synthetic", "2", "--device", "cpu")
    ap, box = (json.loads(x) for x in r.stdout.strip().splitlines()[-2:])
    assert {"all_ap", "all_ap_50%", "all_ap_25%"} <= set(ap)
    assert {"box_all_ap", "box_all_ap_50%", "box_all_ap_25%"} <= set(box)


@pytest.mark.parametrize("name,yaml", [
    ("ISBNET_SCANNETV2", "isbnet_scannetv2.yaml"),
    ("ISBNET_BACKBONE_SCANNETV2", "isbnet_backbone_scannetv2.yaml"),
    ("SPFORMER_SCANNETV2", "spformer_scannetv2.yaml"),
    ("ISBNET_S3DIS", "isbnet_s3dis.yaml")])
def test_in_code_full_width_config_equals_yaml(name, yaml):
    assert AttrDict.wrap(getattr(chip_smoke, name)) == load_config(
        osp.join(ROOT, "configs", yaml))
