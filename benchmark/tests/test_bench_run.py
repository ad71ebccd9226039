"""The harness run at tiny widths on the CPU (its look for a chip skipped):
a sound run is correct; a run with the timed path broken underneath, or
the port's lower-precision path in its place, is not. The card's own
tests (marker ``gpu``) run the cells at their sizes:

    python -m pytest -p no:cacheprovider -m gpu benchmark/tests
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny

CPU = torch.device("cpu")
CELLS = ("isbnet_scannet.train", "spformer_scannet.train", "isbnet_scannet.infer")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 1.0, trace: int = 0):
    config, traffic = name.split(".")
    cell = dict(name=name, config=config, traffic=traffic, chips=1)
    return run.run_cell(cell, tiny.config(config), tiny.mix(traffic), tiny.manifest(), seed,
                        seconds, trace, CPU)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, checks = tiny_run(name)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", json.load(open(os.path.join(
        tiny.ROOT, "benchmark", "traffic", name.split(".")[1] + ".json")))["metric"]}


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_its_layers(name):
    result, _ = tiny_run(name, trace=1, seconds=2.0)
    assert result["correct"]
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    # the span-based metrics read on any device; device-trace ones need a card
    assert ("prepare_ms." + name.split(".")[1]) in result["metrics"]


def test_no_jax_module_is_loaded():
    code = ("import sys, torch; sys.path.insert(0, %r); torch.set_num_threads(2)\n"
            "from benchmark.tests.test_bench_run import tiny_run\n"
            "from benchmark.lib import harness\n"
            "tiny_run('isbnet_scannet.train'); tiny_run('isbnet_scannet.infer')\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(harness.loaded_forbidden(), 'gapro_tpu_torch' in tops)" % tiny.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tiny.ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def _half_batches(monkeypatch):
    """The loader's batches cut to their first half: half of each batch
    left out, the mean taken over the rest."""
    import gapro_tpu_torch.data.dataset as dataset
    from gapro_tpu_torch.models.prepare import points_to_batch_np

    orig = dataset.build_dataloader

    def halved(ds, batch_size=4, **kw):
        for lb in orig(ds, batch_size, **kw):
            h = max(1, lb.batch_size // 2)
            yield dataset.LoaderBatch(
                points=points_to_batch_np(lb.scenes[:h], voxel_scale=ds.voxel_cfg.scale),
                scan_ids=lb.scan_ids[:h], scenes=lb.scenes[:h], batch_size=h)

    monkeypatch.setattr(dataset, "build_dataloader", halved)


def _state_unchanged(monkeypatch):
    import gapro_tpu_torch.train.state as state

    monkeypatch.setattr(state.TrainState, "apply_gradients", lambda self, lr=None: self)


def _answer_altered(monkeypatch):
    import gapro_tpu_torch.eval.runner as runner

    orig = runner.infer_scene_instances

    def altered(*args, **kw):
        recs = orig(*args, **kw)
        if recs:
            recs[0] = dict(recs[0], conf=recs[0]["conf"] + 0.25)
        return recs

    monkeypatch.setattr(runner, "infer_scene_instances", altered)


@pytest.mark.parametrize("name,fault", [
    ("isbnet_scannet.train", _state_unchanged), ("isbnet_scannet.train", _half_batches),
    ("spformer_scannet.train", _state_unchanged), ("spformer_scannet.train", _half_batches),
    ("isbnet_scannet.infer", _answer_altered)])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    result, checks = tiny_run(name)
    assert not result["correct"], checks


@pytest.mark.parametrize("name", ("isbnet_scannet.train", "spformer_scannet.train"))
def test_lower_precision_control_is_not_correct(name):
    """The port's bf16 conv mode in its own place fails a limit. (At these
    widths its effect on an inference cell's instances depends on the seed;
    the inference control is held at the cell's size on the card.)"""
    from benchmark import control

    config, traffic = name.split(".")
    cfg = tiny.config(config)
    lines = list(control.readings(cfg, tiny.mix(traffic), [2 ** 31 + 13], ["program", "bf16"],
                                  CPU))
    limits = cfg["limits"][tiny.mix(traffic)["kind"]]
    failed = {ln["side"]: any(ln[k] > v for k, v in limits.items()) for ln in lines}
    assert failed == {"program": False, "bf16": True}, lines


def _card(chips: int = 1):
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    _card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2 ** 31 + 101), "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=tiny.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_controls_fail_at_the_cells_size(name):
    """The controls on the card at the cell's size, three seeds: the port's
    bf16 mode and the reference in TF32 each fail a limit, the port does
    not."""
    _card()
    sides = "program,bf16,tf32"
    out = subprocess.run([sys.executable, "benchmark/control.py", "--workload", name,
                          "--seeds", "501,502,503", "--sides", sides],
                         capture_output=True, text=True, cwd=tiny.ROOT, timeout=3000)
    assert out.returncode == 0, out.stderr[-3000:]
    config = json.load(open(os.path.join(tiny.ROOT, "benchmark", "configs",
                                         name.split(".")[0] + ".json")))
    limits = config["limits"][name.split(".")[1]]
    for ln in (json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")):
        failed = any(ln[k] > v for k, v in limits.items())
        assert failed == (ln["side"] != "program"), ln
