"""The ``isbnet_s3dis.infer_x4`` cell at tiny widths on the CPU (its look for
a chip skipped): a sound run is correct; a run with the merge's
permutation left out, or with a piece's points dropped from every
instance, is not; a request that drops superpoint ids fails; a traced
run reads the split and the merge; the port's
``serve_room`` agrees with the reference's plain x4 request. The card's
own tests (marker ``gpu``) run the cell and its controls at the cell's
size:

    python -m pytest -p no:cacheprovider -m gpu benchmark/tests/test_bench_s3dis.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control_x4, run
from benchmark.drivers import infer_x4
from benchmark.lib import compare, weights
from benchmark.tests import tiny

CPU = torch.device("cpu")
NAME = "isbnet_s3dis.infer_x4"
POOL = {"sizes": [2400, 2800, 3200, 3600], "superpoint_cell": 1.5}
SPP_CAP = 1024


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_config() -> dict:
    """``tiny.config``'s widths, with a superpoint capacity for the tiny
    rooms' ids and no plan shrink: a few thousand points over a room's
    surfaces are too sparse for a coarser level to hold fewer voxels."""
    cfg = tiny.config("isbnet_s3dis")
    cfg["model"]["spp_cap"] = SPP_CAP
    cfg["data"]["plan_shrink"] = 1.0
    return cfg


def tiny_mix() -> dict:
    with open(os.path.join(tiny.ROOT, "benchmark", "traffic", "infer_x4.json")) as f:
        mix = json.load(f)
    mix.update(pool=dict(POOL), requests=64, check_requests=3, profile={"skip": 1, "units": 2})
    return mix


def tiny_run(seed: int = 2 ** 31 + 11, seconds: float = 1.0, trace: int = 0, config=None):
    cell = dict(name=NAME, config="isbnet_s3dis", traffic="infer_x4", chips=1)
    return run.run_cell(cell, config or tiny_config(), tiny_mix(), tiny.manifest(), seed,
                        seconds, trace, CPU)


def test_sound_run_is_correct():
    result, checks = tiny_run()
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"setup_s", "infer_scenes_per_s"}
    assert {c["name"] for c in checks} == {"conf_gap", "mask_gap", "unpaired"}


@pytest.mark.parametrize("side", ["unmerged", "piece_dropped"])
def test_broken_merge_is_not_correct(side):
    with control_x4.fault(side):
        result, checks = tiny_run()
    assert not result["correct"], checks


def test_traced_run_reads_split_and_merge():
    result, _ = tiny_run(trace=1, seconds=2.0)
    assert result["correct"]
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    # the span-based metrics read on any device; device-trace ones need a card
    for name in ("split_ms.infer_x4", "merge_ms.infer_x4", "prepare_ms.infer",
                 "instances_ms.infer"):
        assert result["metrics"][name]["value"] > 0, name


def test_superpoint_ids_past_the_cap_fail_set_up():
    cfg, mix = tiny_config(), tiny_mix()
    pool = infer_x4.plan(cfg, mix, 2 ** 31 + 3)["pool"]
    ids = infer_x4.superpoint_ids(cfg, pool)
    assert len(ids) == len(POOL["sizes"]) and max(ids) <= SPP_CAP
    cfg["model"]["spp_cap"] = max(ids) - 1
    with pytest.raises(ValueError, match="spp_cap"):
        infer_x4.superpoint_ids(cfg, pool)


def test_requests_that_drop_superpoint_ids_fail(monkeypatch):
    """Past ``spp_cap``, with set-up's check taken away, every request
    fails on the port's ``ovf_spp_ids``."""
    cfg = tiny_config()
    cfg["model"]["spp_cap"] = 64
    monkeypatch.setattr(infer_x4, "superpoint_ids", lambda config, pool: [])
    result, _ = tiny_run(config=cfg)
    assert result["attempted"] >= 1 and result["failed"] == result["attempted"]


def test_pool_sizes_are_the_mix_s_in_the_seed_s_order():
    mix = tiny_mix()
    a = infer_x4.plan(tiny_config(), mix, 2 ** 31 + 7)["pool"]
    b = infer_x4.plan(tiny_config(), mix, 2 ** 31 + 8)["pool"]
    assert sorted(len(r["xyz"]) for r in a) == sorted(POOL["sizes"])
    assert sorted(len(r["xyz"]) for r in b) == sorted(POOL["sizes"])
    assert set(np.unique(np.concatenate([r["semantic"] for r in a]))) == set(range(13))


def test_numbers_are_compare_s():
    """``infer_x4.numbers`` equals ``compare.infer_numbers`` on records
    that pair, fail to pair and tie."""
    from gapro_tpu_torch.utils.rle import rle_encode

    rng = np.random.default_rng(5)
    rec = lambda m, label, conf: dict(label_id=label, conf=conf, pred_mask=rle_encode(m))
    base = [rng.random(500) < p for p in (0.2, 0.4, 0.6, 0.3)]
    got = [rec(base[0], 1, 1.0), rec(base[1], 4, 0.7), rec(base[2] ^ (rng.random(500) < 0.05), 4,
                                                           0.7), rec(base[3], 5, 0.2)]
    want = [rec(base[0], 1, 1.0), rec(base[2], 4, 0.65), rec(base[1], 4, 0.72),
            rec(rng.random(500) < 0.5, 6, 0.3)]
    assert infer_x4.numbers([got], [want]) == compare.infer_numbers([got], [want])


def test_no_jax_module_is_loaded():
    code = ("import sys, torch; sys.path.insert(0, %r); torch.set_num_threads(2)\n"
            "from benchmark.tests.test_bench_s3dis import tiny_run\n"
            "from benchmark.lib import harness\n"
            "tiny_run()\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(harness.loaded_forbidden(), 'gapro_tpu_torch' in tops)" % tiny.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tiny.ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


@pytest.mark.parametrize("seed", [2 ** 31 + 21, 2 ** 31 + 22, 5])
def test_serve_room_matches_the_reference(seed):
    """The port's ``serve_room`` (its kernels' plain versions on the CPU)
    against the reference's plain x4 request on the seed's weights: the
    forward's outputs, the sem2ins masks and the instance records after
    the merge."""
    from gapro_tpu_torch.data.augment import transform_test
    from gapro_tpu_torch.tools import test as cli
    from gapro_tpu_torch.tools import train as trainer
    from gapro_tpu_torch.train.config import AttrDict

    from benchmark.reference import build, x4

    cfg, mix = tiny_config(), tiny_mix()
    room = infer_x4.plan(cfg, mix, seed)["pool"][0]
    shift = cfg["assumed"]["bias_shift"]
    acfg = AttrDict.wrap(cfg)
    model, _ = trainer.build_model(acfg, CPU, seed=0)
    weights.load(model, weights.draw(weights.leaves(model), seed, CPU, shift))
    model.eval()
    ref = build.build_model(cfg, CPU)
    weights.load(ref, weights.draw(weights.leaves(ref), seed, CPU, shift))
    ref.eval()

    scale = cfg["data"]["voxel"]["scale"]
    scene = transform_test(dict(room), scale)
    with torch.no_grad():
        prepared, out, got = cli.serve_room(model, acfg, scene, trainer.make_prepare(acfg, CPU),
                                            scale, room["scan_id"])
        pieces, spp, perm = x4.split_room(build.test_scene(cfg, dict(room)))
        rprep = build.prepare(cfg, build.batch(cfg, pieces), x4.PIECES, CPU)
        rout = ref.forward_inference(rprep.batch, x4_split=True)
    np.testing.assert_array_equal(perm, cli.split_room(scene, scale)[1])
    for key in ("semantic_scores", "cls_logits", "conf_logits", "mask_logits"):
        torch.testing.assert_close(out[key], rout[key], rtol=1e-4, atol=1e-4, msg=key)
    want = x4.request(cfg, ref, room, room["scan_id"], CPU)
    # the ceiling and floor from the semantics first, equal point for point
    assert [(r["label_id"], r["conf"]) for r in got[:2]] == [(1, 1.0), (2, 1.0)]
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(cli.rle_decode(g["pred_mask"]),
                                      cli.rle_decode(w["pred_mask"]))
    nums = infer_x4.numbers([got], [want])
    assert len(got) == len(want) > 2
    assert nums["unpaired"] == 0 and nums["mask_gap"] == 0.0 and nums["conf_gap"] < 1e-5, nums


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_cell_on_the_card():
    _card()
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", NAME, "--seed",
                          str(2 ** 31 + 101), "--seconds", "10", "--trace", "0"],
                         capture_output=True, text=True, cwd=tiny.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0


@pytest.mark.gpu
def test_controls_fail_at_the_cells_size():
    """The controls on the card at the cell's size, three seeds: the port's
    bf16 mode, the reference in TF32 and both faults of the merge each fail
    a limit, the port does not."""
    _card()
    sides = "program,bf16,tf32,unmerged,piece_dropped"
    out = subprocess.run([sys.executable, "benchmark/control_x4.py", "--workload", NAME,
                          "--seeds", "501,502,503", "--sides", sides],
                         capture_output=True, text=True, cwd=tiny.ROOT, timeout=3000)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(os.path.join(tiny.ROOT, "benchmark", "configs", "isbnet_s3dis.json")) as f:
        limits = json.load(f)["limits"]["infer_x4"]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 15
    for ln in lines:
        failed = any(ln[k] > v for k, v in limits.items())
        assert failed == (ln["side"] != "program"), ln
