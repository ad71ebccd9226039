"""The port's tracing (``gapro_tpu_torch/utils/profiling.py``) on the CPU:
off, a span is one shared no-op and nothing is recorded or ranged; on,
spans carry their unit, a thread's spans stay flat, counters add up and
``drain`` clears; the loader's forked workers send their spans back, under
the step that takes each scene; the spans sit on a profile's clock after
the anchor's mapping; and the test CLI's request path records its stages,
side by side, without changing its answers."""

import os
import sys
import threading

import pytest
import torch

from gapro_tpu_torch.data.dataset import SyntheticDataset, build_dataloader
from gapro_tpu_torch.tools import test as port_test
from gapro_tpu_torch.tools import train as port_train
from gapro_tpu_torch.train.config import load_config
from gapro_tpu_torch.utils import profiling

from tests.test_torch_trainer import SMALL, TINY, TINY_SPF


@pytest.fixture(autouse=True)
def _clean():
    """Tracing off and an empty buffer around each test; two torch threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    profiling.enable(False)
    profiling.drain()
    profiling.set_unit(None)
    yield
    profiling.enable(False)
    profiling.drain()
    profiling.set_unit(None)
    torch.set_num_threads(n)


def _names(record):
    return {s.name for s in record["spans"]}


def test_off_is_one_shared_noop():
    from torch.profiler import ProfilerActivity, profile

    a, b = profiling.span("x"), profiling.span("y", unit=3)
    assert a is b
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("model.backbone"):
            torch.ones(8) + 1
        profiling.count("loader.asked")
        t = torch.ones(3)
        assert profiling.to_host(t, "site") is t
    assert profiling.drain() == dict(spans=[], counts={})
    assert not any(e.name.startswith(profiling.PREFIX) for e in prof.events())


def test_units_flat_spans_counters_and_drain():
    profiling.enable(True)
    for _ in profiling.units(range(2), start=5):
        with profiling.span("first"):
            pass
        with profiling.span("own", unit=99):
            pass
        with profiling.span("last"):
            pass
        profiling.count("asked")
        profiling.count("bytes", 10)
    rec = profiling.drain()
    assert profiling.drain() == dict(spans=[], counts={})
    assert rec["counts"] == {"asked": 2, "bytes": 20}
    spans = rec["spans"]
    assert [s.name for s in spans] == ["first", "own", "last"] * 2
    assert [s.unit for s in spans] == [5, 99, 5, 6, 99, 6]
    assert {(s.pid, s.thread) for s in spans} == {(os.getpid(), threading.get_native_id())}
    for a, b in zip(spans, spans[1:]):
        assert a.start_ns <= a.end_ns <= b.start_ns  # one flat sequence
    got = profiling.per_unit(rec, 2)
    assert set(got["stages_ms"]) == {"first", "own", "last"}
    assert got["counts"] == {"asked": 1, "bytes": 10} and got["worker_scenes"] == 0
    # the CPU tensor is read as it is: no sync, nothing counted
    t = torch.arange(4)
    assert profiling.to_host(t, "site") is t
    assert profiling.drain()["counts"] == {}


def test_threads_lose_no_record():
    """More threads than cores, a short switch interval: every span and
    count of every thread is kept."""
    profiling.enable(True)
    n_threads, n = 2 * (os.cpu_count() or 2), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profiling.span("a"):
                    profiling.count("c")
                with profiling.span("b"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    rec = profiling.drain()
    assert rec["counts"] == {"c": n_threads * n}
    assert len(rec["spans"]) == 2 * n_threads * n
    by_thread = {}
    for s in rec["spans"]:
        by_thread.setdefault(s.thread, []).append(s)
    for spans in by_thread.values():
        spans.sort(key=lambda s: s.start_ns)
        assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))


def test_forked_workers_send_their_spans():
    profiling.enable(True)
    ds = SyntheticDataset(n_scenes=4, training=True,
                          voxel_cfg=port_train.voxel_cfg(load_config(TINY)), **SMALL)
    batches = list(profiling.units(build_dataloader(ds, 2, training=True, seed=3,
                                                    num_workers=2)))
    rec = profiling.drain()
    assert len(batches) == 2
    scenes = [s for s in rec["spans"] if s.name == "loader.scene"]
    assert len(scenes) == 4
    assert all(s.pid != os.getpid() for s in scenes)
    assert sorted(s.unit for s in scenes) == [0, 0, 1, 1]  # the batches that took them
    main = [s for s in rec["spans"] if s.pid == os.getpid()]
    assert {s.name for s in main} == {"loader.wait", "loader.collate"}
    assert sorted({s.unit for s in main}) == [0, 1]  # the batches
    assert rec["counts"]["loader.asked"] == 4
    assert 0 <= rec["counts"]["loader.ready"] <= 4
    # off when the loader starts: the workers send scenes alone
    profiling.enable(False)
    assert len(list(build_dataloader(ds, 2, training=True, seed=3, num_workers=2))) == 2
    assert profiling.drain() == dict(spans=[], counts={})


def test_spans_sit_on_the_profile_clock():
    """Each span's buffer copy against its range in a CPU profile, mapped
    by the anchor: within 0.5 ms."""
    from torch.profiler import ProfilerActivity, profile

    profiling.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ref_ns = profiling.anchor()
        for i in range(3):
            with profiling.span(f"stage{i}"):
                torch.ones(256, 256) @ torch.ones(256, 256)
    spans = profiling.drain()["spans"]
    events = {e.name: e for e in prof.events() if e.name.startswith(profiling.PREFIX)}
    offset_us = events[profiling.ANCHOR].time_range.start - ref_ns / 1e3
    assert len(spans) == 3
    for s in spans:
        e = events[profiling.PREFIX + s.name]
        assert abs(s.start_ns / 1e3 + offset_us - e.time_range.start) < 500
        assert abs(s.end_ns / 1e3 + offset_us - e.time_range.end) < 500


def test_idle_attribution_on_hand_made_events():
    from types import SimpleNamespace

    def ev(name, start, end, cpu=True):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                               device_type=SimpleNamespace(name="CPU" if cpu else "CUDA"),
                               is_user_annotation=name.startswith(profiling.PREFIX))

    events = [ev("aten::mm", 0, 100), ev("gapro.loader.wait", 10, 40),
              ev("gapro.step.match", 60, 70), ev("gemm", 0, 20, cpu=False),
              ev("gapro.step.match", 55, 90, cpu=False),  # a range's device-side copy
              ev("add", 50, 55, cpu=False), ev("add", 80, 90, cpu=False)]
    got = profiling.idle_attribution(events)
    # idle: 20-50, 55-80, 90-100 (65 us); named: 20-40 and 60-70 (30 us)
    assert got["stretch_s"] == pytest.approx(100e-6)
    assert got["idle_s"] == pytest.approx(65e-6)
    assert got["unattributed_s"] == pytest.approx(35e-6)


@pytest.mark.parametrize("config", [TINY, TINY_SPF])
def test_request_path_records_its_stages(config):
    """The test CLI on two synthetic scenes: the same records with tracing
    on as off (one thread: PyTorch's CPU sums split by the thread team),
    and on, each request's stages side by side, none inside another."""
    torch.set_num_threads(1)
    cfg = load_config(config)
    model, _ = port_train.build_model(cfg, "cpu", seed=0)
    kw = dict(device="cpu", synthetic=2, model=model, evaluate=False)
    off = port_test.run_test(cfg, **kw)["preds"]
    profiling.enable(True)
    on = port_test.run_test(cfg, **kw)["preds"]
    rec = profiling.drain()
    assert len(on) == len(off) == 2
    for a, b in zip(on, off):
        assert [(r["label_id"], r["conf"]) for r in a] == [(r["label_id"], r["conf"]) for r in b]
        assert all((x["pred_mask"]["counts"] == y["pred_mask"]["counts"]).all()
                   for x, y in zip(a, b))
    stages = {"loader.scene", "loader.collate", "prepare.upload", "prepare.voxelize",
              "prepare.plan", "model.backbone", "model.heads"}
    if cfg.model.type == "isbnet":
        stages |= {"model.aggregator", "model.mask_head"}
    else:
        stages |= {"model.decoder"}
    assert _names(rec) == stages
    spans = sorted(rec["spans"], key=lambda s: s.start_ns)
    assert all(a.end_ns <= b.start_ns for a, b in zip(spans, spans[1:]))
