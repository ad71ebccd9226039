"""The port's own tracing (``gapro_tpu_torch/utils/profiling.py``) moves no
reading of the benchmark's: the trace reduction gives the same busy time,
range device times and operations with the port's ``gapro.*`` ranges and
their device-side copies in the trace, and a tiny traced run on the CPU
computes the same numbers, counts and trace reduction, and reads the same
metrics, with the port's tracing on as off."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import trace
from benchmark.tests import tiny
from benchmark.tests.test_bench_run import CELLS, tiny_run
from benchmark.tests.test_bench_trace import ev


@pytest.fixture(autouse=True)
def _threads():
    """Two torch threads, as ``test_bench_run.py``'s: CPU sums split by a
    thread team of another size, or of a machine's every core, differ in
    their last bits from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_range(name, start, end, cpu=True, thread=1):
    """A ``gapro.*`` range as the profiler lists it: a user annotation on
    the host and, on the card, its device-side copy."""
    return SimpleNamespace(name="gapro." + name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=SimpleNamespace(name="CPU" if cpu else "CUDA"),
                           thread=thread, sequence_nr=-1, is_async=False,
                           is_user_annotation=True, kernels=[])


def test_port_ranges_leave_the_reduction_unchanged():
    events = [
        ev("bench.span.forward", 0, 100),
        ev("bench.conv", 10, 40, kernels=[("bench.conv", 30)]),
        ev("aten::mm", 12, 20, seq=7, kernels=[("gemm", 10)]),
        ev("aten::add", 50, 55, seq=8, kernels=[("add", 5)]),
        ev("autograd::engine::evaluate_function: MmBackward0", 60, 70, thread=2, seq=7),
        ev("aten::mm", 61, 69, thread=2, kernels=[("gemm_bwd", 20)]),
        ev("bench.conv", 100, 110, cpu=False),
        ev("gemm", 100, 110, cpu=False),
        ev("add", 200, 205, cpu=False),
        ev("gemm_bwd", 300, 320, cpu=False),
    ]
    ranges = [port_range("model.backbone", 5, 45), port_range("model.heads", 45, 58),
              port_range("step.backward", 58, 75),
              port_range("model.backbone", 100, 110, cpu=False),
              port_range("model.heads", 200, 205, cpu=False),
              port_range("step.backward", 300, 320, cpu=False)]
    plain = trace.reduce(events, ranges=("bench.conv",))
    traced = trace.reduce(events + ranges, ranges=("bench.conv",))
    for key in ("busy_s", "n_device_ops", "range_device_s", "top_ops"):
        assert traced[key] == plain[key], key
    assert [g[1] for g in traced["idle_gaps"]] == [g[1] for g in plain["idle_gaps"]]


def _traced_run(name, monkeypatch) -> dict:
    """A tiny traced run with what it computes from: the result, the
    numbers ``correct`` is decided on, the counting pass's tally and the
    reduced trace."""
    import importlib

    from benchmark import run

    got = {}
    driver = importlib.import_module("benchmark.drivers." + tiny.mix(name.split(".")[1])["kind"])
    drive, reduce_profile, count_pass = driver.run, run.reduce_profile, run.Context.count_pass

    def driven(ctx):
        out = drive(ctx)
        got["numbers"] = out["numbers"]
        return out

    def reduced(ctx):
        got["profile"] = reduce_profile(ctx)
        return got["profile"]

    def counted(self, *args, **kw):
        count_pass(self, *args, **kw)
        got["tally"] = self.tally

    monkeypatch.setattr(driver, "run", driven)
    monkeypatch.setattr(run, "reduce_profile", reduced)
    monkeypatch.setattr(run.Context, "count_pass", counted)
    got["result"], _ = tiny_run(name, trace=1, seconds=4.0)
    monkeypatch.undo()
    return got


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_same_metrics_with_the_port_traced(name, monkeypatch):
    """The values that do not hang on the host's clock are equal with the
    port's tracing on and off: the numbers ``correct`` is decided on, the
    counting pass's operations and bytes a unit, and the reduced trace's
    busy time, device operations and ranges (all 0 on the CPU). The metrics
    timed on the host clock are checked for presence only."""
    from gapro_tpu_torch.utils import profiling

    off = _traced_run(name, monkeypatch)
    profiling.enable(True)
    try:
        on = _traced_run(name, monkeypatch)
        record = profiling.drain()
    finally:
        profiling.enable(False)
    assert off["result"]["correct"] and on["result"]["correct"]
    assert on["numbers"] == off["numbers"]
    assert on["tally"]["per_unit"] == off["tally"]["per_unit"]
    assert on["tally"]["units"] == off["tally"]["units"] > 0
    for key in ("busy_s", "n_device_ops", "range_device_s", "units"):
        assert on["profile"][key] == off["profile"][key], key
    # the request tail reads only from 20 requests in the window, a count
    # the host's clock decides
    tail = "request_ms_p95.infer"
    for got in (on, off):
        assert (tail in got["result"]["metrics"]) == (name.endswith(".infer")
                                                       and got["result"]["attempted"] >= 20)
    assert set(on["result"]["metrics"]) - {tail} == set(off["result"]["metrics"]) - {tail}
    assert record["spans"]  # the port did record
