"""The trace reduction on a hand-made trace: busy time, device time by
range (a range's forward by its device-side copy, a cluster launch the
profiler linked to nothing included, and its autograd backward by
sequence number), and the idle gaps."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark.lib import trace


def ev(name, start, end, cpu=True, thread=1, seq=-1, kernels=()):
    """A profiler event; a CPU operation lists the kernels it launched as
    (name, duration), as the profiler links them."""
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=SimpleNamespace(name="CPU" if cpu else "CUDA"),
                           thread=thread, sequence_nr=seq, is_async=False,
                           is_user_annotation=name.startswith("bench."),
                           kernels=[SimpleNamespace(name=n, duration=d) for n, d in kernels])


def test_reduce_attributes_by_range():
    events = [
        ev("bench.span.forward", 0, 100),
        ev("bench.conv", 10, 40, kernels=[("bench.conv", 30)]),
        ev("aten::mm", 12, 20, seq=7, kernels=[("gemm", 10)]),
        ev("my_kernel_launch", 25, 30, kernels=[("gather", 10)]),
        ev("aten::add", 50, 55, seq=8, kernels=[("add", 5)]),
        ev("autograd::engine::evaluate_function: MmBackward0", 60, 70, thread=2, seq=7),
        ev("aten::mm", 61, 69, thread=2, kernels=[("gemm_bwd", 20)]),
        ev("bench.conv", 100, 205, cpu=False),  # the range's device-side copy
        ev("gemm", 100, 110, cpu=False),
        ev("cluster_kernel", 110, 150, cpu=False),  # unlinked, between two of the range's
        ev("gather", 150, 160, cpu=False),
        ev("add", 200, 205, cpu=False),
        ev("gemm_bwd", 300, 320, cpu=False),
    ]
    red = trace.reduce(events, ranges=("bench.conv",))
    assert red["busy_s"] == pytest.approx((60 + 5 + 20) / 1e6)
    assert red["range_device_s"]["bench.conv"] == pytest.approx((10 + 40 + 10 + 5 + 20) / 1e6)
    assert red["n_device_ops"] == 5
    assert red["idle_gaps"][0][1] == pytest.approx(95 / 1e6)
    assert dict(red["top_ops"])["gemm"] == pytest.approx(10 / 1e6)
