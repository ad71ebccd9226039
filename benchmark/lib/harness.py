"""Shared parts of a run: spans on the host clock, the device's readings,
the check that no JAX module was loaded, and the lines a run prints."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "gapro_tpu")


class Spans:
    """Host-clock spans kept in memory: ``span(name)`` adds its seconds to
    ``name``'s list. With ``sync`` each span ends with the device
    synchronised and is also a named profiler range (a traced run)."""

    def __init__(self, device, sync: bool):
        self.device = device
        self.sync = sync and device.type == "cuda"
        self.traced = sync
        self.seconds = {}

    def _sync(self):
        if self.sync:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (torch.profiler.record_function("bench.span." + name) if self.traced
              else contextlib.nullcontext())
        with rf:
            t0 = time.perf_counter()
            yield
            self._sync()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def marks(self):
        """(start, mark): ``mark`` is an ``on_stage`` hook that adds the time
        from the previous mark, or from ``start()``, to each stage's end
        under the stage's name."""
        state = dict(t=None)

        def start():
            self._sync()
            state["t"] = time.perf_counter()

        def mark(name: str):
            if state["t"] is None:
                return
            self._sync()
            t = time.perf_counter()
            self.seconds.setdefault(name, []).append(t - state["t"])
            state["t"] = t

        return start, mark

    def mean_ms(self, name: str):
        v = self.seconds.get(name)
        return 1e3 * sum(v) / len(v) if v else None


def loaded_forbidden() -> list:
    """The forbidden top-level modules in ``sys.modules``, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def host_info() -> dict:
    """The host's logical CPUs and the ones this process may run on: the
    cells are paced by the host."""
    return dict(host_cpus=os.cpu_count(), host_cpus_allowed=len(os.sched_getaffinity(0)))


def device_info(device, n: int) -> dict:
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=n, memory_peak_bytes=0, **host_info())
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(n))
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device), count=n,
                memory_peak_bytes=int(peak), **host_info())


def card_line() -> str:
    """``nvidia-smi``'s name, power limit and top SM clock of the cards, or
    why not."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def metric(value, unit: str) -> dict:
    return dict(value=value, unit=unit)


def emit(result: dict, checks: list) -> None:
    """The checks' lines last on standard error, then the result's line
    last on standard output, the checks under ``checks`` at its end."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} "
              f"({'ok' if c['ok'] else 'FAILED'})", file=sys.stderr)
    sys.stderr.flush()
    out = dict(result)
    out["checks"] = [{k: c[k] for k in ("name", "value", "limit")} for c in checks]
    print(json.dumps(out), flush=True)
