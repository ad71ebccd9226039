"""The port's tracing: spans and counters where the work happens,
``torch.profiler`` traces, and the card's memory
(``gapro_tpu/utils/profiling.py``, which uses ``jax.profiler``).

The reference has only wall-clock AverageMeters and
``torch.cuda.max_memory_allocated`` logging (ISBNet/tools/train.py:55-99,
isbnet/util/utils.py:151-157).

* ``enable(on)`` is the one switch. Off, ``span`` returns one shared no-op
  after a single flag check, and ``count`` and ``to_host`` count nothing.
* ``span(name, unit)`` records (name, start, end, unit, pid, thread) on
  ``time.perf_counter_ns`` in this process's buffer; in the process that
  turned tracing on, while a profiler runs, it is also a profiler range
  ``gapro.<name>``, so that it lies on the device trace's clock. A thread's
  spans do not nest: the port places each stage's span beside the others,
  never inside one, so each thread holds a flat sequence of stages, a
  span's self time is its duration, and each profiler range is one stage
  (``tests/test_torch_profile.py`` holds the trainer's step to it).
  ``unit`` is the step or request the span belongs to (``units`` sets the
  current one for the spans that name none).
* ``count(name, n)`` adds to a counter; ``to_host(t, site)`` is a
  deliberate device-to-host read, counted under ``host_syncs`` and
  ``d2h_bytes``, in all and by site.
* ``drain()`` returns the spans and counters and clears both (``per_unit``
  sums them a step or request); a loader
  worker's drained record joins the main process's by ``merge``, under
  the unit that takes its scene.
* ``trace(dir)`` captures the host and the card into a Chrome trace; with
  tracing on, the loader workers' spans are added to it, one track a
  worker, aligned by an anchor range. ``idle_attribution`` splits the
  card's idle time in a profile by whether a ``gapro.*`` range was open
  (the trainer's ``--profile`` log line).

Usage:
    profiling.enable(True)
    with profiling.trace("runs/x/trace"):      # or tools/train.py --profile N
        for batch in profiling.units(loader):
            with profiling.span("step.backward"):
                ...
    record = profiling.drain()
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import os.path as osp
import threading
import time
from typing import Iterable, Iterator, NamedTuple, Optional

import torch

log = logging.getLogger(__name__)

TRACE_FILE = "trace.json"
PREFIX = "gapro."
ANCHOR = PREFIX + "anchor"


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int
    unit: Optional[int]
    pid: int
    thread: int  # threading.get_native_id


_on = False
_main_pid: Optional[int] = None  # the process whose spans are profiler ranges
_unit: Optional[int] = None
_spans: list = []
_counts: dict = {}
_lock = threading.Lock()
_NOOP = contextlib.nullcontext()


def enable(on: bool) -> None:
    """Turn tracing on or off in this process, whose spans are then also
    profiler ranges while a profiler runs."""
    global _on, _main_pid
    _on = bool(on)
    _main_pid = os.getpid()
    if _on and not torch._C._autograd._profiler_enabled():
        # a process's first range takes a millisecond or more to open: open
        # one while no profiler sees it, so that the anchor's clock is tight
        with torch.profiler.record_function(ANCHOR):
            pass


def enabled() -> bool:
    return _on


def enable_in_worker(on: bool) -> None:
    """The switch in a loader worker (its initializer): the main process's
    setting, a clean buffer, no unit and no profiler ranges; the worker's
    record goes back with its results (``drain`` there, ``merge`` here)."""
    global _on, _unit
    _on, _unit = bool(on), None
    drain()


def set_unit(unit: Optional[int]) -> None:
    """The unit of the spans opened from now on that name none."""
    global _unit
    _unit = unit


def units(iterable: Iterable, start: int = 0) -> Iterator:
    """``iterable``'s items, item k the unit ``start + k``: the spans from
    the request for the item (a loader's wait included) to the request
    for the next carry that number."""
    it = iter(iterable)
    n = start
    while True:
        set_unit(n)
        try:
            item = next(it)
        except StopIteration:
            return
        yield item
        n += 1


class _Span:
    """An open span, and in the process that turned tracing on, while a
    profiler runs, its profiler range."""

    __slots__ = ("name", "unit", "t0", "rf")

    def __init__(self, name: str, unit: Optional[int]):
        self.name = name
        self.unit = _unit if unit is None else unit
        self.rf = None

    def __enter__(self):
        # a range costs tens of microseconds on the card's host even with no
        # profiler running, where no one sees it
        if os.getpid() == _main_pid and torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        now = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        rec = Span(self.name, self.t0, now, self.unit, os.getpid(), threading.get_native_id())
        with _lock:
            _spans.append(rec)
        return False


def span(name: str, unit: Optional[int] = None):
    """A stage of this thread's work (a context manager); see the module's
    docstring."""
    if not _on:
        return _NOOP
    return _Span(name, unit)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    if not _on:
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def to_host(t: torch.Tensor, site: str) -> torch.Tensor:
    """``t`` on the host: a deliberate device-to-host read, which waits
    for the card. Counted (a tensor on the card only) under ``host_syncs``
    and ``d2h_bytes``, and under ``host_syncs.<site>`` and
    ``d2h_bytes.<site>``."""
    if _on and t.device.type != "cpu":
        n = t.numel() * t.element_size()
        with _lock:
            for key, v in (("host_syncs", 1), ("d2h_bytes", n)):
                for k in (key, f"{key}.{site}"):
                    _counts[k] = _counts.get(k, 0) + v
    return t.cpu()


def drain() -> dict:
    """This process's spans (``Span``) and counters since the last drain;
    both are cleared."""
    global _spans, _counts
    with _lock:
        out = dict(spans=_spans, counts=_counts)
        _spans, _counts = [], {}
    return out


def merge(record: dict) -> None:
    """Add another process's drained record (a loader worker's) to this
    one's, under the switch; its spans that name no unit take the current
    one."""
    if not _on:
        return
    spans = [Span(*s) for s in record["spans"]]
    with _lock:
        _spans.extend(s if s.unit is not None else s._replace(unit=_unit) for s in spans)
        for k, v in record["counts"].items():
            _counts[k] = _counts.get(k, 0) + v


def per_unit(record: dict, units: int) -> dict:
    """A drained record over ``units`` steps or requests: this process's
    milliseconds a unit in each span (``stages_ms``), each counter a unit,
    and the other processes' spans, the loader workers' scenes
    (``worker_scene_ms``, the mean of ``worker_scenes``)."""
    units = max(units, 1)
    stages, scenes = {}, []
    for s in record["spans"]:
        ms = (s.end_ns - s.start_ns) / 1e6
        if s.pid == os.getpid():
            stages[s.name] = stages.get(s.name, 0.0) + ms / units
        else:
            scenes.append(ms)
    return dict(units=units, stages_ms=stages,
                counts={k: v / units for k, v in sorted(record["counts"].items())},
                worker_scene_ms=sum(scenes) / len(scenes) if scenes else None,
                worker_scenes=len(scenes))


def anchor() -> int:
    """Open and close the range ``gapro.anchor`` and return the
    ``perf_counter_ns`` of its start: in a profile, the offset between the
    spans' clock and the trace's."""
    t0 = time.perf_counter_ns()
    with torch.profiler.record_function(ANCHOR):
        t1 = time.perf_counter_ns()
    return (t0 + t1) // 2


def _add_worker_tracks(path: str, anchor_ns: int) -> int:
    """Add the buffer's spans of other processes (the loader workers') to
    the Chrome trace at ``path``, one track a worker; returns how many."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    ref = next((e for e in events if e.get("name") == ANCHOR and e.get("ph") == "X"), None)
    with _lock:
        spans = [s for s in _spans if s.pid != os.getpid()]
    if ref is None or not spans:
        return 0
    offset_us = float(ref["ts"]) - anchor_ns / 1e3
    for pid in sorted({s.pid for s in spans}):
        events.append(dict(ph="M", name="process_name", pid=pid,
                           args=dict(name=f"loader worker {pid}")))
    for s in spans:
        events.append(dict(ph="X", cat="gapro", name=PREFIX + s.name, pid=s.pid, tid=s.thread,
                           ts=s.start_ns / 1e3 + offset_us, dur=(s.end_ns - s.start_ns) / 1e3,
                           args=dict(unit=s.unit)))
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(spans)


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``<log_dir>/trace.json``. ``cuda`` adds the card's activity (default:
    where a card is available). With tracing on, the loader workers'
    spans in the buffer when the block ends are added as their own
    tracks. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        anchor_ns = anchor() if _on else None
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = osp.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if anchor_ns is not None:
        _add_worker_tracks(path, anchor_ns)
    log.info("profiler trace written to %s", path)


def _on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).upper() in ("CUDA", "PRIVATEUSE1")


def _device_op(e) -> bool:
    """A kernel, copy or fill: not a range's device-side copy (a user
    annotation) nor the profiler's step."""
    return (_on_device(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep"))


def _union(intervals) -> list:
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _overlap(a: list, b: list) -> float:
    """Total length of the intersection of two sorted disjoint lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_attribution(events) -> dict:
    """A profile's events (``prof.events()``) -> the card's idle time over
    the profiled stretch (first to last host event), in seconds, and the
    part of it in which no ``gapro.*`` range was open on the host
    (``unattributed_s``), for the trainer's ``--profile`` log line."""
    events = list(events)
    cpu = [e for e in events if not _on_device(e)]
    if not cpu:
        return dict(stretch_s=0.0, idle_s=0.0, unattributed_s=0.0)
    lo = min(e.time_range.start for e in cpu)
    hi = max(e.time_range.end for e in cpu)
    busy = _union((max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in events
                  if _device_op(e) and e.time_range.end > lo and e.time_range.start < hi)
    idle, at = [], lo
    for s, t in busy:
        if s > at:
            idle.append([at, s])
        at = max(at, t)
    if at < hi:
        idle.append([at, hi])
    named = _union((e.time_range.start, e.time_range.end) for e in cpu
                   if e.name.startswith(PREFIX) and e.name != ANCHOR)
    idle_us = sum(t - s for s, t in idle)
    return dict(stretch_s=(hi - lo) / 1e6, idle_s=idle_us / 1e6,
                unattributed_s=(idle_us - _overlap(idle, named)) / 1e6)


def device_memory_stats(device=None) -> dict:
    """The card's memory in bytes under the JAX names where they have a
    counterpart: ``bytes_in_use`` (allocated), ``peak_bytes_in_use`` (the
    peak allocated), ``bytes_limit`` (the card's total memory), and
    ``bytes_reserved`` (the caching allocator's reserve, which JAX does not
    report). {} for the CPU or where no card is available."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev or torch.cuda.current_device())
        .total_memory,
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
    }
