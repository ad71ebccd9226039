"""The reduction of a ``torch.profiler`` trace (CPU and CUDA activities)
to device times.

* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy or fill) ran.
* ``range_device_s``: each named profiler range's device time: the
  device operations inside the range's device-side copy (the profiler's
  annotation spans the stream from the range's first kernel to its last,
  so a cluster launch it links to no operation is held too), and the
  kernels of the autograd backward nodes whose forward operation lies
  inside the range (the backward's ``sequence_nr`` is its forward
  operation's), so that a range holds its backward's work, whatever
  kernels implement it.
* ``top_ops``: device time summed by operation name; ``idle_gaps``: the
  longest stretches with no device operation, each named by the
  benchmark's span and the longest CPU operation the host ran then.
"""

from __future__ import annotations

import bisect


def _on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).upper() in ("CUDA", "PRIVATEUSE1")


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or fill, not the device-side
    copy of a profiler range."""
    return (_on_device(e) and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench.") and not e.name.startswith("ProfilerStep"))


def _interval(e):
    return e.time_range.start, e.time_range.end  # microseconds


def union_us(intervals) -> float:
    total, end = 0.0, None
    start = None
    for s, t in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, t
        else:
            end = max(end, t)
    if end is not None:
        total += end - start
    return total


def reduce(events, ranges=(), span_prefix: str = "bench.span.", main_thread=None) -> dict:
    """``events``: ``prof.events()``. Returns busy_s, the device operations'
    time by name, each range's device time and the idle gaps."""
    events = list(events)
    dev = [e for e in events if _is_device(e)]
    cpu = [e for e in events if not _on_device(e)]

    # each range's forward: the device-side copies of the range (the
    # profiler's annotation spans the device from the range's first kernel
    # to its last, a cluster launch it does not link included); its
    # backward: the kernels of the autograd nodes whose sequence_nr is one
    # of the range's operations' (the profiler lists each CPU operation's
    # kernels)
    by_thread = {}
    for e in cpu:
        by_thread.setdefault(e.thread, []).append(e)
    for th in by_thread.values():
        th.sort(key=lambda e: e.time_range.start)
    starts_of = {th: [e.time_range.start for e in evs] for th, evs in by_thread.items()}
    device_iv, host_iv, seq_of = {}, {}, {}
    for name in ranges:
        device_iv[name] = sorted(_interval(e) for e in events
                                 if _on_device(e) and e.name == name)
        host_iv[name], seq_of[name] = [], set()
        for r in (e for e in cpu if e.name == name):
            s, t = _interval(r)
            host_iv[name].append((r.thread, s, t))
            evs, st = by_thread[r.thread], starts_of[r.thread]
            for i in range(bisect.bisect_left(st, s), bisect.bisect_right(st, t)):
                nr = getattr(evs[i], "sequence_nr", -1)
                if evs[i].time_range.end <= t and nr is not None and nr >= 0:
                    seq_of[name].add(nr)
    backward_iv = {name: [] for name in ranges}
    for e in cpu:
        if "evaluate_function" in e.name:
            nr = getattr(e, "sequence_nr", -1)
            for name in ranges:
                if nr in seq_of[name]:
                    backward_iv[name].append((e.thread,) + _interval(e))

    def merged(ivs):
        per = {}
        for th, s, t in sorted(ivs, key=lambda x: (x[0], x[1])):
            m = per.setdefault(th, [])
            if m and s <= m[-1][1]:
                m[-1][1] = max(m[-1][1], t)
            else:
                m.append([s, t])
        return {th: ([a for a, _ in m], [b for _, b in m]) for th, m in per.items()}

    def inside(lookup, th, x) -> bool:
        st_en = lookup.get(th)
        if st_en is None:
            return False
        i = bisect.bisect_right(st_en[0], x) - 1
        return i >= 0 and x <= st_en[1][i]

    range_us = {name: 0.0 for name in ranges}
    # where the profiler gave a range no device-side copy, its forward's
    # kernels are taken from its CPU operations as its backward's are
    cpu_iv = {name: merged(backward_iv[name] + ([] if device_iv[name] else host_iv[name]))
              for name in ranges}
    dev_lookup = {name: merged([(0, s, t) for s, t in device_iv[name]]) for name in ranges}
    op_us = {}
    intervals = []
    for k in dev:
        s, t = _interval(k)
        intervals.append((s, t))
        op_us[k.name] = op_us.get(k.name, 0.0) + (t - s)
        for name in ranges:
            if inside(dev_lookup[name], 0, s):
                range_us[name] += t - s
                break
    for e in cpu:
        ks = getattr(e, "kernels", None)
        if not ks:
            continue
        for name in ranges:
            if inside(cpu_iv[name], e.thread, e.time_range.start):
                range_us[name] += sum(k.duration for k in ks if not k.name.startswith("bench."))
                break

    busy = union_us(intervals)
    gaps = []
    merged = []
    for s, t in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    for (s0, t0), (s1, t1) in zip(merged, merged[1:]):
        gaps.append((s1 - t0, t0, s1))
    gaps.sort(reverse=True)
    spans = sorted((_interval(e) + (e.name[len(span_prefix):],) for e in cpu
                    if e.name.startswith(span_prefix)))
    starts = [s for s, _, _ in spans]
    named = []
    for length, g0, g1 in gaps[:10]:
        mid = 0.5 * (g0 + g1)
        span = "other"
        i = bisect.bisect_right(starts, mid) - 1
        while i >= 0:
            if spans[i][1] >= mid:
                span = spans[i][2]
                break
            i -= 1
        host = max((e for e in cpu if e.time_range.start < g1 and e.time_range.end > g0
                    and (main_thread is None or e.thread == main_thread)
                    and not e.name.startswith("bench.") and not e.name.startswith("ProfilerStep")),
                   key=lambda e: min(e.time_range.end, g1) - max(e.time_range.start, g0),
                   default=None)
        named.append([f"{span}:{host.name if host is not None else 'none'}", length / 1e6])
    top = sorted(op_us.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy / 1e6, n_device_ops=len(dev),
                range_device_s={k: v / 1e6 for k, v in range_us.items()},
                top_ops=[[k, v / 1e6] for k, v in top], idle_gaps=named)
