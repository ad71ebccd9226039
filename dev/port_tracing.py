"""The port's own tracing on a benchmark cell, on the card. From the
repository's root:

    python3 dev/port_tracing.py readings --workload isbnet_scannet.train --seed 7 \
        --seconds 30 --trace 1 --port 1
    python3 dev/port_tracing.py syncs --workload isbnet_scannet.train --seed 7 --seconds 5
    python3 dev/port_tracing.py cost

``readings`` runs the cell through ``benchmark/run.py``'s ``main``, with the
port's tracing on (``--port 1``: ``profiling.enable(True)`` before the run)
or off, and prints one JSON line: the run's result (its metrics and
breakdown) and, with tracing on, what the port recorded over the window
(set-up's record is drained and dropped): ``profiling.per_unit`` of it
(each span's milliseconds a unit, the counters a unit, the loader
workers' mean scene), the profiler ranges a unit, and in a traced run the
card's idle time in the profiled stretch and the part of it in no
``gapro.*`` range. The same seed with ``--port 0`` and ``--port 1`` shows
what the port's spans move; with ``--trace 0``, what they cost.

``syncs`` runs the cell (``--trace 0``) with every unit of its window under
``torch.cuda.set_sync_debug_mode("warn")`` and prints, as one JSON line,
each site in the port that made the host wait for the card: the innermost
frame of ``gapro_tpu_torch`` (else of ``benchmark``) on the warning's
stack, with its count and the units the window ran.

``cost`` times a span with tracing off, on, and on under a profiler.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _site(stack) -> str:
    """The innermost frame of the port, else of the benchmark."""
    for pkg in ("gapro_tpu_torch" + os.sep, "benchmark" + os.sep):
        for fr in reversed(stack):
            if pkg in fr.filename:
                rel = os.path.relpath(fr.filename, ROOT)
                return f"{rel}:{fr.lineno} {fr.name}"
    return "elsewhere"


def _run(argv) -> dict:
    """``benchmark/run.py``'s ``main`` on ``argv``; its result line."""
    from benchmark import run

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(argv)
    text = out.getvalue()
    sys.stderr.write(text)
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    if rc != 0 or not lines:
        raise SystemExit(f"benchmark run failed ({rc})")
    return json.loads(lines[-1])


def readings(args) -> dict:
    from benchmark import run
    from gapro_tpu_torch.utils import profiling

    kept = {}
    setup_done, after_window, end_profile = (run.Context.setup_done, run.Context.after_window,
                                             run.Context._end_profile)

    def setup_done_drained(self):
        setup_done(self)
        profiling.drain()

    def after_window_drained(self):
        after_window(self)
        kept["record"] = profiling.drain()

    def end_profile_kept(self, prof, prog):
        kept["prof"] = prof  # read after the run: its events take seconds to walk
        return end_profile(self, prof, prog)

    run.Context.setup_done = setup_done_drained
    run.Context.after_window = after_window_drained
    run.Context._end_profile = end_profile_kept
    profiling.enable(bool(args.port))
    result = _run(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                   str(args.seconds), "--trace", str(args.trace)])
    out = dict(mode="readings", workload=args.workload, seed=args.seed, trace=args.trace,
               port=args.port, result=result)
    if "prof" in kept:
        out["idle"] = profiling.idle_attribution(kept.pop("prof").events())
    rec = kept.get("record")
    if not args.port or rec is None:
        return out
    got = profiling.per_unit(rec, result["attempted"])
    got["ranges_a_unit"] = sum(s.pid == os.getpid() for s in rec["spans"]) / got["units"]
    out.update(got)
    return out


def cost(args) -> dict:
    """Microseconds a span: tracing off, on, and on under a profiler of the
    host and the card (a profiled stretch's ranges)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gapro_tpu_torch.utils import profiling

    def per_span_us(n=args.spans):
        t = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        return (time.perf_counter_ns() - t) / n / 1e3

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    out = dict(mode="cost", spans=args.spans, off_us=per_span_us())
    profiling.enable(True)
    out["on_us"] = per_span_us()
    with profile(activities=acts):
        out["on_profiled_us"] = per_span_us()
    profiling.enable(False)
    profiling.drain()
    return out


def syncs(args) -> dict:
    import torch

    from benchmark import run

    sites = collections.Counter()
    window = run.Context.window

    def watched(self, step, unit_scenes, prog):
        def one():
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return step()
            finally:
                torch.cuda.set_sync_debug_mode(0)

        return window(self, one, unit_scenes, prog)

    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            sites[_site(traceback.extract_stack()[:-1])] += 1
        else:
            shown(message, category, filename, lineno, file, line)

    run.Context.window = watched
    warnings.showwarning = show
    warnings.simplefilter("always")
    result = _run(["--workload", args.workload, "--seed", str(args.seed), "--seconds",
                   str(args.seconds), "--trace", "0"])
    return dict(mode="syncs", workload=args.workload, seed=args.seed,
                units=result["attempted"], correct=result["correct"],
                sites=sorted(sites.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("readings", "syncs", "cost"))
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--spans", type=int, default=20000, help="spans timed (cost)")
    ap.add_argument("--seconds", type=float, default=30)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--port", type=int, choices=(0, 1), default=1,
                    help="the port's own tracing on (readings)")
    args = ap.parse_args(argv)
    from benchmark import run

    run._environment()  # before torch is imported, as in benchmark/run.py
    out = dict(readings=readings, syncs=syncs, cost=cost)[args.mode](args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
