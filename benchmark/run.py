#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload isbnet_scannet.train --seed 7 --seconds 30 --trace 0

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``benchmark/configs/<config>.json``) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``kind`` picks the driver
(``benchmark/drivers/<kind>.py``). With ``--trace 0`` the result holds the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, each
read by ``benchmark/metrics/<metric>.py`` from the run's spans, the
profiler's trace of a short stretch of the window and the counting pass
after it. The port (``gapro_tpu_torch``) is the system under test; the
plain reference under ``benchmark/reference/`` decides ``correct``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX behind torch's
    optional imports; one thread a process for numpy's and torch's CPU
    work (the loader's forked workers inherit it, as PyTorch's own
    DataLoader workers take one), so that the workers and the main process
    share the cores steadily."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_reader(name: str):
    path = os.path.join(ROOT, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Context:
    """What a driver gets: the cell's config, mix, seed and device, the
    spans, and the window, set-up and counting steps shared by every kind."""

    def __init__(self, config, mix, seed, seconds, trace, device, chips):
        import torch

        from benchmark.lib.harness import Spans

        self.torch = torch
        self.config, self.mix, self.seed, self.seconds = config, mix, seed, seconds
        self.trace, self.device, self.chips = bool(trace), device, chips
        self.spans = Spans(device, sync=self.trace)
        self.setup_s = None
        self.setup_peak = 0
        self.window_peak = 0
        self.kept = []
        self.profile = None
        self.tally = None
        self.probes = None

    def note(self, what: str) -> None:
        """A set-up stage's end on the host clock, on standard error."""
        print(f"set-up: {what} at {time.perf_counter() - T_START:.3f} s", file=sys.stderr,
              flush=True)

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self._sync()
        self.setup_s = time.perf_counter() - T_START
        if self.device.type == "cuda":
            self.setup_peak = self.torch.cuda.max_memory_allocated(self.device)
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def window(self, step, unit_scenes: int, prog) -> dict:
        """Run ``step`` until ``seconds`` have passed; in a traced run
        profile the steps ``profile.skip`` .. ``+ profile.units``."""
        from torch.profiler import ProfilerActivity, profile

        if self.trace:
            from benchmark.lib.probes import Probes

            self.probes = Probes(backward=self.mix["kind"] == "train").install(prog.model)
        prof_cfg = self.mix.get("profile", {"skip": 2, "units": 3})
        p0, p1 = prof_cfg["skip"], prof_cfg["skip"] + prof_cfg["units"]
        prof, tp = None, [None, None]
        attempted = failed = done = streak = 0
        latencies = []
        self._sync()
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        while time.perf_counter() < deadline and streak < 3:
            if self.trace and attempted == p0 and prof is None:
                self._sync()
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.__enter__()
                prog.kept = []
                tp[0] = time.perf_counter()
            ts = time.perf_counter()
            try:
                _, ok = step()
                streak = 0
            except StopIteration:
                raise
            except Exception:  # a failed step or request counts against attempted
                print(f"unit {attempted} failed:", file=sys.stderr)
                traceback.print_exc()
                ok = False
                streak += 1
            latencies.append(time.perf_counter() - ts)
            attempted += 1
            done += bool(ok)
            failed += not ok
            if prof is not None and tp[1] is None and attempted == p1:
                tp[1] = self._end_profile(prof, prog)
        self._sync()
        t1 = time.perf_counter()
        if prof is not None and tp[1] is None:
            tp[1] = self._end_profile(prof, prog)
        if prof is not None:
            self.profile = dict(prof=prof, window_s=tp[1] - tp[0], units=len(self.kept))
        return dict(seconds=t1 - t0, attempted=attempted, failed=failed, done=done,
                    scenes=done * unit_scenes, latencies=latencies)

    def _end_profile(self, prof, prog) -> float:
        self._sync()
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        self.kept, prog.kept = prog.kept, None
        return t

    def after_window(self) -> None:
        self._sync()
        if self.device.type == "cuda":
            self.window_peak = self.torch.cuda.max_memory_allocated(self.device)

    def count_pass(self, model, thunks: list, backward: bool, dense_passes: int) -> None:
        """Operations and bytes of the profiled units, run again with the
        probes counting; ``dense_passes`` times the dense layers' forward
        (3 for a training step: the forward and the backward's two)."""
        with self.probes.count() as pr:
            for t in thunks:
                t()
        n = max(len(thunks), 1)
        tally = {k: dict(v) for k, v in pr.tally.items()}
        per = {k: {kk: vv / n for kk, vv in v.items()} for k, v in tally.items()}
        model_ops = per.get("conv", {}).get("ops", 0.0) + dense_passes * (
            per.get("dense", {}).get("ops", 0.0) + per.get("dyco", {}).get("ops", 0.0))
        self.tally = dict(per_unit=per, model_ops=model_ops, units=len(thunks),
                          totals=tally)
        self.probes.remove()


def reduce_profile(ctx) -> dict:
    from benchmark.lib import probes, trace

    prof = ctx.profile["prof"]
    red = trace.reduce(prof.events(), ranges=(probes.CONV, probes.FPS, probes.DYCO,
                                              probes.DECODER))
    red["window_s"] = ctx.profile["window_s"]
    red["units"] = ctx.profile["units"]
    return red


def run_cell(cell: dict, config: dict, mix: dict, metrics: dict, seed: int, seconds: float,
             trace: int, device) -> tuple:
    """One run of ``cell``: (the result dict, the checks)."""
    import types

    from benchmark.lib import harness

    ctx = Context(config, mix, seed, seconds, trace, device, cell["chips"])
    driver = importlib.import_module("benchmark.drivers." + mix["kind"])
    out = driver.run(ctx)
    w, numbers = out["window"], out["numbers"]
    limits = config["limits"][mix["kind"]]
    checks = []
    for name, limit in limits.items():
        value = numbers[name]
        checks.append(dict(name=name, value=value, limit=limit,
                           ok=bool(value <= limit)))
    if "checked_steps_ok" in numbers:
        checks.append(dict(name="checked_steps_finite", value=int(numbers["checked_steps_ok"]),
                           limit=1, ok=bool(numbers["checked_steps_ok"])))
    correct = all(c["ok"] for c in checks)
    dev = harness.device_info(device, cell["chips"])
    dev["memory_peak_bytes"] = int(max(ctx.setup_peak, ctx.window_peak))
    result = dict(correct=correct, attempted=w["attempted"], failed=w["failed"], metrics={},
                  device=dev)
    name = cell["name"]
    if not trace:
        for m in metrics["end_to_end"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            if m["name"] == "setup_s":
                result["metrics"][m["name"]] = harness.metric(ctx.setup_s, m["unit"])
            elif m["name"] == mix["metric"]:
                result["metrics"][m["name"]] = harness.metric(w["scenes"] / w["seconds"],
                                                              m["unit"])
    else:
        red = reduce_profile(ctx) if ctx.profile else None
        run = types.SimpleNamespace(spans=ctx.spans, window=w, profile=red, tally=ctx.tally,
                                    window_peak=ctx.window_peak, config=config, mix=mix)
        for m in metrics["per_layer"]:
            if "workloads" in m and name not in m["workloads"]:
                continue
            v = load_reader(m["name"])(run)
            if v is not None:
                result["metrics"][m["name"]] = harness.metric(v, m["unit"])
        if red is not None:
            result["device"].update(busy_s=red["busy_s"], window_s=red["window_s"])
            result["breakdown"] = dict(device_ops=red["top_ops"], idle_gaps=red["idle_gaps"])
    print("numbers compared:", json.dumps({k: v for k, v in numbers.items()}), flush=True)
    return result, checks


def main(argv=None) -> int:
    _environment()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = manifest()
    cell = find(man["workloads"], args.workload, "workload")
    config_entry = find(man["configs"], cell["config"], "config")
    with open(os.path.join(ROOT, config_entry["file"])) as f:
        config = json.load(f)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from benchmark.lib import harness, traffic

    mix = traffic.load_json("traffic", cell["traffic"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checks = run_cell(cell, config, mix, man, args.seed, args.seconds, args.trace,
                              device)
    print("card:", harness.card_line(), flush=True)
    bad = harness.loaded_forbidden()
    if bad:
        print(f"modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
