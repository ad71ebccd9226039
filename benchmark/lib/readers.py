"""Helpers of the per-layer metrics' readers. A reader gets the traced
run (``spans``, ``window``, ``profile``: the reduced trace of the
profiled stretch, ``tally``: the counting pass over the same units,
``window_peak``, ``config``, ``mix``) and returns a number, or None where
it finds nothing to read."""

from __future__ import annotations

import statistics


def span_ms(run, name: str):
    """The span's mean milliseconds a step or request over the window."""
    return run.spans.mean_ms(name)


def range_ms(run, name: str):
    """Device milliseconds a unit under the named range."""
    p = run.profile
    if not p or not p["units"]:
        return None
    s = p["range_device_s"].get(name, 0.0)
    return 1e3 * s / p["units"] if s > 0 else None


def roofline_pct(run, key: str, name: str):
    """The counted least time of ``key``'s calls over the device time under
    their range, in percent."""
    p, t = run.profile, run.tally
    if not p or not t or key not in t["totals"]:
        return None
    dev = p["range_device_s"].get(name, 0.0)
    least = t["totals"][key]["least_s"]
    if dev <= 0 or least <= 0:
        return None
    return 100.0 * least / dev


def mfu_pct(run):
    """The model's operations a unit over the window's time a unit at the
    config's peak, in percent."""
    t, w = run.tally, run.window
    if not t or not w["done"] or t["model_ops"] <= 0:
        return None
    per_unit_s = w["seconds"] / w["done"]
    return 100.0 * t["model_ops"] / (per_unit_s * run.config["peak"]["flops_per_s"])


def idle_pct(run):
    p = run.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


def peak_gib(run):
    return run.window_peak / 2 ** 30 if run.window_peak else None


def p95_ms(run):
    lat = run.window["latencies"]
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[18]
