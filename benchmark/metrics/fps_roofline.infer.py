"""K4's share of its roofline (fp32 operations or bytes) under ops/fps.py's entry."""

from benchmark.lib import readers


def read(run):
    return readers.roofline_pct(run, "fps", "bench.fps")
