"""K5's share of its roofline (TF32 operations or bytes) under the mask head's entry."""

from benchmark.lib import readers


def read(run):
    return readers.roofline_pct(run, "dyco", "bench.dyco")
