"""The 95th percentile of the traced window's request latencies."""

from benchmark.lib import readers


def read(run):
    return readers.p95_ms(run)
