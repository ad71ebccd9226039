"""The share of the profiled stretch in which no device operation ran."""

from benchmark.lib import readers


def read(run):
    return readers.idle_pct(run)
