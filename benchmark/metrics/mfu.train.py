"""The model's operations a step (3 x the forward) over the window's time a step at the config's peak."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
