"""The model's operations a request over the window's time a request at the config's peak."""

from benchmark.lib import readers


def read(run):
    return readers.mfu_pct(run)
