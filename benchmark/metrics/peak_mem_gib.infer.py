"""The device's peak allocated memory over the window."""

from benchmark.lib import readers


def read(run):
    return readers.peak_gib(run)
