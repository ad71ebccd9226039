"""The sparse convs' share of their roofline: their counted least time over the device time under the conv entry points' ranges."""

from benchmark.lib import readers


def read(run):
    return readers.roofline_pct(run, "conv", "bench.conv")
