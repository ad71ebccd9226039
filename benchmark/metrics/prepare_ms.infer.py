"""Milliseconds a request in make_prepare's prepare (voxelize, plan), to the device's sync."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms(run, "prepare")
