"""Milliseconds a step in the AdamW update."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms(run, "optimizer")
