"""Milliseconds a step from the targets' end to the backward's."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms(run, "backward")
