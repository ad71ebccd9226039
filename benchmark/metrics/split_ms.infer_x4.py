"""Milliseconds a request in the port's span x4.split: the room split into its 4 pieces and collated."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms(run, "x4.split")
