"""Milliseconds a step waits for the loader's next batch."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms(run, "data_wait")
