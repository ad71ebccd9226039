"""Milliseconds a step from the forward's end to targets and matching's (the trainer's on_stage marks)."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms(run, "targets")
