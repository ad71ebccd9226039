"""Milliseconds a request in infer_scene_instances, the records on the host."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms(run, "instances")
