"""Milliseconds a request in the port's span x4.merge: the x4 batch's voxel of each point taken
into the room's point order (``room_point2voxel``); the masks' encoding in that order is counted
under ``instances_ms.infer``."""

from benchmark.lib import readers


def read(run):
    return readers.span_ms(run, "x4.merge")
