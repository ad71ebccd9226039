"""Profiling: ``torch.profiler`` traces and named step and region
annotations (``gapro_tpu/utils/profiling.py``, which uses ``jax.profiler``).

The reference has only wall-clock AverageMeters and
``torch.cuda.max_memory_allocated`` logging (ISBNet/tools/train.py:55-99,
isbnet/util/utils.py:151-157). ``trace(dir)`` captures the host and the
card (CPU and CUDA activities) into a Chrome trace, ``annotate(name)`` and
``step_annotation(step)`` mark regions in it, and ``device_memory_stats``
reports the card's memory in use.

Usage:
    with profiling.trace("runs/x/trace"):      # or tools/train.py --profile N
        step(...)
    with profiling.annotate("gp_fit"):
        ...
"""

from __future__ import annotations

import contextlib
import logging
import os
import os.path as osp
from typing import Optional

import torch

log = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    to ``<log_dir>/trace.json``. ``cuda`` adds the card's activity (default:
    where a card is available). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    path = osp.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def annotate(name: str):
    """A named region in the trace (``record_function``)."""
    return torch.profiler.record_function(name)


def step_annotation(step: int):
    """Mark a training step in the trace."""
    return torch.profiler.record_function(f"train step {int(step)}")


def device_memory_stats(device=None) -> dict:
    """The card's memory in bytes under the JAX names where they have a
    counterpart: ``bytes_in_use`` (allocated), ``peak_bytes_in_use`` (the
    peak allocated), ``bytes_limit`` (the card's total memory), and
    ``bytes_reserved`` (the caching allocator's reserve, which JAX does not
    report). {} for the CPU or where no card is available."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(dev or torch.cuda.current_device())
        .total_memory,
        "bytes_reserved": stats.get("reserved_bytes.all.current", 0),
    }
