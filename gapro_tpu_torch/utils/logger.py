"""Logging and scalar metrics (``gapro_tpu/utils/logger.py``; reference:
ISBNet/isbnet/util/logger.py).

The reference pairs a rank-0-gated python logger with a tensorboardX
SummaryWriter (:8-38). Here: the same rank gating over
``torch.distributed`` where a process group is initialised, and a
dependency-free JSONL scalar writer (loadable into pandas or tensorboard
offline). ``AverageMeter`` has util/utils.py:25-33's semantics.
"""

from __future__ import annotations

import json
import logging
import os
import os.path as osp
import time
from typing import Optional

import torch


def is_main_process() -> bool:
    """Rank 0 of the initialised process group, or the only process."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def get_logger(name: str = "gapro_tpu_torch", log_file: Optional[str] = None) -> logging.Logger:
    """A logger at INFO on the main process (WARNING elsewhere), printing to
    the console and, on the main process, to ``log_file`` too. A logger that
    has handlers already is returned as it is."""
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    main = is_main_process()
    logger.setLevel(logging.INFO if main else logging.WARNING)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and main:
        os.makedirs(osp.dirname(osp.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """JSONL scalar stream ``<log_dir>/scalars.jsonl``; every record:
    {step, tag, value, wall}. Only the main process writes."""

    def __init__(self, log_dir: str):
        self._f = None
        if is_main_process():
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(osp.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._f is None:
            return
        self._f.write(json.dumps(dict(step=int(step), tag=tag, value=float(value),
                                      wall=time.time())) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class AverageMeter:
    """Running average (util/utils.py:10-33)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
