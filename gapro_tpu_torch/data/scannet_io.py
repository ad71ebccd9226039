"""ScanNet label conventions (numpy copy of the part of
``gapro_tpu/data/scannet_io.py`` the port needs)."""

from __future__ import annotations

import numpy as np


def remap_semantic_for_training(sem, label_shift: int = 2, background_class: int = 18):
    """Raw ScanNet semantics -> training ids: raw 2..19 foreground -> 0..17,
    raw 0/1 (wall/floor) -> ``background_class``, -100 stays ignore."""
    sem = np.asarray(sem).astype(np.int64)
    out = np.full_like(sem, -100)
    out[(sem >= 0) & (sem < label_shift)] = background_class
    fg = sem >= label_shift
    out[fg] = sem[fg] - label_shift
    return out
