"""The feed: the pool's scenes handed to the port's data loader.

``PoolDataset`` serves ``pool[sequence[i]]`` at dataset index ``i``; the
port's loader (``data/dataset.py:build_dataloader``) chooses the order.
Its training loader shuffles the indices with
``np.random.default_rng(seed + epoch)`` and augments index ``i`` with
``np.random.default_rng((seed + epoch) * 1_000_003 + i)``;
``loader_order`` and ``augment_seed`` are frozen copies of those two
rules, which the reference follows to augment the same scenes in the same
way.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np


def loader_order(n: int, seed: int, epoch: int, training: bool = True) -> np.ndarray:
    """The loader's dataset index at each position of an epoch."""
    order = np.arange(n)
    if training:
        np.random.default_rng(seed + epoch).shuffle(order)
    return order


def augment_seed(seed: int, epoch: int, index: int) -> int:
    """The seed of the loader's augmentation of dataset index ``index``."""
    return (seed + epoch) * 1_000_003 + int(index)


def voxel_cfg(cfg: dict) -> SimpleNamespace:
    """The config's voxel section as the loader reads it."""
    v = cfg["data"]["voxel"]
    return SimpleNamespace(scale=v["scale"], spatial_shape=tuple(v["spatial_shape"]),
                           max_npoint=v["max_npoint"], min_npoint=v["min_npoint"])


class PoolDataset:
    """A dataset whose index ``i`` is ``pool[sequence[i]]``."""

    def __init__(self, pool: list, sequence: list, cfg: dict):
        self.pool = pool
        self.sequence = list(sequence)
        self.voxel_cfg = voxel_cfg(cfg)

    def __len__(self):
        return len(self.sequence)

    def scan_id(self, index):
        return self.pool[self.sequence[index]]["scan_id"]

    def load(self, index) -> dict:
        return dict(self.pool[self.sequence[index]])
