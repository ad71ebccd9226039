# Frozen copy of gapro_tpu_torch/sparse/tensor.py; it does not follow later changes
# to the port.
"""Static-shape sparse voxel grid (``gapro_tpu/sparse/tensor.py``).

A fixed-capacity set of active voxels: coordinates, validity mask and a
static spatial shape. Valid coords are sorted lexicographically by
(batch, z, y, x) and occupy the first ``num_voxels`` rows. Features travel
separately; one grid serves every conv of its level.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class SparseGrid:
    coords: torch.Tensor  # [V, 4] int32 (b, z, y, x), -1 padded
    valid: torch.Tensor  # [V] bool
    num_voxels: int
    spatial_shape: Tuple[int, int, int]
    batch_size: int

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]
