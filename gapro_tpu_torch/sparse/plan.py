"""Rulebook construction for the sparse U-Net (``gapro_tpu/sparse/plan.py``).

* ``subm_neighbor_table``: for each active voxel and each of the 27 offsets
  of a 3x3x3 window, the row of the neighbouring active voxel or -1. The
  grid's keys are already sorted, so one ``searchsorted`` per offset finds
  them exactly (the JAX package's merge-sort formulation gives the same
  table).
* ``downsample_grid``: the stride-2 coarse grid = unique(coords // 2), each
  fine voxel's parent and its offset (z%2, y%2, x%2) inside it, and the
  [V_next, 8] child table the down conv gathers through.
* ``build_unet_plan``: every level at once, with level capacities rounded as
  the JAX package rounds them, so that every shape matches. The TPU's
  window tables and z/y-pack tables are not built: no kernel here needs
  them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..core.packing import KEY_MAX, pack_coords, sorted_lookup
from ..ops.voxelize import voxelize
from .tensor import SparseGrid

SUBM_OFFSETS = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]

# Level capacities follow the JAX package's window-tile schedule
# (gapro_tpu/sparse/plan.py:_window_tile_schedule with its defaults): the
# level after a capacity >= 8192 is rounded to 512 at level 1 and to 256
# elsewhere. Copied so that every capacity, and so every shape, matches.
_TILES = (256, 512)
_DEFAULT_TILE = 256
_TILE_FLOOR = 8192


@dataclass
class LevelPlan:
    grid: SparseGrid
    subm_nbr: torch.Tensor  # [V, 27] int32, -1 missing
    parent: Optional[torch.Tensor] = None  # [V] int32 row in the next level, -1
    offset_id: Optional[torch.Tensor] = None  # [V] int32 in [0, 8)
    down_child: Optional[torch.Tensor] = None  # [V_next, 8] int32, -1 absent
    dropped_next: int = 0  # coarse voxels dropped by the next capacity


@dataclass
class UNetPlan:
    levels: List[LevelPlan]

    @property
    def ovf_window_escapees(self) -> int:
        # the TPU window kernel's escapee counter; no window tables here
        return 0


def subm_neighbor_table(grid: SparseGrid) -> torch.Tensor:
    """[V, 27] int32 neighbour rows for a 3x3x3 submanifold conv. All 27
    offsets are formed at once ([V, 27, 3]): a loop over them costs a few
    hundred small launches a level."""
    Z, Y, X = grid.spatial_shape
    keys = pack_coords(grid.coords, grid.spatial_shape, valid=grid.valid)
    c = grid.coords.long()
    q = c[:, None, 1:] + torch.tensor(SUBM_OFFSETS, device=c.device)  # [V, 27, 3] (z, y, x)
    inside = ((q >= 0) & (q < torch.tensor([Z, Y, X], device=c.device))).all(-1)
    key = ((c[:, 0, None] * Z + q[..., 0]) * Y + q[..., 1]) * X + q[..., 2]
    return sorted_lookup(keys, torch.where(grid.valid[:, None] & inside, key, KEY_MAX))


def downsample_grid(grid: SparseGrid, out_capacity: int
                    ) -> Tuple[SparseGrid, torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Stride-2 kernel-2 downsample: (coarse grid, parent, offset_id,
    child table, dropped)."""
    coarse = torch.cat([grid.coords[:, :1], torch.div(grid.coords[:, 1:], 2,
                                                      rounding_mode="floor")], 1)
    coarse = torch.where(grid.valid[:, None], coarse, -1)
    Z, Y, X = grid.spatial_shape
    out_shape = ((Z + 1) // 2, (Y + 1) // 2, (X + 1) // 2)
    maps = voxelize(coarse, out_shape, out_capacity, valid=grid.valid)
    out_grid = SparseGrid(coords=maps.voxel_coords, valid=maps.valid_voxel,
                          num_voxels=maps.num_voxels, spatial_shape=out_shape,
                          batch_size=grid.batch_size)
    rem = torch.where(grid.valid[:, None], grid.coords[:, 1:] % 2, 0)
    offset_id = (rem[:, 0] * 4 + rem[:, 1] * 2 + rem[:, 2]).int()
    parent = maps.point2voxel
    child = torch.full((out_capacity, 8), -1, dtype=torch.int32, device=parent.device)
    has = parent >= 0
    child[parent[has].long(), offset_id[has].long()] = torch.arange(
        grid.capacity, dtype=torch.int32, device=parent.device)[has]
    return out_grid, parent, offset_id, child, maps.overflow


def level_capacities(capacity: int, num_levels: int, shrink) -> List[int]:
    """The capacity of every level, rounded as the JAX package rounds it."""
    if isinstance(shrink, (tuple, list)):
        if len(shrink) != num_levels - 1:
            raise ValueError(f"per-level shrink schedule needs {num_levels - 1} "
                             f"factors, got {len(shrink)}")
        shrink = tuple(float(s) for s in shrink)
    else:
        shrink = (float(shrink),) * (num_levels - 1)
    caps = [capacity]
    for lvl in range(num_levels - 1):
        cap = caps[-1]
        scaled = int(cap * shrink[lvl])
        nt = (_TILES[lvl + 1] if lvl + 1 < len(_TILES) and scaled >= _TILE_FLOOR
              else _DEFAULT_TILE)
        out = max(scaled, nt)
        caps.append((out + nt - 1) // nt * nt)
    return caps


def build_unet_plan(grid: SparseGrid, num_levels: int, shrink=0.5) -> UNetPlan:
    """Neighbour tables and down maps for all U-Net levels. Overflow drops
    the tail of the coarse sort order deterministically and is counted in
    ``dropped_next``."""
    caps = level_capacities(grid.capacity, num_levels, shrink)
    levels = []
    g = grid
    for lvl in range(num_levels):
        nbr = subm_neighbor_table(g)
        if lvl < num_levels - 1:
            g_next, parent, offset_id, child, dropped = downsample_grid(g, caps[lvl + 1])
            levels.append(LevelPlan(grid=g, subm_nbr=nbr, parent=parent,
                                    offset_id=offset_id, down_child=child,
                                    dropped_next=dropped))
            g = g_next
        else:
            levels.append(LevelPlan(grid=g, subm_nbr=nbr))
    return UNetPlan(levels=levels)
