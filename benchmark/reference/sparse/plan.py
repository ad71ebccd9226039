# Frozen copy of gapro_tpu_torch/sparse/plan.py; it does not follow later changes
# to the port.
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
* ``ConvTables``: what the conv kernels read besides the neighbour table,
  built from it on a level's first conv on the card and kept on the
  ``LevelPlan``: the row order and tile masks of K1 (``conv_row_order``,
  ``tile_masks``), and, on the first backward only, the per-offset pair
  lists of the dW kernel (``pair_lists``). Plain PyTorch at static shapes,
  with no host sync. None of them changes a table the JAX package has.
* ``window_level``: whether the JAX package gives a level window tables on
  a TPU. The port builds none, but keeps the flag on ``LevelPlan``: in the
  bf16 conv mode a window level's backward is the window kernel's (fp32),
  and another level's rounds where XLA's transpose rounds
  (``sparse/conv.py:SubmConvFn``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
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

KOFF = 27
def window_level(lvl: int, capacity: int) -> bool:
    """The TPU's test for window tables at level ``lvl``
    (gapro_tpu/sparse/plan.py: ``_tile_for`` and ``_build_unet_plan_jit``
    with ``use_window`` on, as ``window_conv_enabled()`` is on a TPU): a
    capacity that is a multiple of the level's tile and at least
    ``_TILE_FLOOR``."""
    tile = _TILES[lvl] if lvl < len(_TILES) else _DEFAULT_TILE
    if capacity % tile:
        tile = _DEFAULT_TILE
    return capacity % tile == 0 and capacity >= _TILE_FLOOR


# Output rows of one K1 block (csrc/subm_conv.cu: BM, wgmma's M).
TILE_ROWS = 64


def neighbour_masks(nbr: torch.Tensor) -> torch.Tensor:
    """[V] int32 whose bit k is set where ``nbr[i, k] >= 0``."""
    bits = torch.arange(KOFF, dtype=torch.int32, device=nbr.device)
    return ((nbr >= 0).to(torch.int32) << bits).sum(1, dtype=torch.int32)


def conv_row_order(nbr: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[V] int32, the order in which K1 computes the rows: valid rows first,
    stably sorted by their 27-bit neighbour mask, so that the rows of one
    tile share their empty offsets."""
    key = neighbour_masks(nbr) | ((~valid).to(torch.int32) << KOFF)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def tile_masks(nbr: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """[ceil(V / TILE_ROWS)] int32: the OR of the neighbour masks of the
    rows ``order`` puts in each tile; K1 skips the offsets not in it."""
    has = (nbr >= 0)[order.long()]
    pad = (-has.shape[0]) % TILE_ROWS
    if pad:
        has = torch.cat([has, has.new_zeros((pad, KOFF))])
    present = has.view(-1, TILE_ROWS, KOFF).any(1).to(torch.int32)
    bits = torch.arange(KOFF, dtype=torch.int32, device=nbr.device)
    return (present << bits).sum(1, dtype=torch.int32)


def pair_lists(nbr: torch.Tensor):
    """Per offset k, the rows i with a neighbour j = nbr[i, k], in increasing
    row order: (rows [27, V] int32, their neighbours [27, V] int32, counts
    [27] int32). Entries past an offset's count are 0. Built at fixed
    capacity: a cumsum of the [27, V] presence and one scatter."""
    v = nbr.shape[0]
    has = (nbr >= 0).T
    counts = has.sum(1, dtype=torch.int32)
    dest = torch.where(has, has.to(torch.int32).cumsum(1, dtype=torch.int32) - 1, v).long()
    rows = torch.arange(v, dtype=torch.int32, device=nbr.device).expand(KOFF, v)
    pi = torch.zeros((KOFF, v + 1), dtype=torch.int32, device=nbr.device)
    pj = torch.zeros_like(pi)
    pi.scatter_(1, dest, rows)
    pj.scatter_(1, dest, nbr.T.contiguous())
    return pi[:, :v].contiguous(), pj[:, :v].contiguous(), counts


class ConvTables:
    """The conv kernels' tables of one level, each built on first use and
    kept: ``rows()`` for K1, forward and dfeats alike (both gather through
    the same ``nbr``); ``pairs()`` for the dW kernel, so inference never
    builds them."""

    def __init__(self, nbr: torch.Tensor, valid: torch.Tensor):
        self.nbr, self.valid = nbr, valid
        self._rows = self._pairs = None

    def rows(self):
        """(order [V] int32, tile masks [ceil(V / TILE_ROWS)] int32)."""
        if self._rows is None:
            order = conv_row_order(self.nbr, self.valid)
            self._rows = (order, tile_masks(self.nbr, order))
        return self._rows

    def pairs(self):
        """``pair_lists(nbr)``."""
        if self._pairs is None:
            self._pairs = pair_lists(self.nbr)
        return self._pairs


@dataclass
class LevelPlan:
    grid: SparseGrid
    subm_nbr: torch.Tensor  # [V, 27] int32, -1 missing
    parent: Optional[torch.Tensor] = None  # [V] int32 row in the next level, -1
    offset_id: Optional[torch.Tensor] = None  # [V] int32 in [0, 8)
    down_child: Optional[torch.Tensor] = None  # [V_next, 8] int32, -1 absent
    dropped_next: int = 0  # coarse voxels dropped by the next capacity
    window: bool = False  # window tables on the TPU (window_level)
    conv: ConvTables = field(init=False, repr=False)  # built lazily, on the card only

    def __post_init__(self):
        self.conv = ConvTables(self.subm_nbr, self.grid.valid)


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
        window = window_level(lvl, g.capacity)
        if lvl < num_levels - 1:
            g_next, parent, offset_id, child, dropped = downsample_grid(g, caps[lvl + 1])
            levels.append(LevelPlan(grid=g, subm_nbr=nbr, parent=parent,
                                    offset_id=offset_id, down_child=child,
                                    dropped_next=dropped, window=window))
            g = g_next
        else:
            levels.append(LevelPlan(grid=g, subm_nbr=nbr, window=window))
    return UNetPlan(levels=levels)
