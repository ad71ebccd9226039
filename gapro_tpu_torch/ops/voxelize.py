"""Voxelization as sort + unique (``gapro_tpu/ops/voxelize.py``).

``voxelize`` deduplicates integer (batch, z, y, x) coordinates into a
static-capacity voxel list in lexicographic (b, z, y, x) order, with a
point->voxel map and the first (lowest-index) member point of each voxel.
Voxel features are the mean over member points; labels come from the first
point.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import segment
from ..core.packing import KEY_MAX, pack_coords
from ..utils import profiling


class VoxelMaps(NamedTuple):
    voxel_coords: torch.Tensor  # [V, 4] int32 (b, z, y, x); padded rows = -1
    point2voxel: torch.Tensor  # [N] int32; -1 for invalid points
    voxel_first_point: torch.Tensor  # [V] int32; -1 padding
    num_voxels: int
    valid_voxel: torch.Tensor  # [V] bool
    overflow: int  # unique voxels dropped by the capacity


def voxelize(coords: torch.Tensor, extents, num_voxels: int,
             valid: Optional[torch.Tensor] = None) -> VoxelMaps:
    """Deduplicate [N, 4] int coords into at most ``num_voxels`` voxels;
    excess voxels are dropped from the end of the sort order."""
    n = coords.shape[0]
    dev = coords.device
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    key = pack_coords(coords, extents, valid=valid)
    skey, order = torch.sort(key, stable=True)
    s_valid = skey != KEY_MAX
    is_new = torch.ones_like(s_valid)
    is_new[1:] = skey[1:] != skey[:-1]
    is_new &= s_valid
    ranks = torch.cumsum(is_new.int(), 0) - 1
    nvox = int(profiling.to_host(is_new.sum(), "voxelize.count"))
    ranks = torch.where(s_valid & (ranks < num_voxels), ranks, -1).int()

    point2voxel = torch.empty(n, dtype=torch.int32, device=dev)
    point2voxel[order] = ranks
    point2voxel = torch.where(valid, point2voxel, -1)

    pt_idx = torch.arange(n, dtype=torch.int32, device=dev)
    first_pt = segment.segment_min(
        torch.where(point2voxel >= 0, pt_idx, torch.iinfo(torch.int32).max),
        point2voxel, num_voxels)
    nv = min(nvox, num_voxels)
    valid_voxel = torch.arange(num_voxels, device=dev) < nv
    first_pt = torch.where(valid_voxel, first_pt, -1)
    voxel_coords = torch.where(valid_voxel[:, None],
                               coords[first_pt.clamp(min=0).long()].int(), -1)
    return VoxelMaps(voxel_coords=voxel_coords, point2voxel=point2voxel,
                     voxel_first_point=first_pt, num_voxels=nv,
                     valid_voxel=valid_voxel, overflow=max(nvox - num_voxels, 0))


def voxel_feats_mean(feats, point2voxel, num_voxels: int):
    """Per-voxel mean of point features."""
    return segment.segment_mean(feats, point2voxel, num_voxels)


def voxel_gather_first(values, maps: VoxelMaps):
    """Per-voxel value taken from the first member point (for labels)."""
    out = values[maps.voxel_first_point.clamp(min=0).long()]
    mask = maps.valid_voxel.reshape((-1,) + (1,) * (out.ndim - 1))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device))


def devoxelize(voxel_feats, point2voxel):
    """Gather voxel features back to points, 0 where a point has no voxel
    (the reference's ``point_recover``, SPFormer/spformer/lib/pointgroup_ops/
    pointgroup_ops.py:80-115)."""
    out = voxel_feats[point2voxel.long().clamp(min=0)]
    mask = (point2voxel >= 0).reshape(point2voxel.shape + (1,) * (out.ndim - 1))
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device))
