"""Point cloud -> voxel batch (``gapro_tpu/models/prepare.py``).

``points_to_batch_np`` is the host collate (numpy). ``prepare_voxel_batch``
runs on the device: voxelize by sort + unique, mean-pool features, take
labels from the first point, compact superpoint ids and build the U-Net
plan. ``pack_point_batch_np`` / ``unpack_point_batch`` carry one scene in
one [N, 17] buffer, the data-parallel step's input, and ``packed_prepare``
is that step's ``prepare_fn``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.bucketing import next_bucket
from ..core.segment import compact_unique, segment_count
from ..device import resolve_device
from ..ops.voxelize import voxel_feats_mean, voxel_gather_first, voxelize
from ..sparse.plan import build_unet_plan
from ..sparse.tensor import SparseGrid
from ..utils import profiling
from .isbnet import VoxelBatch

# generous static bounds: z < 1024, y/x < 16384
EXTENTS = (1024, 16384, 16384)


class PointBatch(NamedTuple):
    """Padded point-level arrays (numpy on the host, tensors on the device)."""

    coords: object  # [N, 4] int32 (batch, z, y, x)
    coords_float: object  # [N, 3]
    feats: object  # [N, 3] rgb
    spp: object  # [N] int32 raw superpoint ids (globally offset)
    valid: object  # [N] bool
    semantic: object  # [N] int32 (-100 ignore)
    instance: object  # [N] int32 (-100 ignore)
    prob: object  # [N]
    mu: object  # [N]
    var: object  # [N]


def points_to_batch_np(scenes, voxel_scale=50, n_cap=None) -> PointBatch:
    """Host collate: list of per-scene dicts (xyz, rgb, spp and optional
    semantic/instance/prob/mu/var) -> padded numpy PointBatch. Coords are
    floor(xyz * scale) shifted to min 0 per scene, batch index in column 0,
    superpoint ids offset per scene."""
    coords_l, cf_l, rgb_l, spp_l, sem_l, inst_l = [], [], [], [], [], []
    prob_l, mu_l, var_l = [], [], []
    spp_offset = 0
    inst_offset = 0
    for b, sc in enumerate(scenes):
        xyz = np.asarray(sc["xyz"], np.float32)
        n = len(xyz)
        if "xyz_scaled" in sc:
            c = np.floor(np.asarray(sc["xyz_scaled"], np.float64)).astype(np.int64)
        else:
            c = np.floor(xyz * voxel_scale).astype(np.int64)
        c -= c.min(0)
        coords_l.append(np.concatenate([np.full((n, 1), b, np.int64), c[:, ::-1]], axis=1))
        cf_l.append(xyz)
        rgb_l.append(np.asarray(sc["rgb"], np.float32))
        _, spp_c = np.unique(np.asarray(sc["spp"]), return_inverse=True)
        spp_l.append(spp_c + spp_offset)
        spp_offset += spp_c.max() + 1
        sem = np.asarray(sc.get("semantic", np.full(n, -100)), np.int32)
        inst = np.asarray(sc.get("instance", np.full(n, -100)), np.int32).copy()
        if inst.max() >= 0:
            inst[inst >= 0] += inst_offset
            inst_offset = int(inst.max()) + 1
        sem_l.append(sem)
        inst_l.append(inst)
        prob_l.append(np.asarray(sc.get("prob", np.ones(n)), np.float32))
        mu_l.append(np.asarray(sc.get("mu", np.full(n, -100.0)), np.float32))
        var_l.append(np.asarray(sc.get("var", np.full(n, -100.0)), np.float32))

    coords = np.concatenate(coords_l, 0)
    n_total = len(coords)
    cap = n_cap or next_bucket(n_total)
    pad = cap - n_total

    def padded(lst, fill=0):
        x = np.concatenate(lst, 0)
        return np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)

    return PointBatch(
        coords=np.pad(coords, [(0, pad), (0, 0)], constant_values=-1).astype(np.int32),
        coords_float=padded(cf_l),
        feats=padded(rgb_l),
        spp=padded(spp_l, -1).astype(np.int32),
        valid=np.arange(cap) < n_total,
        semantic=padded(sem_l, -100),
        instance=padded(inst_l, -100),
        prob=padded(prob_l),
        mu=padded(mu_l, -100.0),
        var=padded(var_l, -100.0),
    )


class PreparedBatch(NamedTuple):
    batch: VoxelBatch
    point2voxel: torch.Tensor  # [N]
    voxel_semantic: torch.Tensor  # [V]
    voxel_instance: torch.Tensor
    voxel_prob: torch.Tensor
    voxel_mu: torch.Tensor
    voxel_var: torch.Tensor
    voxel_rgb: torch.Tensor  # [V, 3]


def upload_point_batch(pb: PointBatch, device=None) -> PointBatch:
    """numpy PointBatch -> tensors on ``device`` (``cuda`` unless named);
    the span ``prepare.upload``, its bytes under ``h2d_bytes``."""
    dev = resolve_device(device)
    with profiling.span("prepare.upload"):
        host = [torch.as_tensor(np.asarray(a)) for a in pb]
        if dev.type != "cpu":
            profiling.count("h2d_bytes", sum(t.numel() * t.element_size() for t in host))
        return PointBatch(*(t.to(dev) for t in host))


# One [N, 17] float32 buffer carries a whole PointBatch exactly (integers
# below 2^24 and the -100 sentinels are exact in fp32): the data-parallel
# step's input, one scene a rank.
_PACK_COLS = 17


def pack_point_batch_np(pb: PointBatch) -> np.ndarray:
    """Host: a numpy PointBatch -> one [N, 17] float32 buffer."""
    buf = np.empty((pb.coords.shape[0], _PACK_COLS), np.float32)
    buf[:, 0:4] = pb.coords
    buf[:, 4:7] = pb.coords_float
    buf[:, 7:10] = pb.feats
    buf[:, 10] = pb.spp
    buf[:, 11] = pb.valid
    buf[:, 12] = pb.semantic
    buf[:, 13] = pb.instance
    buf[:, 14] = pb.prob
    buf[:, 15] = pb.mu
    buf[:, 16] = pb.var
    return buf


def unpack_point_batch(buf: torch.Tensor) -> PointBatch:
    """An [N, 17] buffer -> PointBatch on the buffer's device."""
    return PointBatch(
        coords=buf[:, 0:4].to(torch.int32), coords_float=buf[:, 4:7].contiguous(),
        feats=buf[:, 7:10].contiguous(),
        spp=buf[:, 10].to(torch.int32), valid=buf[:, 11] > 0.5,
        semantic=buf[:, 12].to(torch.int32), instance=buf[:, 13].to(torch.int32),
        prob=buf[:, 14], mu=buf[:, 15], var=buf[:, 16])


def prepare_voxel_batch(pb: PointBatch, voxel_cap: int, batch_size: int,
                        num_levels: int = 7, spp_cap: int = 8192,
                        shrink=0.5) -> PreparedBatch:
    """Voxelize a device PointBatch and build its U-Net plan; runs where the
    tensors of ``pb`` lie (see ``upload_point_batch``). Spans
    ``prepare.voxelize`` (the voxels and their features and labels) and
    ``prepare.plan``."""
    with profiling.span("prepare.voxelize"):
        maps = voxelize(pb.coords, EXTENTS, voxel_cap, valid=pb.valid)
        rgb = voxel_feats_mean(pb.feats, maps.point2voxel, voxel_cap)
        coords_float = voxel_feats_mean(pb.coords_float, maps.point2voxel, voxel_cap)
        label = lambda v: torch.where(maps.valid_voxel, voxel_gather_first(v, maps), -100)
        _, spp_compact, _ = compact_unique(voxel_gather_first(pb.spp, maps), spp_cap,
                                           valid=maps.valid_voxel)
        labels = dict(voxel_semantic=label(pb.semantic), voxel_instance=label(pb.instance),
                      voxel_prob=voxel_gather_first(pb.prob, maps),
                      voxel_mu=voxel_gather_first(pb.mu, maps),
                      voxel_var=voxel_gather_first(pb.var, maps))
        batch_idx = maps.voxel_coords[:, 0].clamp(min=0)
        vox_npoints = segment_count(maps.point2voxel, voxel_cap)
    with profiling.span("prepare.plan"):
        grid = SparseGrid(coords=maps.voxel_coords, valid=maps.valid_voxel,
                          num_voxels=maps.num_voxels, spatial_shape=EXTENTS,
                          batch_size=batch_size)
        plan = build_unet_plan(grid, num_levels, shrink)
    batch = VoxelBatch(
        feats=rgb, coords_float=coords_float, batch_idx=batch_idx, valid=maps.valid_voxel,
        spp=spp_compact, plan=plan, batch_size=batch_size, n_spp=spp_cap,
        vox_npoints=vox_npoints)
    return PreparedBatch(batch=batch, point2voxel=maps.point2voxel, voxel_rgb=rgb, **labels)


def packed_prepare(num_levels: int, spp_cap: int, shrink) -> Callable:
    """The data-parallel step's ``prepare_fn``: one scene's packed [N, 17]
    buffer (``pack_point_batch_np``) -> its ``PreparedBatch``, where the
    buffer lies, with the buffer's length as the voxel capacity, batch 1."""
    return lambda buf: prepare_voxel_batch(unpack_point_batch(buf), buf.shape[0], 1, num_levels,
                                           spp_cap, shrink)
