"""Point cloud -> voxel batch (``gapro_tpu/models/prepare.py``).

``points_to_batch_np`` is the host collate (numpy, one pass into the
batch's padded fields). ``prepare_voxel_batch`` runs on the device:
voxelize by sort + unique, mean-pool features, take labels from the first
point, compact superpoint ids and build the U-Net plan.
``pack_point_batch_np`` / ``unpack_point_batch`` carry one scene in one
[N, 17] buffer, the data-parallel step's input, and ``packed_prepare`` is
that step's ``prepare_fn``.
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


# A scene's superpoint ids are ranked through a table of the ids present
# where their range is at most this many times its point count, else sorted.
_SPP_TABLE_SPAN = 4


def _compact_spp(spp: np.ndarray, out: np.ndarray, offset: int, scratch: np.ndarray) -> int:
    """Write each id's rank among the scene's distinct ids (``np.unique``'s
    inverse) plus ``offset`` into ``out``; return the number of distinct
    ids. Dense integer ids mark a table over [min, max], whose running sum
    is the rank (counted ``collate.spp_dense``); sparse or huge ids take
    the sort (``collate.spp_sorted``). ``scratch`` is int64, at least as
    long as ``spp``."""
    n = len(spp)
    if spp.dtype.kind in "iu" and n:
        lo, hi = spp.min(), spp.max()
        span = int(hi) - int(lo) + 1
        if span <= _SPP_TABLE_SPAN * n:
            idx = np.subtract(spp, lo, out=scratch[:n], casting="unsafe")  # in [0, span)
            present = np.zeros(span, bool)
            present[idx] = True
            rank = np.cumsum(present, dtype=np.int32)
            rank += offset - 1
            np.take(rank, idx, out=out, mode="clip")  # idx is in range
            profiling.count("collate.spp_dense")
            return int(rank[-1]) + 1 - offset
    _, inverse = np.unique(spp, return_inverse=True)
    np.add(inverse, offset, out=out, casting="unsafe")
    profiling.count("collate.spp_sorted")
    return int(inverse.max()) + 1


def points_to_batch_np(scenes, voxel_scale=50, n_cap=None) -> PointBatch:
    """Host collate: list of per-scene dicts (xyz, rgb, spp and optional
    semantic/instance/prob/mu/var) -> padded numpy PointBatch. Coords are
    floor(xyz * scale) shifted to min 0 per scene, batch index in column 0,
    superpoint ids offset per scene.

    One pass: the capacity comes from the scenes' lengths, each field is
    allocated once at it in its final dtype with the padding written only
    into the tail, and each scene is cast straight into its rows. A
    scene's coordinates are quantised an axis at a time through int64
    (``xyz_scaled`` floored in float64, else ``xyz * voxel_scale`` in
    float32's arithmetic). Its superpoint ids become their ranks among its
    distinct ids (``_compact_spp``), offset by the distinct ids of the
    scenes before it; instance ids >= 0 are shifted past the previous
    scenes' largest. Field for field equal to the JAX package's
    concatenate-and-pad collate."""
    lens = [len(sc["xyz"]) for sc in scenes]
    n_total = sum(lens)
    cap = n_cap or next_bucket(n_total)
    if cap < n_total:
        raise ValueError(f"{n_total} points do not fit a capacity of {cap}")

    def field(shape, dtype, fill):
        a = np.empty((cap,) + tuple(shape), dtype)
        a[n_total:] = fill
        return a

    pb = PointBatch(
        coords=field((4,), np.int32, -1), coords_float=field((3,), np.float32, 0),
        feats=field(np.shape(scenes[0]["rgb"])[1:], np.float32, 0),
        spp=field((), np.int32, -1), valid=field((), bool, False),
        semantic=field((), np.int32, -100), instance=field((), np.int32, -100),
        prob=field((), np.float32, 0), mu=field((), np.float32, -100.0),
        var=field((), np.float32, -100.0))
    pb.valid[:n_total] = True
    product = np.empty(max(lens))
    scratch = np.empty(max(lens), np.int64)
    o = spp_offset = inst_offset = 0
    for b, (sc, n) in enumerate(zip(scenes, lens)):
        rows = slice(o, o + n)
        xyz = pb.coords_float[rows]
        xyz[:] = sc["xyz"]
        coords = pb.coords[rows]
        coords[:, 0] = b
        scaled = np.asarray(sc["xyz_scaled"]) if "xyz_scaled" in sc else None
        c = scratch[:n]
        for axis in range(3):  # x, y, z -> columns 3, 2, 1
            if scaled is not None:
                np.floor(scaled[:, axis], out=c, dtype=np.float64, casting="unsafe")
            else:
                np.floor(np.multiply(xyz[:, axis], voxel_scale, out=product[:n]), out=c,
                         casting="unsafe")
            np.subtract(c, c.min(), out=coords[:, 3 - axis], casting="unsafe")
        pb.feats[rows] = sc["rgb"]
        spp_offset += _compact_spp(np.asarray(sc["spp"]), pb.spp[rows], spp_offset, scratch)
        pb.semantic[rows] = sc.get("semantic", -100)
        inst = pb.instance[rows]
        inst[:] = sc.get("instance", -100)
        top = int(inst.max())
        if top >= 0:
            if inst_offset:
                shift = np.greater_equal(inst, 0, out=c)
                shift *= inst_offset
                inst += shift
                top = int(inst.max())
            inst_offset = top + 1
        pb.prob[rows] = sc.get("prob", 1.0)
        pb.mu[rows] = sc.get("mu", -100.0)
        pb.var[rows] = sc.get("var", -100.0)
        o += n
    return pb


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
    ``prepare.plan``. The voxels' superpoint ids past ``spp_cap`` are counted
    in the batch's ``ovf_spp_ids``."""
    with profiling.span("prepare.voxelize"):
        maps = voxelize(pb.coords, EXTENTS, voxel_cap, valid=pb.valid)
        rgb = voxel_feats_mean(pb.feats, maps.point2voxel, voxel_cap)
        coords_float = voxel_feats_mean(pb.coords_float, maps.point2voxel, voxel_cap)
        label = lambda v: torch.where(maps.valid_voxel, voxel_gather_first(v, maps), -100)
        _, spp_compact, n_spp_ids = compact_unique(voxel_gather_first(pb.spp, maps), spp_cap,
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
        vox_npoints=vox_npoints, ovf_spp_ids=max(n_spp_ids - spp_cap, 0))
    return PreparedBatch(batch=batch, point2voxel=maps.point2voxel, voxel_rgb=rgb, **labels)


def packed_prepare(num_levels: int, spp_cap: int, shrink) -> Callable:
    """The data-parallel step's ``prepare_fn``: one scene's packed [N, 17]
    buffer (``pack_point_batch_np``) -> its ``PreparedBatch``, where the
    buffer lies, with the buffer's length as the voxel capacity, batch 1."""
    return lambda buf: prepare_voxel_batch(unpack_point_batch(buf), buf.shape[0], 1, num_levels,
                                           spp_cap, shrink)
