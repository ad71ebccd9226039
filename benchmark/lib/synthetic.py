# Frozen copy of gapro_tpu_torch/data/synthetic.py (the scenes of the benchmark's traffic); it
# does not follow later changes to the port.
"""Synthetic ScanNet-like scenes (numpy copy of ``gapro_tpu/data/synthetic.py``).

A floor slab, four walls and K box-shaped objects with distinct colours,
some overlapping; superpoints are small spatial patches that never cross
object boundaries. The same seed gives the same scene as the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticScene(NamedTuple):
    xyz: np.ndarray  # [N, 3] float32
    rgb: np.ndarray  # [N, 3] float32 in [-1, 1]
    semantic_label: np.ndarray  # [N] int64 (raw scannet-style: 2..19 fg, 0/1 bg)
    instance_label: np.ndarray  # [N] int64 (-100 for bg)
    spp: np.ndarray  # [N] int64 superpoint ids


def make_synthetic_scene(
    seed: int = 0,
    n_objects: int = 8,
    points_per_object: int = 1500,
    n_floor: int = 4000,
    n_wall: int = 2500,
    room: float = 6.0,
    overlap_fraction: float = 0.4,
    spp_size: float = 0.22,
) -> SyntheticScene:
    rng = np.random.default_rng(seed)
    pts, cols, sems, insts = [], [], [], []

    # floor (raw scannet sem id 1) and walls (0) — background, instance -100
    floor = np.stack(
        [rng.uniform(0, room, n_floor), rng.uniform(0, room, n_floor), rng.uniform(0, 0.04, n_floor)],
        axis=1,
    )
    pts.append(floor)
    cols.append(np.tile(np.array([[0.4, 0.3, 0.2]]), (n_floor, 1)) + rng.normal(0, 0.03, (n_floor, 3)))
    sems.append(np.full(n_floor, 1))
    insts.append(np.full(n_floor, -100))

    per_wall = n_wall // 4
    for w in range(4):
        u = rng.uniform(0, room, per_wall)
        z = rng.uniform(0, 2.6, per_wall)
        off = rng.uniform(0, 0.03, per_wall)
        if w == 0:
            xyzw = np.stack([u, off, z], 1)
        elif w == 1:
            xyzw = np.stack([u, room - off, z], 1)
        elif w == 2:
            xyzw = np.stack([off, u, z], 1)
        else:
            xyzw = np.stack([room - off, u, z], 1)
        pts.append(xyzw)
        cols.append(np.tile(np.array([[0.7, 0.7, 0.65]]), (per_wall, 1)) + rng.normal(0, 0.02, (per_wall, 3)))
        sems.append(np.full(per_wall, 0))
        insts.append(np.full(per_wall, -100))

    # objects: axis-aligned blobs, some pairs overlapping
    n_over = int(n_objects * overlap_fraction)
    centers = []
    for i in range(n_objects):
        if i >= n_objects - n_over and centers:
            base = centers[rng.integers(0, len(centers))]
            c = base + rng.uniform(-0.5, 0.5, 3) * np.array([1, 1, 0.3])
        else:
            c = np.array(
                [rng.uniform(1.0, room - 1.0), rng.uniform(1.0, room - 1.0), rng.uniform(0.3, 1.0)]
            )
        centers.append(c)
        half = rng.uniform(0.25, 0.6, 3)
        p = c + rng.uniform(-1, 1, (points_per_object, 3)) * half
        p[:, 2] = np.clip(p[:, 2], 0.05, None)
        color = rng.uniform(-0.9, 0.9, 3)
        pts.append(p)
        cols.append(np.tile(color[None], (points_per_object, 1)) + rng.normal(0, 0.05, (points_per_object, 3)))
        sems.append(np.full(points_per_object, int(rng.integers(2, 20))))
        insts.append(np.full(points_per_object, i))

    xyz = np.concatenate(pts).astype(np.float32)
    rgb = np.clip(np.concatenate(cols), -1, 1)
    # real ScanNet rgb is uint8-derived ((u/127.5) - 1, prepare_data_inst.py);
    # snap synthetic colors to the same grid so fixtures share that property
    # (and the labeler's lossless packed-rgb H2D path is exercised)
    rgb = (np.rint((rgb + 1.0) * 127.5).astype(np.float32)
           / np.float32(127.5) - np.float32(1.0))
    sem = np.concatenate(sems).astype(np.int64)
    inst = np.concatenate(insts).astype(np.int64)

    # superpoints: spatial grid cells jittered, but never crossing
    # object/background boundaries (mesh segmentation respects edges)
    cell = np.floor(xyz / spp_size).astype(np.int64)
    key = (cell[:, 0] * 73856093 ^ cell[:, 1] * 19349663 ^ cell[:, 2] * 83492791) & 0x7FFFFFFF
    key = key * 64 + (inst % 61 + 2)  # separate objects sharing a cell
    _, spp = np.unique(key, return_inverse=True)

    perm = rng.permutation(len(xyz))
    return SyntheticScene(
        xyz=xyz[perm], rgb=rgb[perm], semantic_label=sem[perm], instance_label=inst[perm], spp=spp[perm]
    )
