"""The traffic generator of the S3DIS cells: a pool of synthetic S3DIS rooms
made from the seed.

``room`` is a frozen copy of ``chip_smoke.py:s3dis_room`` (and its
``box_surface`` and object list); it does not follow later changes there.
A room is a box of 5-9 x 4-7 x 2.8-3.4 m: ceiling, floor and four walls,
one beam, column, window, door, board and sofa, six chairs, two tables,
two bookcases and five pieces of clutter, each its own instance of one of
S3DIS's 13 classes (as training ids), the points spread over the
surfaces by area with 3 mm of noise, and superpoints as an instance's
points in one cubic cell of ``superpoint_cell`` metres.

A mix's ``pool`` section fixes ``sizes``, the rooms' point counts (every
seed gets the same multiset, in its own order), and ``superpoint_cell``.
"""

from __future__ import annotations

import numpy as np

# The objects of a room beside its ceiling (class 0), floor (1) and four
# walls (2): (class, count) for beam, column, window, door, chair, table,
# bookcase, sofa, board and clutter.
OBJECTS = ((3, 1), (4, 1), (5, 1), (6, 1), (7, 6), (8, 2), (9, 2), (10, 1), (11, 1), (12, 5))


def box_surface(rng, lo, hi, n: int):
    """``n`` points uniform on the surface of the box [lo, hi] (a face of no
    area gets none)."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    ext = hi - lo
    areas = np.repeat([ext[1] * ext[2], ext[0] * ext[2], ext[0] * ext[1]], 2)
    face = rng.choice(6, n, p=areas / areas.sum())
    p = lo + rng.random((n, 3)) * ext
    axis = face // 2
    p[np.arange(n), axis] = np.where(face % 2 == 1, hi[axis], lo[axis])
    return p


def room(seed: int, n_points: int, superpoint_cell: float = 0.5) -> dict:
    """One room: xyz (centred in x and y, the floor at z = 0), rgb in
    [-1, 1], semantic (training ids), instance and spp."""
    rng = np.random.default_rng(seed)
    w, d, h = rng.uniform(5.0, 9.0), rng.uniform(4.0, 7.0), rng.uniform(2.8, 3.4)
    boxes = [(0, (0, 0, h), (w, d, h)), (1, (0, 0, 0), (w, d, 0)),
             (2, (0, 0, 0), (w, 0, h)), (2, (0, d, 0), (w, d, h)),
             (2, (0, 0, 0), (0, d, h)), (2, (w, 0, 0), (w, d, h))]
    at = lambda size, lim: rng.uniform(0.1, lim - size - 0.1)
    for cls, count in OBJECTS:
        for _ in range(count):
            if cls == 3:  # beam under the ceiling
                y = at(0.3, d)
                box = (0, y, h - 0.4), (w, y + 0.3, h)
            elif cls == 4:  # column by a wall
                x = at(0.4, w)
                box = (x, 0, 0), (x + 0.4, 0.4, h)
            elif cls in (5, 11):  # window, board: on a wall
                x = at(1.6, w)
                y0 = 0.0 if cls == 5 else d - 0.05
                box = (x, y0, 0.9), (x + 1.6, y0 + 0.05, 2.1)
            elif cls == 6:  # door
                y = at(0.9, d)
                box = (0, y, 0), (0.05, y + 0.9, 2.1)
            else:  # furniture and clutter on the floor
                sx, sy, sz = {7: (0.5, 0.5, 0.9), 8: (1.6, 0.8, 0.75), 9: (1.0, 0.35, 2.0),
                              10: (2.0, 0.9, 0.8)}.get(cls, tuple(rng.uniform(0.2, 0.5, 3)))
                x, y = at(sx, w), at(sy, d)
                box = (x, y, 0), (x + sx, y + sy, sz)
            boxes.append((cls, *box))
    area = np.array([np.prod(np.sort(np.subtract(hi, lo))[1:]) + 1e-3 for _, lo, hi in boxes])
    counts = rng.multinomial(n_points, area / area.sum())
    xyz = np.concatenate([box_surface(rng, lo, hi, k) for (_, lo, hi), k in zip(boxes, counts)])
    xyz += rng.normal(0.0, 0.003, xyz.shape)
    inst = np.repeat(np.arange(len(boxes)), counts)
    sem = np.array([cls for cls, _, _ in boxes])[inst]
    rgb = np.clip(rng.uniform(-0.8, 0.8, (len(boxes), 3))[inst]
                  + rng.normal(0.0, 0.05, xyz.shape), -1.0, 1.0)
    cell = np.floor(xyz / superpoint_cell).astype(np.int64) + 1
    _, spp = np.unique(((inst * 64 + cell[:, 0]) * 64 + cell[:, 1]) * 64 + cell[:, 2],
                       return_inverse=True)
    xyz[:, :2] -= xyz[:, :2].mean(0)
    xyz[:, 2] -= xyz[:, 2].min()
    return dict(xyz=xyz.astype(np.float32), rgb=rgb.astype(np.float32),
                semantic=sem.astype(np.int64), instance=inst.astype(np.int64),
                spp=spp.astype(np.int64))


def pool_sizes(seed: int, pool: dict) -> list:
    """The point count of each room of the pool, in the seed's order."""
    rng = np.random.default_rng([seed, 1])
    return [int(k) for k in rng.permutation(np.asarray(pool["sizes"]))]


def make_pool(seed: int, pool: dict) -> list:
    """The pool's rooms, each with its ``scan_id``."""
    sizes = pool_sizes(seed, pool)
    seeds = np.random.default_rng([seed, 2]).integers(0, 2 ** 31, len(sizes))
    out = []
    for i, (n, s) in enumerate(zip(sizes, seeds)):
        r = room(int(s), n, pool["superpoint_cell"])
        r["scan_id"] = f"Area_5_room{i:02d}_{n}"
        out.append(r)
    return out
