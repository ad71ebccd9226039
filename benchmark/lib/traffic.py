"""The one traffic generator: a pool of synthetic ScanNet-sized scenes made
from the seed, and the order in which a cell's mix serves them.

A mix's ``pool`` section fixes the scenes' sizes: ``objects`` lists the
object counts of the pool's scenes (every seed gets the same multiset, in
its own order), each object of ``points_per_object`` points, on a floor of
``n_floor`` and walls of ``n_wall`` points in a room of ``room`` metres.
Each scene carries seeded GP pseudo labels (prob, mu, var) as the GaPro
trainer reads them.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .synthetic import make_synthetic_scene

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json``."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def remap_semantic_for_training(sem, label_shift: int = 2, background_class: int = 18):
    """Raw ScanNet semantics -> training ids: raw 2..19 -> 0..17, raw 0/1 ->
    ``background_class`` (the port's ``data/scannet_io.py`` rule)."""
    sem = np.asarray(sem).astype(np.int64)
    out = np.full_like(sem, -100)
    out[(sem >= 0) & (sem < label_shift)] = background_class
    fg = sem >= label_shift
    out[fg] = sem[fg] - label_shift
    return out


def gp_labels(rng: np.random.Generator, n: int) -> dict:
    """Per-point GP labels: prob ~ U(0.5, 1), mu ~ N(0, 1), var ~ U(0, 0.5)
    with a fifth set to 0, so that both KL branches and the prob-weighted
    BCE run."""
    var = rng.uniform(0.0, 0.5, n).astype(np.float32)
    var[rng.random(n) < 0.2] = 0.0
    return dict(prob=rng.uniform(0.5, 1.0, n).astype(np.float32),
                mu=rng.normal(size=n).astype(np.float32), var=var)


def pool_objects(seed: int, pool: dict) -> list:
    """The object count of each scene of the pool, in the seed's order."""
    rng = np.random.default_rng([seed, 1])
    return [int(k) for k in rng.permutation(np.asarray(pool["objects"]))]


def make_pool(seed: int, pool: dict) -> list:
    """The pool's scenes: dicts of xyz, rgb, semantic (training ids),
    instance, spp, prob, mu, var and scan_id."""
    objects = pool_objects(seed, pool)
    rng = np.random.default_rng([seed, 2])
    seeds = rng.integers(0, 2 ** 31, len(objects))
    scenes = []
    for i, (k, s) in enumerate(zip(objects, seeds)):
        sc = make_synthetic_scene(seed=int(s), n_objects=k,
                                  points_per_object=pool["points_per_object"],
                                  n_floor=pool["n_floor"], n_wall=pool["n_wall"],
                                  room=pool["room"])
        n = len(sc.xyz)
        scenes.append(dict(xyz=sc.xyz, rgb=sc.rgb,
                           semantic=remap_semantic_for_training(sc.semantic_label),
                           instance=sc.instance_label.astype(np.int64), spp=sc.spp,
                           scan_id=f"scene{i:04d}_{k:02d}",
                           **gp_labels(np.random.default_rng([seed, 3, i]), n)))
    return scenes


def request_order(seed: int, n_pool: int, n: int) -> list:
    """``n`` pool indices: one seeded permutation of the pool a pass."""
    rng = np.random.default_rng([seed, 5])
    out = []
    while len(out) < n:
        out.extend(int(i) for i in rng.permutation(n_pool))
    return out[:n]
