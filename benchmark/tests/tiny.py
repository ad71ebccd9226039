"""Tiny configurations and mixes for running the harness on the CPU."""

from __future__ import annotations

import copy
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

POOL = {"objects": [2, 2, 3, 3], "points_per_object": 300, "n_floor": 600, "n_wall": 400,
        "room": 3.0}
TINY_MODEL = {
    "isbnet": {"channels": 8, "num_blocks": 3, "dec_dim": 32, "n_sample_pa1": 64,
               "n_queries": 16, "neighbor": 8, "mask_dim_out": 8, "spp_cap": 512},
    "spformer": {"media": 8, "blocks": 3, "num_layer": 2, "num_query": 16, "d_model": 32,
                 "nhead": 4, "hidden_dim": 64, "spp_cap": 512},
}


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    """The cell config ``name`` at tiny widths and batch 2."""
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["model"].update(TINY_MODEL[cfg["model"]["type"]])
    cfg["criterion"]["inst_cap"] = 32
    if cfg["model"]["type"] == "isbnet":
        cfg["criterion"]["voxel_scale"] = 20.0
        cfg["test"].update(score_thresh=0.0, npoint_thresh=20, topk=16)
    else:
        cfg["test"].update(topk_insts=16, npoint_thresh=20)
    cfg["data"]["plan_shrink"] = 0.75
    cfg["data"]["voxel"].update(scale=20, max_npoint=20000, min_npoint=500)
    cfg["train"].update(batch_size=2, base_batch_size=2)
    return cfg


def mix(kind: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "traffic", kind + ".json")) as f:
        m = json.load(f)
    m["pool"] = dict(POOL)
    if kind == "train":
        m.update(workers=0, epoch_batches=16, profile={"skip": 1, "units": 2})
    else:
        m.update(requests=400, check_requests=3, profile={"skip": 1, "units": 2})
    return m
