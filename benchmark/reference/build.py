"""The reference's trainer and test-CLI plumbing: frozen copies of the
port's ``tools/train.py`` (``model_config``, ``criterion_config``,
``make_prepare``, the learning-rate scaling) and of the loader's per-scene
transforms (``data/dataset.py:_prep_scene``), on config dicts."""

from __future__ import annotations

import numpy as np
import torch

from .core.bucketing import next_bucket
from .data.augment import transform_test, transform_train
from .losses.criterion import CriterionConfig
from .models.isbnet import ISBNet, ISBNetConfig
from .models.prepare import points_to_batch_np, prepare_voxel_batch, upload_point_batch
from .train.state import create_train_state
from .train.step import _loss_fn, _spformer_loss_fn, _make_step


def model_config(cfg: dict):
    mk = {k: v for k, v in cfg["model"].items() if k != "type"}
    mk["fixed_modules"] = tuple(mk.get("fixed_modules") or ())
    if cfg["model"]["type"] == "isbnet":
        return ISBNetConfig(**mk)
    from .models.spformer import SPFormerConfig

    return SPFormerConfig(**mk)


def criterion_config(cfg: dict):
    ck = dict(cfg.get("criterion", {}))
    if cfg["model"]["type"] != "spformer":
        return CriterionConfig(**ck)
    from .losses.spformer_criterion import SPFormerCriterionConfig

    for key in ("loss_weight", "cost_weight"):
        if key in ck:
            ck[key] = tuple(ck[key])
    return SPFormerCriterionConfig(**ck)


def build_model(cfg: dict, device):
    mcfg = model_config(cfg)
    if isinstance(mcfg, ISBNetConfig):
        return ISBNet(mcfg, seed=0, device=device)
    from .models.spformer import SPFormer

    return SPFormer(mcfg, seed=0, device=device)


def plan_shrink(cfg: dict):
    v = cfg["data"].get("plan_shrink", 0.5)
    return tuple(float(s) for s in v) if isinstance(v, (list, tuple)) else float(v)


def prepare(cfg: dict, pb, batch_size: int, device):
    """``make_prepare``'s prepare of a numpy point batch."""
    levels = model_config(cfg).unet_levels
    pb = upload_point_batch(pb, device)
    return prepare_voxel_batch(pb, pb.coords.shape[0], batch_size, levels,
                               cfg["model"]["spp_cap"], plan_shrink(cfg))


def lr0(cfg: dict, batch_size: int) -> float:
    """The trainer's learning rate for a batch (linear scaling)."""
    return cfg["train"]["lr"] * (batch_size / cfg["train"].get("base_batch_size", 16))


def train_state(cfg: dict, model, batch_size: int):
    return create_train_state(model, lr=lr0(cfg, batch_size),
                              weight_decay=cfg["train"]["weight_decay"],
                              fixed_modules=model.cfg.fixed_modules)


def train_step(cfg: dict, model):
    loss_fn = _spformer_loss_fn if cfg["model"]["type"] == "spformer" else _loss_fn
    return _make_step(loss_fn, model, criterion_config(cfg), None)


def train_scene(cfg: dict, scene: dict, seed: int):
    """The loader's training transform of one scene under ``seed``."""
    v = cfg["data"]["voxel"]
    return transform_train(scene, v["scale"], v["spatial_shape"][1], v["max_npoint"],
                           np.random.default_rng(seed), min_npoint=v["min_npoint"])


def test_scene(cfg: dict, scene: dict):
    return transform_test(scene, cfg["data"]["voxel"]["scale"])


def batch(cfg: dict, scenes: list):
    return points_to_batch_np(scenes, voxel_scale=cfg["data"]["voxel"]["scale"])


def bucket(n: int) -> int:
    return next_bucket(n)


@torch.no_grad()
def infer(cfg: dict, model, prepared):
    model.eval()
    if cfg["model"]["type"] == "isbnet":
        return model.forward_inference(prepared.batch)
    return model(prepared.batch)


def instances(cfg: dict, out, prepared, scene: dict, scan_id: str) -> list:
    from .models.inference import TestConfig, get_instances, spformer_get_instances

    n = len(scene["xyz"])
    t = dict(cfg.get("test", {}))
    if cfg["model"]["type"] == "isbnet":
        return get_instances(scan_id, out, prepared.batch, np.asarray(scene["spp"]),
                             prepared.point2voxel, n, TestConfig.from_dict(t))
    return spformer_get_instances(scan_id, out, prepared.batch, scene["spp"],
                                  prepared.point2voxel, n, topk_insts=t.get("topk_insts", 100),
                                  score_thr=t.get("score_thresh", 0.0),
                                  npoint_thr=t.get("npoint_thresh", 100))
