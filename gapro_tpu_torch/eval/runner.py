"""Per-scene inference for the test CLI and in-training validation
(``gapro_tpu/eval/runner.py``), ISBNet without ``semantic_only``.

One scene (batch 1) -> instance records ``{scan_id, label_id, conf,
pred_mask}`` (RLE). The JAX package's pointwise validation of
``semantic_only`` models and the SPFormer path are not ported.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _isbnet_only(model_type: str) -> None:
    if model_type != "isbnet":
        raise NotImplementedError(f"model type {model_type!r}: only ISBNet is ported")


def make_infer_fn(model, model_type: str, n_sample_arr: Optional[tuple] = None) -> Callable:
    """``infer(batch) -> outputs``: ISBNet's ``forward_inference`` with the
    rounds ``n_sample_arr`` (the model's default (192, 128, 64) if None), in
    eval mode."""
    _isbnet_only(model_type)
    rounds = {} if n_sample_arr is None else dict(n_sample_arr=tuple(n_sample_arr))

    def infer(batch):
        model.eval()
        return model.forward_inference(batch, **rounds)

    return infer


def infer_scene_instances(model_type: str, out, batch, scene_spp, point2voxel, n_points: int,
                          scan_id: str, test_cfg) -> list:
    """Model outputs -> instance records (``get_instances``)."""
    from ..models.inference import TestConfig, get_instances

    _isbnet_only(model_type)
    tc = test_cfg if isinstance(test_cfg, TestConfig) else TestConfig.from_dict(test_cfg)
    return get_instances(scan_id, out, batch, np.asarray(scene_spp), point2voxel, n_points, tc)


@torch.no_grad()
def validate(model, model_type: str, dataset, cfg, log, prepare_fn,
             max_scenes: Optional[int] = None):
    """In-training validation: AP over ``dataset`` with single-round
    sampling of ``n_queries`` proposals, as the reference validates during
    training. ``prepare_fn(loader_batch)`` prepares one scene on the model's
    device. Returns (all_ap, detail dict)."""
    from ..data.dataset import build_dataloader
    from .instance_eval import S3DIS_INSTANCE_CLASSES, SCANNET_INSTANCE_CLASSES, ScanNetEval

    if cfg.model.get("semantic_only", False):
        raise NotImplementedError("validation of semantic_only models is not ported yet")
    infer = make_infer_fn(model, model_type, n_sample_arr=(cfg.model.get("n_queries", 256),))
    labels = S3DIS_INSTANCE_CLASSES if cfg.data.type == "s3dis" else SCANNET_INSTANCE_CLASSES
    ev = ScanNetEval(labels, dataset_name=cfg.data.type)
    all_preds, all_sems, all_insts = [], [], []
    n_done = 0
    for lb in build_dataloader(dataset, 1, training=False, drop_last=False):
        if max_scenes is not None and n_done >= max_scenes:
            break
        scene = lb.scenes[0]
        # the reference skips scenes of more than 3M points in validation
        if len(scene["xyz"]) > 3_000_000:
            continue
        prepared = prepare_fn(lb)
        out = infer(prepared.batch)
        all_preds.append(infer_scene_instances(
            model_type, out, prepared.batch, scene["spp"], prepared.point2voxel,
            len(scene["xyz"]), lb.scan_ids[0], cfg.get("test", {})))
        all_sems.append(scene["semantic"])
        all_insts.append(scene["instance"])
        n_done += 1
    res = ev.evaluate(all_preds, all_sems, all_insts)
    log.info("val AP %.4f AP50 %.4f AP25 %.4f", res["all_ap"], res["all_ap_50%"],
             res["all_ap_25%"])
    return float(res["all_ap"]), dict(val_ap=float(res["all_ap"]),
                                      val_ap50=float(res["all_ap_50%"]),
                                      val_ap25=float(res["all_ap_25%"]))
