"""Per-scene inference for the test CLI and in-training validation
(``gapro_tpu/eval/runner.py``).

One scene (batch 1) -> instance records ``{scan_id, label_id, conf,
pred_mask}`` (RLE), for ISBNet and SPFormer. A ``semantic_only`` ISBNet
(the backbone pre-training stage) is validated point by point instead:
mIoU, accuracy and the corner offsets' mean absolute error
(``PointWiseEval``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def make_infer_fn(model, model_type: str, n_sample_arr: Optional[tuple] = None) -> Callable:
    """``infer(batch) -> outputs`` in eval mode: ISBNet's
    ``forward_inference`` with the rounds ``n_sample_arr`` (the model's
    default (192, 128, 64) if None), or SPFormer's forward."""
    if model_type == "isbnet":
        rounds = {} if n_sample_arr is None else dict(n_sample_arr=tuple(n_sample_arr))
        run = lambda batch: model.forward_inference(batch, **rounds)
    elif model_type == "spformer":
        run = model
    else:
        raise ValueError(f"model type {model_type!r}")

    def infer(batch):
        model.eval()
        return run(batch)

    return infer


def infer_scene_instances(model_type: str, out, batch, scene_spp, point2voxel, n_points: int,
                          scan_id: str, test_cfg) -> list:
    """Model outputs -> instance records (``get_instances`` or
    ``spformer_get_instances``)."""
    from ..models.inference import TestConfig, get_instances, spformer_get_instances

    if model_type == "isbnet":
        tc = test_cfg if isinstance(test_cfg, TestConfig) else TestConfig.from_dict(test_cfg)
        return get_instances(scan_id, out, batch, np.asarray(scene_spp), point2voxel, n_points,
                             tc)
    t = dict(test_cfg or {})
    return spformer_get_instances(scan_id, out, batch, scene_spp, point2voxel, n_points,
                                  topk_insts=t.get("topk_insts", 100),
                                  score_thr=t.get("score_thresh", 0.0),
                                  npoint_thr=t.get("npoint_thresh", 100))


@torch.no_grad()
def validate(model, model_type: str, dataset, cfg, log, prepare_fn,
             max_scenes: Optional[int] = None):
    """In-training validation. ``prepare_fn(loader_batch)`` prepares one
    scene on the model's device. A ``semantic_only`` model: point-wise mIoU,
    accuracy and offset MAE, the metric mIoU; otherwise AP with single-round
    sampling of ``n_queries`` proposals for ISBNet, as the reference
    validates during training, the metric AP; an S3DIS room is served
    whole (no x4 split), with its ``sem2ins_classes`` instances. Returns
    (metric, detail)."""
    from ..data.dataset import build_dataloader
    from .instance_eval import S3DIS_INSTANCE_CLASSES, SCANNET_INSTANCE_CLASSES, ScanNetEval
    from .point_wise_eval import PointWiseEval

    semantic_only = bool(cfg.model.get("semantic_only", False))
    if semantic_only:
        pe = PointWiseEval(num_classes=cfg.model.get("instance_classes", 18) + 1)
    else:
        infer = make_infer_fn(model, model_type, n_sample_arr=(
            (cfg.model.get("n_queries", 256),) if model_type == "isbnet" else None))
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
        if semantic_only:
            model.eval()
            out = model(prepared.batch)
            # the scene's points, not the padded batch's (the JAX package
            # indexes the padded map and fails on the shape mismatch)
            p2v = prepared.point2voxel[:len(scene["xyz"])].long()
            pe.update(out["semantic_scores"].argmax(1)[p2v].cpu().numpy(),
                      out["corners_offset"][p2v].cpu().numpy(), scene["semantic"],
                      _corner_labels(scene), scene["instance"])
        else:
            out = infer(prepared.batch)
            all_preds.append(infer_scene_instances(
                model_type, out, prepared.batch, scene["spp"], prepared.point2voxel,
                len(scene["xyz"]), lb.scan_ids[0], cfg.get("test", {})))
            all_sems.append(scene["semantic"])
            all_insts.append(scene["instance"])
        n_done += 1
    if semantic_only:
        miou, acc, mae = pe.get_eval(log)
        return float(miou), dict(val_miou=float(miou), val_acc=float(acc),
                                 val_offset_mae=float(mae))
    res = ev.evaluate(all_preds, all_sems, all_insts)
    log.info("val AP %.4f AP50 %.4f AP25 %.4f", res["all_ap"], res["all_ap_50%"],
             res["all_ap_25%"])
    return float(res["all_ap"]), dict(val_ap=float(res["all_ap"]),
                                      val_ap50=float(res["all_ap_50%"]),
                                      val_ap25=float(res["all_ap_25%"]))


def _corner_labels(scene):
    """The ground-truth box-corner offsets of each point: [min - xyz, max -
    xyz] of its instance's points, -100 off every instance."""
    xyz = np.asarray(scene["xyz"], np.float32)
    inst = np.asarray(scene["instance"])
    out = np.full((len(xyz), 6), -100.0, np.float32)
    for i in np.unique(inst):
        if i < 0:
            continue
        m = inst == i
        mn, mx = xyz[m].min(0), xyz[m].max(0)
        out[m, :3] = mn - xyz[m]
        out[m, 3:] = mx - xyz[m]
    return out
