"""Inference and AP evaluation of ISBNet or SPFormer: the port of
``tools/test.py``.

    python -m gapro_tpu_torch.tools.test configs/isbnet_scannetv2.yaml runs/isbnet/latest
    python -m gapro_tpu_torch.tools.test configs/spformer_scannetv2.yaml runs/spf/latest
    python -m gapro_tpu_torch.tools.test configs/isbnet_s3dis.yaml runs/s3dis/best
    python -m gapro_tpu_torch.tools.test configs/tiny_synthetic.yaml --synthetic 2 --device cpu

``run_test(cfg, checkpoint, ...)`` serves each scene of a split at batch 1
(prepare -> ISBNet's ``forward_inference`` with the rounds (192, 128, 64)
-> ``get_instances``, or SPFormer's forward -> ``spformer_get_instances``),
times each scene on the host clock with the device synchronised, optionally
writes the ScanNet benchmark's submission format (``--out``), and scores
the instances with ``ScanNetEval``: AP, and for SPFormer also box AP, as
the reference does. On S3DIS (``data.type``) the labels are S3DIS's and
mCov, mWCov, mPrec and mRec follow (``S3DISEval``); with the test
section's ``x4_split`` an ISBNet serves each room as 4 interleaved pieces
(``S3DISDataset.split_pieces``) in one batch, and each mask is put back
into the room's point order. Without a checkpoint the weights are drawn
from ``--seed``. ``--save_pointwise`` is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import os.path as osp
import time
from typing import Optional

import numpy as np
import torch

from ..data.dataset import S3DISDataset, build_dataloader
from ..device import resolve_device
from ..eval.instance_eval import S3DIS_INSTANCE_CLASSES, SCANNET_INSTANCE_CLASSES, ScanNetEval
from ..eval.runner import infer_scene_instances, make_infer_fn
from ..eval.s3dis_eval import S3DISEval
from ..models.prepare import points_to_batch_np
from ..train.checkpoint import load_model_weights
from ..train.config import load_config
from ..utils.rle import rle_decode, rle_encode
from .train import build_dataset, build_model, make_prepare


@torch.no_grad()
def run_test(cfg, checkpoint: Optional[str] = None, *, device=None, seed: int = 0,
             synthetic: int = 0, dataset=None, out: Optional[str] = None, evaluate: bool = True,
             model=None) -> dict:
    """Serve and score the config's test split (or ``dataset``) on one
    device (``cuda`` unless named). ``model`` replaces the one built from
    the config and ``checkpoint``. Returns the per-scene seconds, the
    instance records and, with ``evaluate``, the AP dict (``result``), for
    SPFormer the box AP dict (``box_result``) and on S3DIS the dict of
    mCov, mWCov, mPrec and mRec (``s3dis_result``)."""
    log = logging.getLogger("test")
    dev = resolve_device(device)
    if model is None:
        model, _ = build_model(cfg, dev, seed)
        if checkpoint:
            load_model_weights(checkpoint, model)
            log.info("loaded %s", checkpoint)
    model.eval()
    if dataset is None:
        dataset = build_dataset(cfg, synthetic, training=False)
    model_type = cfg.model.type
    x4 = model_type == "isbnet" and bool(cfg.get("test", {}).get("x4_split", False))
    infer = make_infer_fn(model, model_type)
    prepare = make_prepare(cfg, dev)

    times, all_preds, all_sems, all_insts, all_coords = [], [], [], [], []
    for lb in build_dataloader(dataset, 1, training=False, drop_last=False):
        scene, scan_id = lb.scenes[0], lb.scan_ids[0]
        n_points = len(scene["xyz"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if x4:
            insts = serve_room(model, cfg, scene, prepare, dataset.voxel_cfg.scale, scan_id)[2]
        else:
            prepared = prepare(lb.points, 1)
            insts = infer_scene_instances(model_type, infer(prepared.batch), prepared.batch,
                                          scene["spp"], prepared.point2voxel, n_points, scan_id,
                                          cfg.get("test", {}))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        log.info("%s: %d pts, %d instances, %.3fs", scan_id, n_points, len(insts), times[-1])
        all_preds.append(insts)
        all_sems.append(scene["semantic"])
        all_insts.append(scene["instance"])
        all_coords.append(scene["xyz"])
        if out:
            export_benchmark(out, scan_id, insts, n_points)
    if times:
        log.info("Average run time: %.4fs (median: %.4fs)", float(np.mean(times)),
                 float(np.median(times)))
    result = box_result = s3dis_result = None
    if evaluate:
        s3dis = cfg.data.type == "s3dis"
        ev = ScanNetEval(S3DIS_INSTANCE_CLASSES if s3dis else SCANNET_INSTANCE_CLASSES,
                         dataset_name=cfg.data.type)
        result = ev.evaluate(all_preds, all_sems, all_insts)
        log.info("AP %.4f  AP50 %.4f  AP25 %.4f", result["all_ap"], result["all_ap_50%"],
                 result["all_ap_25%"])
        if model_type == "spformer":
            box_result = ev.evaluate_box(all_preds, all_coords, all_sems, all_insts)
            log.info("Box AP %.4f  Box AP50 %.4f  Box AP25 %.4f", box_result["all_ap"],
                     box_result["all_ap_50%"], box_result["all_ap_25%"])
        if s3dis:
            s3dis_result = dict(zip(("mcov", "mwcov", "mprec", "mrec"),
                                    S3DISEval().evaluate(all_preds, all_sems, all_insts)))
            log.info("mCov %.4f mWCov %.4f mPrec %.4f mRec %.4f", *s3dis_result.values())
    return dict(seconds=times, preds=all_preds, result=result, box_result=box_result,
                s3dis_result=s3dis_result)


X4_PIECES = 4


def split_room(scene, voxel_scale):
    """An S3DIS room as x4_split serves it: the point batch of its
    ``X4_PIECES`` interleaved pieces (``S3DISDataset.split_pieces``), their
    superpoint ids in the batch's point order, and the room's index of each
    of those points."""
    pieces = S3DISDataset.split_pieces(scene, X4_PIECES)
    return (points_to_batch_np(pieces, voxel_scale=voxel_scale),
            np.concatenate([p["spp"] for p in pieces]),
            np.concatenate([p["piece_indices"] for p in pieces]))


def serve_room(model, cfg, room, prepare, voxel_scale, scan_id: str = "room", stage=None):
    """Serve one S3DIS room as x4_split does: ``split_room`` -> ``prepare``
    of its ``X4_PIECES`` pieces -> ISBNet's ``forward_inference(x4_split=True)``
    -> ``get_instances`` under the config's test section -> each mask back
    in the room's point order. ``stage()``, when given, is called after the
    prepare and after the forward (a timer's hook). Returns the prepared
    batch, the outputs and the instance records."""
    points, spp, perm = split_room(room, voxel_scale)
    prepared = prepare(points, X4_PIECES)
    if stage:
        stage()
    outputs = model.forward_inference(prepared.batch, x4_split=True)
    if stage:
        stage()
    insts = infer_scene_instances("isbnet", outputs, prepared.batch, spp, prepared.point2voxel,
                                  len(perm), scan_id, cfg.get("test", {}))
    to_room_order(insts, perm)
    return prepared, outputs, insts


def to_room_order(instances, perm) -> None:
    """Put each instance's mask, in the pieces' point order, back into the
    room's (``perm``: the room's index of each point), in place."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    for inst in instances:
        inst["pred_mask"] = rle_encode(rle_decode(inst["pred_mask"])[inv])


def export_benchmark(out_dir: str, scan_id: str, instances, n_points: int) -> None:
    """The ScanNet benchmark's submission format: ``<scan>.txt`` with one
    line ``pred_mask/<scan>_<i>.txt label conf`` per instance, and each
    mask as a column of 0/1."""
    os.makedirs(osp.join(out_dir, "pred_mask"), exist_ok=True)
    lines = []
    for i, inst in enumerate(instances):
        rel = f"pred_mask/{scan_id}_{i:03d}.txt"
        np.savetxt(osp.join(out_dir, rel), rle_decode(inst["pred_mask"]).astype(np.int8),
                   fmt="%d")
        lines.append(f"{rel} {inst['label_id']} {inst['conf']:.4f}")
    with open(osp.join(out_dir, scan_id + ".txt"), "w") as f:
        f.write("\n".join(lines))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("gapro_tpu_torch test")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--out", default=None, help="benchmark-format export dir")
    ap.add_argument("--no_eval", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights drawn from this seed when no checkpoint is given")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = load_config(args.config)
    res = run_test(cfg, args.checkpoint, device=args.device, seed=args.seed,
                   synthetic=args.synthetic, out=args.out, evaluate=not args.no_eval)
    if res["result"] is not None:
        print(json.dumps({k: v for k, v in res["result"].items() if k != "classes"}))
    if res["box_result"] is not None:
        print(json.dumps({"box_" + k: v for k, v in res["box_result"].items()
                          if k != "classes"}))
    if res["s3dis_result"] is not None:
        print(json.dumps(res["s3dis_result"]))


if __name__ == "__main__":
    main()
