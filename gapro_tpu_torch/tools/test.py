"""Inference and AP evaluation of ISBNet: the port of ``tools/test.py``.

    python -m gapro_tpu_torch.tools.test configs/isbnet_scannetv2.yaml runs/isbnet/latest
    python -m gapro_tpu_torch.tools.test configs/tiny_synthetic.yaml --synthetic 2 --device cpu

``run_test(cfg, checkpoint, ...)`` serves each scene of a split at batch 1
(prepare -> ``forward_inference`` with the rounds (192, 128, 64) ->
``get_instances``), times each scene on the host clock with the device
synchronised, optionally writes the ScanNet benchmark's submission format
(``--out``), and scores the instances with ``ScanNetEval``. Without a
checkpoint the weights are drawn from ``--seed``. SPFormer, the s3dis
``x4_split`` and ``--save_pointwise`` are not ported yet.
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

from ..data.dataset import build_dataloader
from ..device import resolve_device
from ..eval.instance_eval import SCANNET_INSTANCE_CLASSES, ScanNetEval
from ..models.inference import TestConfig, get_instances
from ..train.checkpoint import load_model_weights
from ..train.config import load_config
from ..utils.rle import rle_decode
from .train import build_dataset, build_model, make_prepare


@torch.no_grad()
def run_test(cfg, checkpoint: Optional[str] = None, *, device=None, seed: int = 0,
             synthetic: int = 0, dataset=None, out: Optional[str] = None, evaluate: bool = True,
             model=None) -> dict:
    """Serve and score the config's test split (or ``dataset``) on one
    device (``cuda`` unless named). ``model`` replaces the one built from
    the config and ``checkpoint``. Returns the per-scene seconds, the
    instance records and, with ``evaluate``, the AP dict."""
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
    tc = TestConfig.from_dict(cfg.get("test", {}))
    prepare = make_prepare(cfg, dev)

    times, all_preds, all_sems, all_insts = [], [], [], []
    for lb in build_dataloader(dataset, 1, training=False, drop_last=False):
        scene, scan_id = lb.scenes[0], lb.scan_ids[0]
        n_points = len(scene["xyz"])
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        prepared = prepare(lb.points, 1)
        outputs = model.forward_inference(prepared.batch)
        insts = get_instances(scan_id, outputs, prepared.batch, np.asarray(scene["spp"]),
                              prepared.point2voxel, n_points, tc)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        log.info("%s: %d pts, %d instances, %.3fs", scan_id, n_points, len(insts), times[-1])
        all_preds.append(insts)
        all_sems.append(scene["semantic"])
        all_insts.append(scene["instance"])
        if out:
            export_benchmark(out, scan_id, insts, n_points)
    if times:
        log.info("Average run time: %.4fs (median: %.4fs)", float(np.mean(times)),
                 float(np.median(times)))
    result = None
    if evaluate:
        ev = ScanNetEval(SCANNET_INSTANCE_CLASSES, dataset_name=cfg.data.type)
        result = ev.evaluate(all_preds, all_sems, all_insts)
        log.info("AP %.4f  AP50 %.4f  AP25 %.4f", result["all_ap"], result["all_ap_50%"],
                 result["all_ap_25%"])
    return dict(seconds=times, preds=all_preds, result=result)


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


if __name__ == "__main__":
    main()
