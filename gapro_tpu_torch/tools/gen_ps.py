"""GP pseudo labels from box annotations: the port of ``tools/gen_ps.py``.

    python -m gapro_tpu_torch.tools.gen_ps --data_root dataset/scannetv2 --split train
    python -m gapro_tpu_torch.tools.gen_ps --synthetic 2 --device cpu --eval_pslabel

Real data: each ``<data_root>/<split>/*_inst_nostuff.pth`` scene gets its
boxes from the GT instances, axis alignment from ``scans_transform`` and
wall boxes from ``scannet_planes``, goes through
``generate_scene_labels_stream`` (window 4, over every visible card with
``--device cuda``), and its (sem, inst, prob, mu,
var) 5-tuple is saved to ``<save_folder>/<scan>.pth``. Scenes whose output
exists are skipped. ``--synthetic N`` labels N synthetic rooms instead and
scores them against their GT. ``--eval_pslabel`` prints the instance mIoU of
the pseudo labels, ``--eval_ap`` their AP. The run ends with scenes/s.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import sys
import time
from glob import glob

import numpy as np
import torch

from ..data import make_synthetic_scene, scannet_io
from ..eval.pseudo import pseudo_label_ap, pseudo_label_miou_scene
from ..labeler import (LabelerConfig, generate_scene_labels, generate_scene_labels_stream,
                       instance_info, wall_boxes_from_planes)

WINDOW = 4


def gt_training_semantics(sem_gt):
    """Raw ScanNet semantics -> the labeler's ids: foreground 2..19 -> 0..17,
    wall and floor -> 18, -100 stays."""
    gt_sem = np.asarray(sem_gt).copy()
    gt_sem[gt_sem != -100] -= 2
    gt_sem[(gt_sem == -1) | (gt_sem == -2)] = 18
    return gt_sem


def scene_kwargs(xyz, rgb, sem_gt, inst_gt, spp, wall=None, feats=None):
    """``submit_scene``'s arguments for one scene, or None if it has no
    instance."""
    info = instance_info(xyz, inst_gt, sem_gt, with_corners=False)
    if info is None:
        return None
    _, cls, boxes, vols, _ = info
    kw = dict(coords=xyz, gp_feats=np.concatenate([xyz, rgb], 1) if feats is None else feats,
              spp=spp, instance_cls=cls, instance_box=boxes, instance_box_volume=vols)
    if wall is not None:
        _, kw["wall_box"], kw["wall_box_volume"] = wall
    return kw


def real_scenes(args, files):
    """Load each scene not yet saved, with its boxes; ``_meta`` carries what
    the caller saves and scores."""
    for path in files:
        scan = osp.basename(path)[:12]
        save_path = osp.join(args.save_folder, scan + ".pth")
        if osp.exists(save_path):
            continue
        xyz, rgb, sem_gt, inst_gt = scannet_io.load_scene(path)
        spp = scannet_io.load_superpoints(osp.join(args.data_root, "superpoints", scan + ".pth"))
        mat = scannet_io.load_axis_align_matrix(
            osp.join(args.data_root, "scans_transform", scan, scan + ".txt"))
        xyz = scannet_io.apply_axis_align(xyz, mat)
        plane = scannet_io.load_plane_quads(
            osp.join(args.data_root, "scannet_planes", scan + ".json"))
        wall = wall_boxes_from_planes(plane, mat) if plane is not None else None
        feats = None
        if args.use_deepfeat:
            feats = np.asarray(torch.load(osp.join(args.deepfeat_folder, scan + ".pth"),
                                          map_location="cpu", weights_only=False), np.float32)
        kw = scene_kwargs(xyz, rgb, sem_gt, inst_gt, spp, wall, feats)
        if kw is None:
            continue
        kw["_meta"] = (scan, save_path, sem_gt, inst_gt)
        yield kw


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gapro_tpu_torch gen_ps")
    ap.add_argument("--data_root", type=str, default="dataset/scannetv2")
    ap.add_argument("--save_folder", type=str,
                    default="dataset/scannetv2/gaussian_process_kl_pseudo_labels")
    ap.add_argument("--split", type=str, default="train")
    ap.add_argument("--use_deepfeat", action="store_true")
    ap.add_argument("--deepfeat_folder", type=str, default="dataset/scannetv2/pretrain_maskfeats")
    ap.add_argument("--eval_pslabel", action="store_true")
    ap.add_argument("--eval_ap", action="store_true", help="AP of the pseudo labels against GT")
    ap.add_argument("--training_iter", type=int, default=50)
    ap.add_argument("--synthetic", type=int, default=0,
                    help="label N synthetic scenes instead of real data")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the sweep over real scenes spreads over every "
                         "visible card), cuda:N for one card, or cpu")
    args = ap.parse_args(argv)

    cfg = LabelerConfig(training_iter=args.training_iter)
    ious_all, ap_scenes = [], []
    t_start = time.time()
    n_done = 0

    def score(name, gt_sem, inst_gt, sem, inst):
        if args.eval_pslabel or args.synthetic:
            ious = pseudo_label_miou_scene(gt_sem, inst_gt, sem, inst)
            ious_all.append(ious)
            print(f"{name}: mIoU {np.mean(ious):.4f}", flush=True)
        if args.eval_ap:
            ap_scenes.append((gt_sem, inst_gt, sem, inst))

    if args.synthetic:
        for i in range(args.synthetic):
            scene = make_synthetic_scene(seed=i)
            kw = scene_kwargs(scene.xyz, scene.rgb, scene.semantic_label, scene.instance_label,
                              scene.spp)
            sem, inst, *_ = generate_scene_labels(cfg=cfg, device=args.device, **kw)
            n_done += 1
            score(f"scene {i} ({len(scene.xyz)} pts)",
                  gt_training_semantics(scene.semantic_label), scene.instance_label, sem, inst)
    else:
        files = sorted(glob(osp.join(args.data_root, args.split, "*_inst_nostuff.pth")))
        if not files:
            print(f"no scenes found under {args.data_root}/{args.split}", file=sys.stderr)
            return 1
        os.makedirs(args.save_folder, exist_ok=True)
        meta = []

        def strip_meta(it):
            for kw in it:
                meta.append(kw.pop("_meta"))
                yield kw

        for i, (_, out) in enumerate(generate_scene_labels_stream(
                strip_meta(real_scenes(args, files)), cfg, window=WINDOW,
                device=None if args.device == "cuda" else args.device)):
            scan, save_path, sem_gt, inst_gt = meta[i]
            sem, inst, prob, mu, var, _ = out
            scannet_io.save_pseudo_labels(save_path, sem, inst, prob, mu, var)
            n_done += 1
            if args.eval_pslabel or args.eval_ap:
                score(scan, gt_training_semantics(sem_gt), inst_gt, sem, inst)

    dt = time.time() - t_start
    if ap_scenes:
        res = pseudo_label_ap(ap_scenes)
        print(f"Pseudo-label AP {res['all_ap']:.4f} AP50 {res['all_ap_50%']:.4f} "
              f"AP25 {res['all_ap_25%']:.4f}")
    if ious_all:
        print(f"Mean instance iou of pseudo labels: {float(np.mean(np.concatenate(ious_all))):.4f}")
    if n_done:
        print(f"{n_done} scenes in {dt:.1f}s  ({n_done / dt:.3f} scenes/sec)")
    print("Finish")
    return 0


if __name__ == "__main__":
    sys.exit(main())
