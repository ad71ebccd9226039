"""Offline ScanNetv2 preparation: the port of ``tools/prepare_scannet.py``
(reference: ISBNet/dataset/scannetv2/prepare_data_inst.py +
prepare_superpoint.py + split_data.py).

    python -m gapro_tpu_torch.tools.prepare_scannet --scans_dir RAW --out dataset/scannetv2 \
        --split train --labels_tsv RAW/scannetv2-labels.combined.tsv

Per scan directory:
  * `<scan>_vh_clean_2.ply`        -> mean-centered xyz + rgb in [-1, 1]
  * `<scan>_vh_clean_2.labels.ply` -> NYU40 -> 0..19 semantic remap
  * `<scan>*.segs.json` + `<scan>.aggregation.json` -> instance labels
    (wall/floor groups dropped, prepare_data_inst.py:70-100)
  * superpoints via the native mesh segmentator
    (gapro_tpu_torch/native/segmentator.cpp, replacing the external
    `segmentator`; built at first use)

Outputs `<out>/<split>/<scan>_inst_nostuff.pth` and
`<out>/superpoints/<scan>.pth` in the layout gapro_tpu_torch.data expects.
This is host work: it runs on no device.
"""

import argparse
import json
import os
import os.path as osp
import sys
from glob import glob

import numpy as np
import torch

from ..data.ply import read_ply
from ..native.segmentator import segment_mesh

# NYU40 ids -> training ids 0..19 (prepare_data_inst.py:18-20)
NYU40_KEEP = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
REMAPPER = np.full(150, -100, np.int64)
for i, x in enumerate(NYU40_KEEP):
    REMAPPER[x] = i

# raw label -> scannetv2 name subset used to drop wall/floor groups
# (scannet_util.get_raw2scannetv2_label_map over scannetv2-labels.combined.tsv)


def load_raw2name(tsv_path):
    keep = {
        "wall", "floor", "chair", "table", "desk", "bed", "bookshelf", "sofa",
        "sink", "bathtub", "toilet", "curtain", "counter", "door", "window",
        "shower curtain", "refridgerator", "picture", "cabinet", "otherfurniture",
    }
    out = {}
    with open(tsv_path) as f:
        header = f.readline()
        del header
        for line in f:
            el = line.rstrip("\n").split("\t")
            out[el[1]] = el[7] if el[7] in keep else "unannotated"
    return out


def prepare_scan(ply_path, raw2name, test_mode=False):
    scan = osp.basename(ply_path)[: -len("_vh_clean_2.ply")]
    base = ply_path[: -len("_vh_clean_2.ply")]
    mesh = read_ply(ply_path)
    v = mesh["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float32)
    xyz = xyz - xyz.mean(0)
    rgb = np.stack([v["red"], v["green"], v["blue"]], 1).astype(np.float32)
    rgb = rgb / 127.5 - 1
    faces = mesh["face"]
    spp = segment_mesh(xyz, faces)

    if test_mode:
        return scan, (xyz, rgb), spp

    lab = read_ply(base + "_vh_clean_2.labels.ply")["vertex"]["label"]
    sem = REMAPPER[np.clip(np.asarray(lab, np.int64), 0, 149)]

    with open(base + "_vh_clean_2.0.010000.segs.json") as f:
        seg = np.asarray(json.load(f)["segIndices"])
    with open(base + ".aggregation.json") as f:
        groups = json.load(f)["segGroups"]

    inst = np.full(len(xyz), -100, np.int64)
    k = 0
    for g in groups:
        name = raw2name.get(g["label"], "unannotated")
        if name in ("wall", "floor"):
            continue
        member = np.isin(seg, g["segments"])
        inst[member] = k
        k += 1
    return scan, (xyz, rgb, sem, inst), spp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gapro_tpu_torch prepare_scannet")
    ap.add_argument("--scans_dir", required=True,
                    help="dir of raw scan files (ply/json per scan)")
    ap.add_argument("--out", default="dataset/scannetv2")
    ap.add_argument("--split", default="train", choices=["train", "val", "test"])
    ap.add_argument("--labels_tsv", default="scannetv2-labels.combined.tsv")
    args = ap.parse_args(argv)

    raw2name = None if args.split == "test" else load_raw2name(args.labels_tsv)
    os.makedirs(osp.join(args.out, args.split), exist_ok=True)
    os.makedirs(osp.join(args.out, "superpoints"), exist_ok=True)

    plys = sorted(glob(osp.join(args.scans_dir, "*_vh_clean_2.ply")))
    for p in plys:
        scan, tup, spp = prepare_scan(p, raw2name, test_mode=args.split == "test")
        torch.save(tup, osp.join(args.out, args.split, scan + "_inst_nostuff.pth"))
        torch.save(spp, osp.join(args.out, "superpoints", scan + ".pth"))
        print(scan, len(tup[0]), "pts", int(spp.max()) + 1, "superpoints")
    return 0


if __name__ == "__main__":
    sys.exit(main())
