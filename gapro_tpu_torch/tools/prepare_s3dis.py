"""Offline S3DIS preparation: the port of ``tools/prepare_s3dis.py``
(reference: ISBNet/dataset/s3dis/prepare_s3dis.py + prepare_superpoints.py).

    python -m gapro_tpu_torch.tools.prepare_s3dis \
        --data_dir Stanford3dDataset_v1.2_Aligned_Version --out dataset/s3dis --areas 1,2,3,4,5,6

Walks `Area_*/room/Annotations/<class>_<k>.txt` object files of the Stanford
aligned dataset, concatenates them into per-room (xyz, rgb, sem, inst) pth
tensors (rgb scaled to [-1, 1], xyz mean-centered in xy), and generates
superpoints. S3DIS has no mesh, so superpoints come from a normal-aware
geometric partition: kNN graph over a voxel-grid subsample, edges weighted
by PCA-normal dissimilarity, Felzenszwalb union-find (the same native
segmentator core applied to a point graph).

Outputs <out>/preprocess/<Area>_<room>_inst_nostuff.pth (+ superpoints/).
This is host work (numpy and scipy's cKDTree): it runs on no device.
"""

import argparse
import os
import os.path as osp
import sys
from glob import glob

import numpy as np
import torch

CLASSES = ("ceiling", "floor", "wall", "beam", "column", "window", "door",
           "chair", "table", "bookcase", "sofa", "board", "clutter")
CLASS2ID = {c: i for i, c in enumerate(CLASSES)}


def geometric_superpoints(xyz, voxel=0.08, k=12, kthr=0.3, seg_min=30):
    """Point-cloud superpoints: voxel-subsample -> kNN graph with PCA-normal
    weights -> FH segmentation -> propagate to all points."""
    from scipy.spatial import cKDTree

    cell = np.floor(xyz / voxel).astype(np.int64)
    _, rep, inv = np.unique(
        cell[:, 0] * 73856093 + cell[:, 1] * 19349663 + cell[:, 2] * 83492791,
        return_index=True, return_inverse=True,
    )
    sub = xyz[rep]
    tree = cKDTree(sub)
    _, nbr = tree.query(sub, k=min(k + 1, len(sub)))
    # PCA normals per subsampled point
    normals = np.zeros_like(sub)
    for i in range(len(sub)):
        nn = sub[nbr[i]] - sub[nbr[i]].mean(0)
        cov = nn.T @ nn
        w, v = np.linalg.eigh(cov)
        normals[i] = v[:, 0]
    # FH over the kNN edges via the union-find in numpy
    edges = []
    for i in range(len(sub)):
        for j in nbr[i][1:]:
            a, b = (i, int(j)) if i < j else (int(j), i)
            edges.append((a, b, 1.0 - abs(normals[a] @ normals[b])))
    edges = sorted(set(edges), key=lambda e: e[2])
    parent = np.arange(len(sub))
    size = np.ones(len(sub), np.int64)
    internal = np.zeros(len(sub))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b, w in edges:
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        if w <= min(internal[ra] + kthr / size[ra], internal[rb] + kthr / size[rb]):
            parent[rb] = ra
            size[ra] += size[rb]
            internal[ra] = w
    for a, b, w in edges:
        ra, rb = find(a), find(b)
        if ra != rb and (size[ra] < seg_min or size[rb] < seg_min):
            parent[rb] = ra
            size[ra] += size[rb]
    labels_sub = np.array([find(i) for i in range(len(sub))])
    _, labels_sub = np.unique(labels_sub, return_inverse=True)
    return labels_sub[inv]


def prepare_room(room_dir):
    pts, cols, sems, insts = [], [], [], []
    k = 0
    for f in sorted(glob(osp.join(room_dir, "Annotations", "*.txt"))):
        cls = osp.basename(f).split("_")[0]
        cid = CLASS2ID.get(cls, CLASS2ID["clutter"])
        data = np.loadtxt(f)
        pts.append(data[:, :3])
        cols.append(data[:, 3:6] / 127.5 - 1)
        sems.append(np.full(len(data), cid))
        insts.append(np.full(len(data), k))
        k += 1
    xyz = np.concatenate(pts).astype(np.float32)
    xyz[:, :2] -= xyz[:, :2].mean(0)
    xyz[:, 2] -= xyz[:, 2].min()
    return (xyz, np.concatenate(cols).astype(np.float32),
            np.concatenate(sems).astype(np.int64),
            np.concatenate(insts).astype(np.int64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gapro_tpu_torch prepare_s3dis")
    ap.add_argument("--data_dir", required=True,
                    help="Stanford3dDataset_v1.2_Aligned_Version root")
    ap.add_argument("--out", default="dataset/s3dis")
    ap.add_argument("--areas", default="1,2,3,4,5,6")
    args = ap.parse_args(argv)

    os.makedirs(osp.join(args.out, "preprocess"), exist_ok=True)
    os.makedirs(osp.join(args.out, "superpoints"), exist_ok=True)
    for area in args.areas.split(","):
        for room_dir in sorted(glob(osp.join(args.data_dir, f"Area_{area}", "*"))):
            if not osp.isdir(room_dir):
                continue
            name = f"Area_{area}_{osp.basename(room_dir)}"
            out_pth = osp.join(args.out, "preprocess", name + "_inst_nostuff.pth")
            if osp.exists(out_pth):
                continue
            xyz, rgb, sem, inst = prepare_room(room_dir)
            spp = geometric_superpoints(xyz)
            torch.save((xyz, rgb, sem, inst), out_pth)
            torch.save(spp, osp.join(args.out, "superpoints", name + ".pth"))
            print(name, len(xyz), "pts", int(spp.max()) + 1, "superpoints")
    return 0


if __name__ == "__main__":
    sys.exit(main())
