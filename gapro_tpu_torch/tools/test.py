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
(``S3DISDataset.split_pieces``, split on the device) in one batch, whose
points are put back into the room's order before the instance stage
builds each mask. A scene whose ``ovf_*`` counters (``overflows``) read
data dropped is logged as a warning. Without a checkpoint the weights are drawn from ``--seed``.
``--save_pointwise DIR`` (ISBNet) writes each scene's point-wise heads as
the reference's viewers read them (``save_pointwise``).
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

from ..core.bucketing import next_bucket
from ..data.dataset import build_dataloader
from ..device import resolve_device
from ..eval.instance_eval import S3DIS_INSTANCE_CLASSES, SCANNET_INSTANCE_CLASSES, ScanNetEval
from ..eval.runner import infer_scene_instances, make_infer_fn
from ..eval.s3dis_eval import S3DISEval
from ..models.prepare import PointBatch
from ..train.checkpoint import load_model_weights
from ..train.config import load_config
from ..utils import profiling
from ..utils.rle import rle_decode
from .train import build_dataset, build_model, make_prepare


@torch.no_grad()
def run_test(cfg, checkpoint: Optional[str] = None, *, device=None, seed: int = 0,
             synthetic: int = 0, dataset=None, out: Optional[str] = None, evaluate: bool = True,
             model=None, pointwise: Optional[str] = None) -> dict:
    """Serve and score the config's test split (or ``dataset``) on one
    device (``cuda`` unless named). ``model`` replaces the one built from
    the config and ``checkpoint``; ``pointwise``, a directory, receives an
    ISBNet's point-wise heads of each scene (``save_pointwise``). Returns
    the per-scene seconds, the
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
        perm = None
        if x4:
            prepared, outputs, insts = serve_room(model, cfg, scene, prepare,
                                                  dataset.voxel_cfg.scale, scan_id)
        else:
            prepared = prepare(lb.points, 1)
            outputs = infer(prepared.batch)
            insts = infer_scene_instances(model_type, outputs, prepared.batch, scene["spp"],
                                          prepared.point2voxel, n_points, scan_id,
                                          cfg.get("test", {}))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        ovf = {k: v for k, v in overflows(prepared, outputs).items() if v}
        if ovf:
            log.warning("%s: capacities exceeded, data dropped: %s", scan_id, ovf)
        if pointwise and model_type == "isbnet":
            if x4:
                perm = split_room(scene, dataset.voxel_cfg.scale, dev)[1]
            save_pointwise(pointwise, scan_id, outputs, prepared.point2voxel, n_points, perm)
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


# The room's per-point fields the split reads, uploaded once in the room's order.
_ROOM_FIELDS = ("xyz", "xyz_scaled", "rgb", "spp", "semantic", "instance", "prob", "mu", "var")


def split_room(scene, voxel_scale, device="cpu"):
    """An S3DIS room as x4_split serves it: the point batch of its
    ``X4_PIECES`` interleaved pieces and the room's index of each of the
    batch's points (``perm``), both on ``device``. The room's fields are
    uploaded once (``h2d_bytes``); there a stable sort of x dealt
    round-robin gives the pieces, and the batch is gathered from the room
    field for field as ``points_to_batch_np`` collates
    ``S3DISDataset.split_pieces``. Span ``x4.split``; counter
    ``x4.room_points``."""
    with profiling.span("x4.split"):
        n = len(scene["xyz"])
        profiling.count("x4.room_points", n)
        dev = torch.device(device)
        room = {k: torch.as_tensor(np.asarray(scene[k])) for k in _ROOM_FIELDS if k in scene}
        if dev.type != "cpu":
            profiling.count("h2d_bytes", sum(t.numel() * t.element_size() for t in room.values()))
            room = {k: t.to(dev) for k, t in room.items()}
        # +0.0 makes -0.0 a plain 0.0, equal to it as numpy's sort holds it
        order = torch.sort(room["xyz"][:, 0] + 0.0, stable=True).indices
        perm = torch.cat([order[p::X4_PIECES] for p in range(X4_PIECES)])
        return _piece_batch(room, perm, voxel_scale), perm


def _piece_batch(room: dict, perm, voxel_scale) -> PointBatch:
    """The padded ``PointBatch`` of the room's points taken in ``perm``'s
    order, as ``X4_PIECES`` pieces of ``ceil((n - p) / X4_PIECES)`` points
    each; where ``perm`` lies, with no read on the host."""
    n, dev = len(perm), perm.device
    lens = [(n - p + X4_PIECES - 1) // X4_PIECES for p in range(X4_PIECES)]
    starts = [sum(lens[:p]) for p in range(X4_PIECES)]
    rows = [slice(s, s + k) for s, k in zip(starts, lens)]
    piece = torch.empty(n, dtype=torch.long, device=dev)
    for p, r in enumerate(rows):
        piece[r] = p
    cap = next_bucket(n)

    def take(k, dtype, default=None):  # the room's field in perm's order, or the default
        if k not in room:
            return torch.full((n,), default, dtype=dtype, device=dev)
        return room[k][perm].to(dtype)

    def field(values, pad, dtype):
        out = torch.full((cap,) + tuple(values.shape[1:]), pad, dtype=dtype, device=dev)
        out[:n] = values
        return out

    xyz = take("xyz", torch.float32)
    # floor per axis (xyz_scaled in float64, else xyz * scale in float32),
    # shifted to each piece's minimum; (x, y, z) -> columns 3, 2, 1
    q = (room["xyz_scaled"][perm] if "xyz_scaled" in room else xyz * voxel_scale).floor().long()
    for r in rows:
        q[r] -= q[r].amin(0)
    coords = torch.cat([piece[:, None], q.flip(1)], 1)

    # each superpoint id's rank among its piece's distinct ids, offset by the
    # distinct ids of the pieces before it: a sort within each piece, a new
    # rank at each piece's start and at each change of id
    spp = room["spp"][perm]
    at = torch.empty(n, dtype=torch.long, device=dev)
    ordered = torch.empty_like(spp)
    new = torch.ones(n, dtype=torch.bool, device=dev)
    for s, r in zip(starts, rows):
        values, i = torch.sort(spp[r])
        ordered[r] = values
        at[r] = i + s
    new[1:] = (ordered[1:] != ordered[:-1]) | (piece[1:] != piece[:-1])
    ranks = torch.empty(n, dtype=torch.long, device=dev)
    ranks[at] = new.cumsum(0) - 1

    # instance ids >= 0 shifted past the previous pieces' largest
    instance = take("instance", torch.int32, -100)
    top = torch.stack([instance[r].amax() for r in rows]).long()
    grow = torch.where(top >= 0, top + 1, 0)
    instance = instance + (grow.cumsum(0) - grow)[piece] * (instance >= 0)

    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[:n] = True
    return PointBatch(
        coords=field(coords, -1, torch.int32), coords_float=field(xyz, 0, torch.float32),
        feats=field(take("rgb", torch.float32), 0, torch.float32),
        spp=field(ranks, -1, torch.int32), valid=valid,
        semantic=field(take("semantic", torch.int32, -100), -100, torch.int32),
        instance=field(instance, -100, torch.int32),
        prob=field(take("prob", torch.float32, 1.0), 0, torch.float32),
        mu=field(take("mu", torch.float32, -100.0), -100.0, torch.float32),
        var=field(take("var", torch.float32, -100.0), -100.0, torch.float32))


def overflows(prepared, outputs) -> dict:
    """A request's ``ovf_*`` counters: the outputs' and ``prepare``'s
    ``ovf_spp_ids`` (superpoint ids past ``spp_cap``, which the model never
    sees), each an int."""
    ovf = {k: int(v) for k, v in outputs.items() if k.startswith("ovf_")}
    ovf["ovf_spp_ids"] = prepared.batch.ovf_spp_ids
    return ovf


def serve_room(model, cfg, room, prepare, voxel_scale, scan_id: str = "room", stage=None):
    """Serve one S3DIS room as x4_split does: ``split_room`` on the model's
    device -> ``prepare`` of its ``X4_PIECES`` pieces -> ISBNet's
    ``forward_inference(x4_split=True)`` -> the points put back into the
    room's order (``room_point2voxel``) ->
    ``get_instances`` under the config's test section, each mask in the
    room's point order. ``stage(name)``, when given, is called at the end of
    each of the stages ``split``, ``prepare``, ``forward``, ``merge`` and
    ``instances`` (a timer's hook). Returns the prepared batch, the outputs
    and the instance records."""
    mark = stage or (lambda name: None)
    points, perm = split_room(room, voxel_scale, next(model.parameters()).device)
    mark("split")
    prepared = prepare(points, X4_PIECES)
    mark("prepare")
    outputs = model.forward_inference(prepared.batch, x4_split=True)
    mark("forward")
    point2voxel = room_point2voxel(prepared.point2voxel, perm)
    mark("merge")
    insts = infer_scene_instances("isbnet", outputs, prepared.batch, room["spp"], point2voxel,
                                  len(perm), scan_id, cfg.get("test", {}))
    mark("instances")
    return prepared, outputs, insts


def room_point2voxel(point2voxel, perm):
    """The voxel of each of the room's points in the room's order: the x4
    batch's ``point2voxel``, in the pieces' order (``perm``: the room's
    index of each of its points), taken through the inverse permutation
    (``_in_room_order``). The instance stage then builds and encodes each
    mask in the room's order, the records that decoding each mask,
    permuting it and encoding it again would give. Span ``x4.merge``."""
    with profiling.span("x4.merge"):
        return _in_room_order(point2voxel, perm)


def _in_room_order(values, perm):
    """``values`` of the pieces' points in the room's order: the inverse of
    ``perm`` (a tensor on any device, or an array), built by a scatter
    where ``values`` lie, gathers them."""
    perm = torch.as_tensor(perm, device=values.device)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(len(perm), device=values.device)
    return values[inv]


def save_pointwise(out_dir: str, scan_id: str, outputs, point2voxel, n_points: int,
                   perm=None) -> None:
    """One scene's point-wise heads in the layout of the reference's viewers
    (``prediction_path``): ``semantic_pred/<scan>.npy`` (int32 class per
    point), ``offset_pred/<scan>.npy`` (float32 [n, 3], the centre of the
    predicted box) and ``offset_vertices_pred/<scan>.npy`` (float32 [n, 6],
    the box's corner offsets), each point taking its voxel's. ``perm`` (the
    x4_split path: the room's index of each point of the pieces, a tensor
    on any device) puts the points back into the room's order."""
    p2v = (point2voxel[:n_points] if perm is None else _in_room_order(point2voxel, perm)).long()
    sem = outputs["semantic_scores"].argmax(1)[p2v].cpu().numpy().astype(np.int32)
    corners = outputs["corners_offset"][p2v].cpu().numpy().astype(np.float32)
    for sub, arr in (("semantic_pred", sem),
                     ("offset_pred", ((corners[:, :3] + corners[:, 3:]) / 2).astype(np.float32)),
                     ("offset_vertices_pred", corners)):
        os.makedirs(osp.join(out_dir, sub), exist_ok=True)
        np.save(osp.join(out_dir, sub, scan_id + ".npy"), arr)


def export_benchmark(out_dir: str, scan_id: str, instances, n_points: int) -> None:
    """The ScanNet benchmark's submission format: ``<scan>.txt`` with one
    line ``pred_mask/<scan>_<i>.txt label conf`` per instance, and each
    mask as a column of 0/1, the bytes ``np.savetxt(fmt="%d")`` writes,
    made in one pass over the mask."""
    os.makedirs(osp.join(out_dir, "pred_mask"), exist_ok=True)
    lines = []
    for i, inst in enumerate(instances):
        rel = f"pred_mask/{scan_id}_{i:03d}.txt"
        mask = rle_decode(inst["pred_mask"]).astype(bool)
        column = np.full((len(mask), 2), ord("\n"), np.uint8)
        column[:, 0] = ord("0") + mask
        with open(osp.join(out_dir, rel), "wb") as f:
            f.write(column.tobytes())
        lines.append(f"{rel} {inst['label_id']} {inst['conf']:.4f}")
    with open(osp.join(out_dir, scan_id + ".txt"), "w") as f:
        f.write("\n".join(lines))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("gapro_tpu_torch test")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--out", default=None, help="benchmark-format export dir")
    ap.add_argument("--save_pointwise", default=None,
                    help="write per-point semantic_pred/, offset_pred/ and "
                         "offset_vertices_pred/ .npy files (ISBNet) into this directory")
    ap.add_argument("--no_eval", action="store_true")
    ap.add_argument("--seed", type=int, default=0,
                    help="weights drawn from this seed when no checkpoint is given")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = load_config(args.config)
    res = run_test(cfg, args.checkpoint, device=args.device, seed=args.seed,
                   synthetic=args.synthetic, out=args.out, evaluate=not args.no_eval,
                   pointwise=args.save_pointwise)
    if res["result"] is not None:
        print(json.dumps({k: v for k, v in res["result"].items() if k != "classes"}))
    if res["box_result"] is not None:
        print(json.dumps({"box_" + k: v for k, v in res["box_result"].items()
                          if k != "classes"}))
    if res["s3dis_result"] is not None:
        print(json.dumps(res["s3dis_result"]))


if __name__ == "__main__":
    main()
