"""The ``infer_x4`` driver: the test CLI's x4 request on S3DIS rooms in a
closed loop of one client.

A request is the test CLI's per-scene body for an ISBNet with the test
section's ``x4_split`` (``tools/test.py:run_test``): the loader's batch of
one room -> ``serve_room``, which splits the room into 4 interleaved
pieces (``split_room``), prepares them as a batch of 4, runs
``forward_inference(x4_split=True)``, puts the points back into the
room's order (``room_point2voxel``) and runs ``infer_scene_instances``
under the config's test section (``sem2ins_classes`` among it); the
instance records, in the room's point order, on the host. The stages are
timed through ``serve_room``'s own hook; a request with any ``ovf_*``
counter above 0 (``overflows``: the outputs' and ``prepare``'s) fails.
Set-up checks that no room numbers more superpoint ids over its pieces
than ``spp_cap`` holds, and serves each capacity bucket's room
twice; the window then serves the seed's order of the pool, each request
sent when the last one's records are in. Once the window has closed, a
sample of its requests drawn from the seed, the largest room among them,
is served again by the reference (``reference/x4.py``).

In a traced run the port's own tracing (``utils/profiling.py``) is on:
each window request's spans are handed to the readers as its seconds
under the span's name (``x4.split``, ``x4.merge``, ...), and the record a
request, counters included, is printed on standard error.
"""

from __future__ import annotations

import json
import math
import sys

import numpy as np
import torch

from ..lib import feed, rooms, traffic, weights
from .infer import sample
from .train import free

WARM_PASSES = 2  # each bucket's room served this many times in set-up


def plan(config: dict, mix: dict, seed: int) -> dict:
    from ..reference import build

    pool = rooms.make_pool(seed, mix["pool"])
    buckets = {}
    for i, r in enumerate(pool):
        buckets.setdefault(build.bucket(len(r["xyz"])), i)
    warm = [i for _ in range(WARM_PASSES) for i in sorted(buckets.values())]
    order = traffic.request_order(seed, len(pool), mix["requests"])
    return dict(pool=pool, warm=warm, order=order, buckets=sorted(buckets))


def superpoint_ids(config: dict, pool: list) -> list:
    """Each room's superpoint ids summed over its x4 pieces (each piece
    numbers its own), as the test transform leaves the room; raises
    ``ValueError`` where one exceeds ``spp_cap``, past which ``prepare``
    drops ids (``ovf_spp_ids``)."""
    from gapro_tpu_torch.data.augment import transform_test
    from gapro_tpu_torch.data.dataset import S3DISDataset
    from gapro_tpu_torch.tools.test import X4_PIECES

    scale, cap = config["data"]["voxel"]["scale"], config["model"]["spp_cap"]
    ids = [sum(len(np.unique(p["spp"])) for p in S3DISDataset.split_pieces(
        transform_test(dict(xyz=r["xyz"], spp=r["spp"]), scale), X4_PIECES)) for r in pool]
    over = [(i, n) for i, n in enumerate(ids) if n > cap]
    if over:
        raise ValueError(f"x4 rooms number more superpoint ids than spp_cap {cap} holds "
                         f"(room, ids): {over}")
    return ids


class Program:
    """The port's model with the benchmark's weights, the test CLI's serial
    loader over the sequence, and ``serve_room``."""

    def __init__(self, config: dict, mix: dict, p: dict, seed: int, device, spans):
        from gapro_tpu_torch.data.dataset import build_dataloader
        from gapro_tpu_torch.tools import test as cli
        from gapro_tpu_torch.tools import train as trainer
        from gapro_tpu_torch.train.config import AttrDict
        from gapro_tpu_torch.utils import profiling

        cfg = AttrDict.wrap(config)
        self.cfg, self.spans, self.device = cfg, spans, device
        self.cli, self.profiling = cli, profiling
        self.model, _ = trainer.build_model(cfg, device, seed=0)
        weights.load(self.model, weights.draw(weights.leaves(self.model), seed, device,
                                              config.get("assumed", {}).get("bias_shift", {})))
        self.model.eval()
        self.prepare = trainer.make_prepare(cfg, device)
        self.scale = config["data"]["voxel"]["scale"]
        ds = feed.PoolDataset(p["pool"], p["warm"] + p["order"], config)
        self.loader = build_dataloader(ds, 1, training=False, drop_last=False)
        self.served = []  # (position, records) of the window's requests
        self.position = 0
        self.record = False
        self.kept = None

    @torch.no_grad()
    def step(self) -> tuple:
        """One request: (its counters, whether it counts as done)."""
        self.profiling.set_unit(self.position)
        with self.spans.span("data_wait"):
            lb = next(self.loader)
        if self.kept is not None:
            self.kept.append(lb)
        start, mark = self.spans.marks()
        start()
        prepared, out, insts = self.cli.serve_room(self.model, self.cfg, lb.scenes[0],
                                                   self.prepare, self.scale, lb.scan_ids[0],
                                                   stage=mark)
        ovf = self.cli.overflows(prepared, out)
        ok = not any(ovf.values()) and all(math.isfinite(r["conf"]) for r in insts)
        if not ok:
            print(f"request {self.position} ({lb.scan_ids[0]}) not done: {ovf}, confidences "
                  f"finite: {all(math.isfinite(r['conf']) for r in insts)}", file=sys.stderr)
        if self.record:
            self.served.append((self.position, insts))
        self.position += 1
        return {}, ok

    def close(self) -> None:
        self.loader.close()


def reference_records(config: dict, p: dict, positions: list, seed: int, device,
                      tf32: bool = False) -> list:
    """The reference's records for the requests at ``positions`` of the
    sequence (``tf32``: its products in TF32, a control)."""
    from ..reference import build, x4

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = build.build_model(config, device)
        weights.load(model, weights.draw(weights.leaves(model), seed, device,
                                         config.get("assumed", {}).get("bias_shift", {})))
        sequence = p["warm"] + p["order"]
        out = []
        for pos in positions:
            room = p["pool"][sequence[pos]]
            out.append(x4.request(config, model, room, room["scan_id"], device))
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def numbers(got: list, want: list) -> dict:
    """``compare.infer_numbers`` over rooms of a million points: the same
    pairing (each served instance, in order of confidence, with the
    unpaired reference instance of its label of the largest mask IoU, at
    0.5 or more) and the same numbers, each mask decoded once and without
    a loop over its runs."""
    from ..reference.utils.rle import rle_decode

    confs, masks = [], []
    unpaired = total = 0
    for g, w in zip(got, want):
        gm = [rle_decode(r["pred_mask"]) for r in g]
        wm = [rle_decode(r["pred_mask"]) for r in w]
        wn = [np.count_nonzero(m) for m in wm]
        free_ = set(range(len(w)))
        for i in sorted(range(len(g)), key=lambda i: -g[i]["conf"]):
            best, at = 0.0, None
            gn = np.count_nonzero(gm[i])
            for j in sorted(free_):
                if w[j]["label_id"] != g[i]["label_id"]:
                    continue
                inter = np.count_nonzero(gm[i] & wm[j])
                union = gn + wn[j] - inter
                iou = inter / union if union else 1.0
                if iou > best:
                    best, at = iou, j
            if at is None or best < 0.5:
                unpaired += 1
                continue
            free_.discard(at)
            confs.append(abs(g[i]["conf"] - w[at]["conf"]))
            masks.append(1.0 - best)
        unpaired += len(free_)
        total += len(g) + len(w)
    med = lambda v: float(np.median(v)) if v else 0.0
    return dict(conf_gap=max(confs, default=0.0), mask_gap=max(masks, default=0.0),
                conf_gap_median=med(confs), mask_gap_mean=float(np.mean(masks)) if masks
                else 0.0, unpaired=unpaired, instances=total)


def _port_spans(record: dict, units: set) -> dict:
    """name -> the seconds of each of ``units`` under the port's spans of
    that name, a request each."""
    per = {}
    for sp in record["spans"]:
        if sp.unit in units:
            by_unit = per.setdefault(sp.name, {})
            by_unit[sp.unit] = by_unit.get(sp.unit, 0.0) + (sp.end_ns - sp.start_ns) / 1e9
    return {name: list(by_unit.values()) for name, by_unit in per.items()}


def run(ctx) -> dict:
    # first: a port without the x4 request's overflow report (and its spans)
    # fails the run here, at once
    from gapro_tpu_torch.tools.test import overflows  # noqa: F401
    from gapro_tpu_torch.utils import profiling

    config, mix, seed, device, spans = ctx.config, ctx.mix, ctx.seed, ctx.device, ctx.spans
    ctx.note("imports")
    p = plan(config, mix, seed)
    ids = superpoint_ids(config, p["pool"])
    print("capacity buckets of the pool's rooms:", p["buckets"], "; superpoint ids over each "
          f"room's pieces: {ids} (spp_cap {config['model']['spp_cap']})", flush=True)
    ctx.note("room pool")
    own = ctx.trace and not profiling.enabled()  # else the caller's tracing is left as it is
    if own:
        profiling.enable(True)
    try:
        prog = Program(config, mix, p, seed, device, spans)
        ctx.note("model")
        for _ in p["warm"]:
            prog.step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ctx.setup_done()
        spans.seconds.clear()
        if own:
            profiling.drain()

        prog.record = True
        first = prog.position
        w = ctx.window(prog.step, 1, prog)
        prog.record = False
        prog.close()
        ctx.after_window()
        print("the window's requests, seconds each:", json.dumps(
            {k: [round(x, 4) for x in v] for k, v in
             dict(spans.seconds, request=w["latencies"]).items()}), file=sys.stderr, flush=True)
        if ctx.trace:
            record = profiling.drain()
            if not own:
                profiling.merge(record)
            units = set(range(first, prog.position))
            spans.seconds.update(_port_spans(record, units))
            print("port tracing a request:", json.dumps(profiling.per_unit(
                dict(spans=[s for s in record["spans"] if s.unit in units],
                     counts=record["counts"]), len(units))), file=sys.stderr, flush=True)
        kept = ctx.kept
        if ctx.trace and kept:
            ctx.count_pass(prog.model, [lambda lb=lb: _count_request(prog, ctx.probes, lb)
                                        for lb in kept],
                           backward=False, dense_passes=1)
    finally:
        profiling.set_unit(None)
        if own:
            profiling.enable(False)
            profiling.drain()
    served = dict(prog.served)
    prog = None
    free()
    positions = sample(p, list(served.items()), seed, mix["check_requests"])
    want = reference_records(config, p, positions, seed, device)
    nums = numbers([served[q] for q in positions], want)
    return dict(window=w, numbers=nums, positions=positions)


@torch.no_grad()
def _count_request(prog, probes, lb):
    points = prog.cli.split_room(lb.scenes[0], prog.scale)[0]
    prepared = prog.prepare(points, prog.cli.X4_PIECES)
    probes.set_unit(points.valid, prepared.batch)
    prog.model.forward_inference(prepared.batch, x4_split=True)
