"""The ``infer`` driver: the port's test request in a closed loop of one
client.

A request is the test CLI's per-scene body (``tools/test.py:run_test``):
the loader's batch of one scene -> ``make_prepare`` ->
``eval/runner.py:make_infer_fn`` -> ``infer_scene_instances``, the
instance records on the host. Set-up serves the pool's scenes of each
capacity bucket; the window then serves the seed's order of the pool, each
request sent when the last one's records are in. Once the window has
closed, a sample of its requests drawn from the seed, the largest scene
among them, is served again by the reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..lib import compare, feed, traffic, weights
from .train import free

WARM_PASSES = 2  # each bucket's scene served this many times in set-up
EPOCH = 0  # the test loader's epoch (it does not shuffle)


def plan(config: dict, mix: dict, seed: int) -> dict:
    from ..reference import build

    pool = traffic.make_pool(seed, mix["pool"])
    buckets = {}
    for i, s in enumerate(pool):
        buckets.setdefault(build.bucket(len(s["xyz"])), i)
    warm = [i for _ in range(WARM_PASSES) for i in sorted(buckets.values())]
    order = traffic.request_order(seed, len(pool), mix["requests"])
    return dict(pool=pool, warm=warm, order=order, buckets=sorted(buckets))


class Program:
    """The port's model with the benchmark's weights, and the test CLI's
    serial loader over the sequence."""

    def __init__(self, config: dict, mix: dict, p: dict, seed: int, device, spans):
        from gapro_tpu_torch.data.dataset import build_dataloader
        from gapro_tpu_torch.eval.runner import infer_scene_instances, make_infer_fn
        from gapro_tpu_torch.tools import train as trainer
        from gapro_tpu_torch.train.config import AttrDict

        cfg = AttrDict.wrap(config)
        self.cfg, self.spans, self.device = cfg, spans, device
        self.model, _ = trainer.build_model(cfg, device, seed=0)
        weights.load(self.model, weights.draw(weights.leaves(self.model), seed, device,
                                              config.get("assumed", {}).get("bias_shift", {})))
        self.model.eval()
        self.type = config["model"]["type"]
        self.infer = make_infer_fn(self.model, self.type)
        self.instances = infer_scene_instances
        self.prepare = trainer.make_prepare(cfg, device)
        self.sequence = p["warm"] + p["order"]
        ds = feed.PoolDataset(p["pool"], self.sequence, config)
        self.loader = build_dataloader(ds, 1, training=False, drop_last=False)
        self.served = []  # (position, records) of the window's requests
        self.position = 0
        self.record = False
        self.kept = None

    @torch.no_grad()
    def step(self) -> tuple:
        """One request: (its counters, whether it counts as done)."""
        with self.spans.span("data_wait"):
            lb = next(self.loader)
        if self.kept is not None:
            self.kept.append(lb)
        scene = lb.scenes[0]
        with self.spans.span("prepare"):
            prepared = self.prepare(lb.points, 1)
        with self.spans.span("forward"):
            out = self.infer(prepared.batch)
        with self.spans.span("instances"):
            insts = self.instances(self.type, out, prepared.batch, scene["spp"],
                                   prepared.point2voxel, len(scene["xyz"]), lb.scan_ids[0],
                                   self.cfg.get("test", {}))
        ok = all(int(v) == 0 for k, v in out.items() if k.startswith("ovf_"))
        ok &= all(math.isfinite(r["conf"]) for r in insts)
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
    from ..reference import build

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = build.build_model(config, device)
        weights.load(model, weights.draw(weights.leaves(model), seed, device,
                                         config.get("assumed", {}).get("bias_shift", {})))
        sequence = p["warm"] + p["order"]
        out = []
        for pos in positions:
            scene = build.test_scene(config, dict(p["pool"][sequence[pos]]))
            prepared = build.prepare(config, build.batch(config, [scene]), 1, device)
            res = build.infer(config, model, prepared)
            out.append(build.instances(config, res, prepared, scene, scene["scan_id"]))
            del prepared, res
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def sample(p: dict, served: list, seed: int, n: int) -> list:
    """Positions of ``n`` served requests drawn from the seed, the one of
    the most points among them."""
    sequence = p["warm"] + p["order"]
    positions = [pos for pos, _ in served]
    if not positions:
        return []
    size = lambda pos: len(p["pool"][sequence[pos]]["xyz"])
    largest = max(positions, key=size)
    rng = np.random.default_rng([seed, 6])
    rest = [q for q in positions if q != largest]
    picked = list(rng.choice(rest, size=min(n - 1, len(rest)), replace=False)) if rest else []
    return sorted([largest] + [int(q) for q in picked])


def run(ctx) -> dict:
    config, mix, seed, device, spans = ctx.config, ctx.mix, ctx.seed, ctx.device, ctx.spans
    ctx.note("imports")
    p = plan(config, mix, seed)
    print("capacity buckets of the pool's scenes:", p["buckets"], flush=True)
    ctx.note("scene pool")
    prog = Program(config, mix, p, seed, device, spans)
    ctx.note("model")
    for _ in p["warm"]:
        prog.step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx.setup_done()
    spans.seconds.clear()

    prog.record = True
    w = ctx.window(prog.step, 1, prog)
    prog.record = False
    prog.close()
    ctx.after_window()
    kept = ctx.kept
    if ctx.trace and kept:
        ctx.count_pass(prog.model, [lambda lb=lb: _count_request(prog, ctx.probes, lb)
                                    for lb in kept],
                       backward=False, dense_passes=1)
    served = dict(prog.served)
    prog = None
    free()
    positions = sample(p, list(served.items()), seed, mix["check_requests"])
    want = reference_records(config, p, positions, seed, device)
    numbers = compare.infer_numbers([served[q] for q in positions], want)
    return dict(window=w, numbers=numbers, positions=positions)


@torch.no_grad()
def _count_request(prog, probes, lb):
    prepared = prog.prepare(lb.points, 1)
    probes.set_unit(lb.points.valid, prepared.batch)
    prog.infer(prepared.batch)
