"""The ``train`` driver: the port's trainer step in a window.

One training object (the model with the benchmark's weights, its AdamW
state, ``make_train_step`` / ``make_spformer_train_step``, ``make_prepare``
and the forked loader over the pool) is built in set-up and driven from
the seed through its first steps, the first ``CHECKED`` of which the
reference follows, and through one step on a batch of each capacity
bucket that the epoch's shuffled batches reach; then the same object runs
the window: loader ->
prepare -> step -> the losses read back as floats, at the trainer's
learning rate for the batch, held constant.
"""

from __future__ import annotations

import gc
import math

import torch

from ..lib import compare, feed, traffic, weights

CHECKED = 3  # steps the reference follows
EPOCH = 1


def _finite_and_counted(vals: dict) -> bool:
    for k, v in vals.items():
        if k.startswith("ovf_"):
            if v != 0:
                return False
        elif not math.isfinite(v):
            return False
    return True


def plan(config: dict, mix: dict, seed: int) -> dict:
    """The pool, the epoch's dataset (the pool repeated, as the port's
    ``SyntheticDataset`` repeats its scenes) and the batches of pool
    indices in the order the port's loader shuffles it to."""
    from ..reference import build

    b = config["train"]["batch_size"]
    pool = traffic.make_pool(seed, mix["pool"])
    sequence = [i % len(pool) for i in range(mix["epoch_batches"] * b)]
    order = feed.loader_order(len(sequence), seed, EPOCH)
    batches = [[sequence[int(i)] for i in order[j:j + b]] for j in range(0, len(order), b)]
    sizes = [len(s["xyz"]) for s in pool]
    buckets = {}
    for bt in batches:
        buckets.setdefault(build.bucket(sum(sizes[i] for i in bt)), bt)
    return dict(pool=pool, sequence=sequence, batches=batches, batch=b,
                warm=[buckets[k] for k in sorted(buckets, reverse=True)],
                buckets=sorted(buckets))


def dropped_superpoints(config: dict, p: dict, n: int) -> list:
    """Superpoint ids past the flat ``spp_cap`` in each of the first ``n``
    batches (the trainer's capacity is the whole batch's)."""
    import numpy as np

    per = [len(np.unique(s["spp"])) for s in p["pool"]]
    cap = config["model"]["spp_cap"]
    return [max(0, sum(per[i] for i in bt) - cap) for bt in p["batches"][:n]]


class Program:
    """The port's training object and its feed."""

    def __init__(self, config: dict, mix: dict, p: dict, seed: int, device, spans):
        from gapro_tpu_torch.data.dataset import build_dataloader
        from gapro_tpu_torch.tools import train as trainer
        from gapro_tpu_torch.train.config import AttrDict
        from gapro_tpu_torch.train.state import create_train_state
        from gapro_tpu_torch.train.step import make_spformer_train_step, make_train_step

        cfg = AttrDict.wrap(config)
        self.spans = spans
        self.config, self.seed, self.pool = config, seed, p["pool"]
        self.build_dataloader = build_dataloader
        self.batch = p["batch"]
        self.model, crit = trainer.build_model(cfg, device, seed=0)
        self.initial = weights.draw(weights.leaves(self.model), seed, device,
                                    config.get("assumed", {}).get("bias_shift", {}))
        weights.load(self.model, self.initial)
        self.lr = config["train"]["lr"] * (self.batch / config["train"].get("base_batch_size", 16))
        self.state = create_train_state(self.model, lr=self.lr,
                                        weight_decay=config["train"]["weight_decay"],
                                        fixed_modules=self.model.cfg.fixed_modules)
        self.prepare = trainer.make_prepare(cfg, device)
        self.start, mark = spans.marks()
        make = make_spformer_train_step if config["model"]["type"] == "spformer" else \
            make_train_step
        self.step_fn = make(self.model, crit, on_stage=mark)
        ds = feed.PoolDataset(p["pool"], p["sequence"], config)
        self.loader = build_dataloader(ds, self.batch, training=True, seed=seed, epoch=EPOCH,
                                       num_workers=mix["workers"])
        self.kept = None  # a list: the loader batches of the profiled steps

    def step(self) -> tuple:
        """One trainer step: (losses as floats, whether it counts as done)."""
        with self.spans.span("data_wait"):
            lb = next(self.loader)
        return self.run_batch(lb)

    def run_batch(self, lb) -> tuple:
        """The trainer's step on one loader batch."""
        if self.kept is not None:
            self.kept.append(lb.points)
        with self.spans.span("prepare"):
            prepared = self.prepare(lb.points, lb.batch_size)
        self.start()
        self.state, losses = self.step_fn(self.state, prepared, self.lr)
        vals = {k: float(v) for k, v in losses.items()}
        return vals, _finite_and_counted(vals)

    def checked(self) -> dict:
        """The first ``CHECKED`` steps, with what the reference is held to."""
        out = dict(losses=[], terms=[], ok=True)
        for i in range(CHECKED):
            vals, ok = self.step()
            out["losses"].append(vals["loss"])
            out["terms"].append(vals)
            out["ok"] &= ok
            if i == 0:
                out["grad"] = compare.leaf_norms(compare.first_gradient(self.state))
        with torch.no_grad():
            now = dict(self.model.named_parameters())
            out["change_vec"] = {k: (now[k] - self.initial[k]).cpu() for k in out["grad"]}
            out["change"] = compare.leaf_norms(out["change_vec"])
        self.initial = None
        return out

    def warm(self, groups: list) -> None:
        """One step on each group of pool indices, through the port's
        serial loader, so that every capacity bucket the window reaches has
        run once."""
        for g in groups:
            ds = feed.PoolDataset(self.pool, g, self.config)
            self.run_batch(next(self.build_dataloader(ds, len(g), training=True, seed=self.seed,
                                                      epoch=EPOCH)))

    def close(self) -> None:
        self.loader.close()


def reference_readings(config: dict, p: dict, seed: int, device, tf32: bool = False,
                       half: bool = False) -> dict:
    """The reference's first ``CHECKED`` steps on the same scenes, weights
    and learning rate; ``tf32`` computes its products in TF32 and ``half``
    leaves out half of each batch (controls)."""
    from ..reference import build

    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        model = build.build_model(config, device)
        initial = weights.draw(weights.leaves(model), seed, device,
                               config.get("assumed", {}).get("bias_shift", {}))
        weights.load(model, initial)
        b = p["batch"]
        state = build.train_state(config, model, b)
        step = build.train_step(config, model)
        order = feed.loader_order(len(p["sequence"]), seed, EPOCH)
        out = dict(losses=[], terms=[])
        for i in range(CHECKED):
            scenes = []
            for pos in range(i * b, (i + 1) * b):
                index = int(order[pos])
                scene = dict(p["pool"][p["sequence"][index]])
                scenes.append(build.train_scene(config, scene, feed.augment_seed(seed, EPOCH,
                                                                                 index)))
            if half:
                scenes = scenes[:b // 2]
            prepared = build.prepare(config, build.batch(config, scenes), len(scenes), device)
            state, losses = step(state, prepared, build.lr0(config, b))
            out["losses"].append(float(losses["loss"]))
            out["terms"].append({k: float(v) for k, v in losses.items()})
            if i == 0:
                out["grad"] = compare.leaf_norms(compare.first_gradient(state))
            del prepared, losses
        with torch.no_grad():
            now = dict(model.named_parameters())
            out["change_vec"] = {k: (now[k] - initial[k]).cpu() for k in out["grad"]}
            out["change"] = compare.leaf_norms(out["change_vec"])
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def free() -> None:
    """Release what the dropped program held on the device."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(ctx) -> dict:
    """Set-up, the window and the check; returns the run's readings for
    ``run.py`` to print."""
    config, mix, seed, device, spans = ctx.config, ctx.mix, ctx.seed, ctx.device, ctx.spans
    ctx.note("imports")
    p = plan(config, mix, seed)
    print("superpoint ids past spp_cap in the first batches:",
          dropped_superpoints(config, p, 8), "; capacity buckets:", p["buckets"], flush=True)
    ctx.note("scene pool")
    prog = Program(config, mix, p, seed, device, spans)
    ctx.note("training object")
    got = prog.checked()
    ctx.note(f"{CHECKED} checked steps")
    prog.warm(p["warm"])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ctx.setup_done()
    spans.seconds.clear()

    w = ctx.window(prog.step, prog.batch, prog)
    prog.close()
    ctx.after_window()
    kept = ctx.kept
    if ctx.trace and kept:
        ctx.count_pass(prog.model, [lambda pts=pts: _count_forward(prog, ctx.probes, pts)
                                    for pts in kept],
                       backward=True, dense_passes=3)
    prog = None
    free()
    want = reference_readings(config, p, seed, device)
    numbers = compare.train_numbers(got, want)
    numbers["checked_steps_ok"] = got["ok"]
    return dict(window=w, numbers=numbers, got=got, want=want)


@torch.no_grad()
def _count_forward(prog, probes, points):
    prepared = prog.prepare(points, prog.batch)
    probes.set_unit(points.valid, prepared.batch)
    prog.model.train()
    prog.model(prepared.batch)
