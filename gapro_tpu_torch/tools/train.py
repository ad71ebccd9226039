"""Train ISBNet on one device: the port of ``tools/train.py``.

    python -m gapro_tpu_torch.tools.train configs/isbnet_scannetv2.yaml --work_dir runs/isbnet
    python -m gapro_tpu_torch.tools.train configs/tiny_synthetic.yaml --synthetic 2 \\
        --epochs 2 --device cpu

``train(cfg, work_dir, ...)`` is the loop, for callers that build the
config in code (``train/config.py:AttrDict``) and may hand in their own
datasets: per epoch the learning rate (cosine after ``step_epoch``, or
poly), the training batches through ``make_train_step``, per-loss means
into ``metrics.jsonl``, validation by AP on epochs that are a power of two
or a multiple of ``save_freq``, and a checkpoint (``latest``, ``best``,
``epoch_<e>``). ``--dp``, ``--only_backbone``, ``semantic_only`` configs
and SPFormer are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import os.path as osp
import time
from typing import Callable, Optional

import torch

from ..data.dataset import ScanNetDataset, SyntheticDataset, VoxelCfg, build_dataloader
from ..device import resolve_device
from ..eval.runner import validate
from ..losses.criterion import CriterionConfig
from ..models.isbnet import ISBNet, ISBNetConfig
from ..models.prepare import prepare_voxel_batch, upload_point_batch
from ..train.checkpoint import (is_keep_epoch, load_checkpoint, load_model_weights,
                                merge_state_dict, save_checkpoint)
from ..train.config import load_config
from ..train.state import cosine_lr_after_step, create_train_state, poly_lr
from ..train.step import make_train_step


def _isbnet_config(cfg) -> dict:
    if cfg.model.type != "isbnet":
        raise NotImplementedError(f"model type {cfg.model.type!r}: only ISBNet is ported")
    mk = {k: v for k, v in cfg.model.items() if k not in ("type", "semantic_only")}
    if cfg.model.get("semantic_only", False):
        raise NotImplementedError("semantic_only (backbone pre-training) is not ported yet")
    mk["fixed_modules"] = tuple(mk.get("fixed_modules") or ())
    return mk


def build_model(cfg, device=None, seed: int = 0):
    """The config's ISBNet with weights drawn from ``seed`` on ``device``,
    and its criterion's config."""
    crit = CriterionConfig(**dict(cfg.get("criterion", {})))
    return ISBNet(ISBNetConfig(**_isbnet_config(cfg)), seed=seed, device=device), crit


def voxel_cfg(cfg) -> VoxelCfg:
    v = cfg.data.voxel
    return VoxelCfg(scale=v.scale, spatial_shape=tuple(v.spatial_shape),
                    max_npoint=v.max_npoint, min_npoint=v.min_npoint)


def build_dataset(cfg, synthetic: int = 0, training: bool = True):
    """``synthetic`` fabricated rooms, or the config's ScanNet split."""
    vc = voxel_cfg(cfg)
    if synthetic:
        return SyntheticDataset(n_scenes=synthetic, training=training, voxel_cfg=vc,
                                repeat=cfg.data.get("repeat", 1))
    if cfg.data.type != "scannetv2":
        raise NotImplementedError(f"dataset type {cfg.data.type!r}: only ScanNet is ported")
    prefix = cfg.data.prefix_train if training else cfg.data.prefix_val
    return ScanNetDataset(cfg.data.data_root, prefix=prefix, training=training,
                          label_type=cfg.data.get("label_type") if training else None,
                          repeat=cfg.data.get("repeat", 1) if training else 1, voxel_cfg=vc)


def read_plan_shrink(data_cfg):
    """plan_shrink: one factor or a per-level list (sparse/plan.py)."""
    v = data_cfg.get("plan_shrink", 0.5)
    return tuple(float(s) for s in v) if isinstance(v, (list, tuple)) else float(v)


def make_prepare(cfg, device) -> Callable:
    """``prepare(point_batch, batch_size)`` on ``device`` with the config's
    flat superpoint capacity and plan shrink; the voxel capacity is the
    batch's point capacity."""
    num_levels = cfg.model.get("num_blocks", 7)
    spp_cap = cfg.model.spp_cap
    shrink = read_plan_shrink(cfg.data)

    def prepare(points, batch_size):
        pb = upload_point_batch(points, device)
        return prepare_voxel_batch(pb, pb.coords.shape[0], batch_size, num_levels, spp_cap,
                                   shrink)

    return prepare


def restore(path: str, state) -> int:
    """Resume ``state`` from a checkpoint: the model's weights and
    BatchNorm statistics, the optimizer's state and the step. Returns the
    epoch the checkpoint closed."""
    ck = load_checkpoint(path)
    sd = state.model.state_dict()
    merged = merge_state_dict(sd, ck["model"])
    state.model.load_state_dict({k: v.to(sd[k].device) for k, v in merged.items()})
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    return int(ck.get("epoch", 0))


def _no_mark(name: str) -> None:
    pass


def train(cfg, work_dir: str, *, device=None, seed: int = 0, resume: Optional[str] = None,
          pretrain: Optional[str] = None, synthetic: int = 0, skip_validate: bool = False,
          val_scenes: Optional[int] = None, num_workers: Optional[int] = None, profile: int = 0,
          dataset=None, val_dataset=None, on_stage: Optional[Callable[[str], None]] = None,
          on_step: Optional[Callable[[dict], None]] = None) -> dict:
    """Train ``cfg``'s ISBNet on one device (``cuda`` unless named).

    ``dataset`` / ``val_dataset`` replace the config's. ``on_stage(name)``
    is called as each stage of a step ends: ``loaded`` (the batch came from
    the loader), ``prepare``, then the stages of ``make_train_step``;
    ``on_step(losses)`` gets each step's losses as floats. Returns the
    model, the train state, the best validation metric and the per-epoch
    records."""
    log = logging.getLogger("train")
    dev = resolve_device(device)
    model, crit = build_model(cfg, dev, seed)
    fixed_modules = model.cfg.fixed_modules
    if dataset is None:
        dataset = build_dataset(cfg, synthetic, training=True)
    prepare = make_prepare(cfg, dev)
    if pretrain or cfg.train.get("pretrain"):
        load_model_weights(pretrain or cfg.train.pretrain, model)
        log.info("loaded pretrain %s", pretrain or cfg.train.pretrain)

    # linear LR scaling: the base LR is set for a world batch of
    # base_batch_size (16 by default)
    batch_size = cfg.train.batch_size
    lr0 = cfg.train.lr * (batch_size / cfg.train.get("base_batch_size", 16))
    if fixed_modules:
        log.info("frozen modules: %s", list(fixed_modules))
    state = create_train_state(model, lr=lr0, weight_decay=cfg.train.weight_decay,
                               fixed_modules=fixed_modules)
    start_epoch = 1
    if resume:
        start_epoch = restore(resume, state) + 1
        log.info("resumed from %s at epoch %d", resume, start_epoch)
    mark = on_stage or _no_mark
    step_fn = make_train_step(model, crit, on_stage=on_stage)

    epochs = cfg.train.epochs
    schedule = cfg.train.get("schedule", "cosine")

    def lr_at(epoch):
        if schedule == "poly":
            return poly_lr(lr0, epoch - 1, epochs, power=cfg.train.get("poly_power", 0.9))
        return cosine_lr_after_step(lr0, epoch - 1, cfg.train.step_epoch, epochs)

    if not skip_validate and val_dataset is None:
        val_dataset = build_dataset(cfg, synthetic, training=False)
    if val_dataset is not None and len(val_dataset) == 0:
        log.warning("no validation scenes; skipping in-training validation")
        val_dataset = None
    if skip_validate:
        val_dataset = None

    save_freq = cfg.train.get("save_freq", 16)
    if num_workers is None:
        num_workers = cfg.train.get("num_workers", 0)
    best_metric, records = -1.0, []
    os.makedirs(work_dir, exist_ok=True)
    with open(osp.join(work_dir, "metrics.jsonl"), "a") as metrics_f, \
            contextlib.ExitStack() as prof_stack:
        for epoch in range(start_epoch, epochs + 1):
            lr = lr_at(epoch)
            t0 = time.time()
            n_iter, meters = 0, {}
            prof = None
            if profile and epoch == start_epoch:
                prof = prof_stack.enter_context(_profiler(dev))
            for lb in build_dataloader(dataset, batch_size, training=True, seed=seed, epoch=epoch,
                                       num_workers=num_workers):
                mark("loaded")
                prepared = prepare(lb.points, lb.batch_size)
                mark("prepare")
                state, losses = step_fn(state, prepared, lr)
                vals = {k: float(v) for k, v in losses.items()}
                for k, v in vals.items():
                    meters[k] = meters.get(k, 0.0) + v
                n_iter += 1
                if on_step is not None:
                    on_step(vals)
                if prof is not None and n_iter == profile:
                    prof = _finish_profile(prof, prof_stack, work_dir, dev, log)
            if prof is not None:  # the epoch had fewer than ``profile`` steps
                prof = _finish_profile(prof, prof_stack, work_dir, dev, log)
            dt = time.time() - t0
            means = {k: v / max(n_iter, 1) for k, v in meters.items()}
            log.info("epoch %d/%d loss %.4f lr %.2e (%.1fs, %d iters) | %s", epoch, epochs,
                     means.get("loss", 0.0), lr, dt, n_iter,
                     " ".join(f"{k} {v:.4f}" for k, v in sorted(means.items()) if k != "loss"))
            record = dict(epoch=epoch, lr=lr, seconds=dt, **means)

            is_best = False
            if val_dataset is not None and is_keep_epoch(epoch, save_freq):
                metric, detail = validate(model, "isbnet", val_dataset, cfg, log,
                                          lambda lb: prepare(lb.points, 1), max_scenes=val_scenes)
                record.update(detail)
                if metric > best_metric:
                    best_metric = metric
                    is_best = True
                    log.info("new best metric %.4f at epoch %d", metric, epoch)
            records.append(record)
            metrics_f.write(json.dumps(record) + "\n")
            metrics_f.flush()
            save_checkpoint(work_dir, dict(model=model.state_dict(),
                                           optimizer=state.optimizer.state_dict(),
                                           step=state.step, epoch=epoch),
                            epoch, save_freq=save_freq, best=is_best)
    log.info("done: %s (best metric %.4f)", work_dir, best_metric)
    return dict(model=model, state=state, best_metric=best_metric, records=records)


def _finish_profile(prof, prof_stack, work_dir, dev, log) -> None:
    """Stop the profiler and write its trace; returns None for ``prof``."""
    prof_stack.close()
    trace = osp.join(work_dir, "trace", "trace.json")
    os.makedirs(osp.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    if dev.type == "cuda":
        log.info("device memory peak: %.0f MiB", torch.cuda.max_memory_allocated(dev) / 2**20)
    return None


def _profiler(dev):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    return profile(activities=acts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("gapro_tpu_torch train")
    ap.add_argument("config")
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--pretrain", default=None,
                    help="backbone-pretrain checkpoint (overrides cfg.train.pretrain)")
    ap.add_argument("--only_backbone", action="store_true")
    ap.add_argument("--trainall", action="store_true")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--dp", type=int, default=0, help="data-parallel device count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip_validate", action="store_true")
    ap.add_argument("--val_scenes", type=int, default=None,
                    help="cap validation to N scenes")
    ap.add_argument("--num_workers", type=int, default=None,
                    help="data worker processes (default: the config's, or 0)")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="trace the first N steps with torch.profiler into "
                         "<work_dir>/trace/trace.json")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dp > 1:
        raise NotImplementedError("--dp: data-parallel training is not ported yet")
    if args.only_backbone:
        raise NotImplementedError("--only_backbone: semantic_only training is not ported yet")

    cfg = load_config(args.config)
    if args.trainall:
        cfg.model["semantic_only"] = False
        cfg.model["fixed_modules"] = []
        if "trainall" in cfg.get("criterion", {}):
            cfg.criterion["trainall"] = True
    if args.epochs:
        cfg.train["epochs"] = args.epochs
    if args.batch_size:
        cfg.train["batch_size"] = args.batch_size
    work_dir = args.work_dir or osp.join("runs", osp.splitext(osp.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s",
                        handlers=[logging.StreamHandler(),
                                  logging.FileHandler(osp.join(work_dir, "train.log"))])
    logging.getLogger("train").info("device: %s", args.device)
    train(cfg, work_dir, device=args.device, seed=args.seed, resume=args.resume,
          pretrain=args.pretrain, synthetic=args.synthetic, skip_validate=args.skip_validate,
          val_scenes=args.val_scenes, num_workers=args.num_workers, profile=args.profile)


if __name__ == "__main__":
    main()
