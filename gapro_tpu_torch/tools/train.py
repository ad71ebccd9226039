"""Train ISBNet or SPFormer on one device: the port of ``tools/train.py``.

    python -m gapro_tpu_torch.tools.train configs/isbnet_backbone_scannetv2.yaml \\
        --work_dir runs/backbone
    python -m gapro_tpu_torch.tools.train configs/isbnet_scannetv2.yaml --work_dir runs/isbnet \\
        --pretrain runs/backbone/best
    python -m gapro_tpu_torch.tools.train configs/spformer_scannetv2.yaml --work_dir runs/spf
    python -m gapro_tpu_torch.tools.train configs/isbnet_s3dis.yaml --work_dir runs/s3dis
    python -m gapro_tpu_torch.tools.train configs/tiny_synthetic.yaml --synthetic 2 \\
        --epochs 2 --device cpu

``train(cfg, work_dir, ...)`` is the loop, for callers that build the
config in code (``train/config.py:AttrDict``) and may hand in their own
datasets: per epoch the learning rate (cosine after ``step_epoch``, or
poly, SPFormer's default), the training batches through the model's step,
per-loss means into ``metrics.jsonl``, validation on epochs that are a
power of two or a multiple of ``save_freq`` (AP, or for a
``semantic_only`` model the point-wise mIoU), and a checkpoint
(``latest``, ``best`` by the validation metric, ``epoch_<e>``).
``--only_backbone`` trains ISBNet's backbone stage (``semantic_only``);
its checkpoint starts the full stage through ``--pretrain``. The data is
ScanNet or S3DIS (``data.type``: ``configs/isbnet_s3dis.yaml``).

``--dp N`` (``train_dp``) trains data-parallel in N ranks spawned on this
host, one scene a rank a step (``train/step.py:make_dp_train_step``), on
``cuda:{rank % device_count}``: NCCL where each rank has a card of its own,
gloo where ranks share one (``parallel/mesh.py``). As in the JAX CLI the
loader's batch becomes N, the learning rate is scaled by N over
``base_batch_size``, scene ``d % len(batch)`` fills a short batch with
weight 0, and each step's buffer capacity is ``next_bucket`` of its
largest scene. Each rank loads only its own scene of the world batch
(``data/dataset.py:build_rank_loader``, with its own spawned data
workers). Rank 0 validates, writes the metrics and the checkpoints; a
resume restores every rank.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import logging
import os
import os.path as osp
import time
from typing import Callable, Optional

import torch

from ..core.bucketing import next_bucket
from ..data.dataset import (S3DISDataset, ScanNetDataset, SyntheticDataset, VoxelCfg,
                            build_dataloader, build_rank_loader)
from ..device import resolve_device
from ..eval.runner import validate
from ..losses.criterion import CriterionConfig
from ..models.isbnet import ISBNet, ISBNetConfig
from ..models.prepare import (pack_point_batch_np, packed_prepare, points_to_batch_np,
                              prepare_voxel_batch, upload_point_batch)
from ..parallel.mesh import data_parallel_mesh, replicate, spawn_ranks
from ..train.checkpoint import (is_keep_epoch, load_checkpoint, load_model_weights,
                                merge_state_dict, save_checkpoint)
from ..train.config import load_config
from ..train.state import cosine_lr_after_step, create_train_state, poly_lr
from ..train.step import (_loss_fn, _spformer_loss_fn, make_dp_train_step,
                          make_spformer_train_step, make_train_step)
from ..utils import profiling


def _model_kwargs(cfg) -> dict:
    """The config's model section as the model config's keyword arguments."""
    mk = {k: v for k, v in cfg.model.items() if k != "type"}
    mk["fixed_modules"] = tuple(mk.get("fixed_modules") or ())
    return mk


def model_config(cfg):
    """The config's ``ISBNetConfig`` or ``SPFormerConfig``."""
    mk = _model_kwargs(cfg)
    if cfg.model.type == "isbnet":
        return ISBNetConfig(**mk)
    if cfg.model.type == "spformer":
        from ..models.spformer import SPFormerConfig

        return SPFormerConfig(**mk)
    raise ValueError(f"model type {cfg.model.type!r}")


def criterion_config(cfg):
    """The criterion's config of the config's model: ISBNet's
    ``CriterionConfig`` or SPFormer's ``SPFormerCriterionConfig``."""
    ck = dict(cfg.get("criterion", {}))
    if cfg.model.type != "spformer":
        return CriterionConfig(**ck)
    from ..losses.spformer_criterion import SPFormerCriterionConfig

    for key in ("loss_weight", "cost_weight"):
        if key in ck:
            ck[key] = tuple(ck[key])
    return SPFormerCriterionConfig(**ck)


def build_model(cfg, device=None, seed: int = 0):
    """The config's ISBNet or SPFormer with weights drawn from ``seed`` on
    ``device``, and its criterion's config."""
    mcfg = model_config(cfg)
    if isinstance(mcfg, ISBNetConfig):
        return ISBNet(mcfg, seed=seed, device=device), criterion_config(cfg)
    from ..models.spformer import SPFormer

    return SPFormer(mcfg, seed=seed, device=device), criterion_config(cfg)


def voxel_cfg(cfg) -> VoxelCfg:
    v = cfg.data.voxel
    return VoxelCfg(scale=v.scale, spatial_shape=tuple(v.spatial_shape),
                    max_npoint=v.max_npoint, min_npoint=v.min_npoint)


def build_dataset(cfg, synthetic: int = 0, training: bool = True):
    """``synthetic`` fabricated rooms, or the config's ScanNet or S3DIS
    split."""
    vc = voxel_cfg(cfg)
    if synthetic:
        return SyntheticDataset(n_scenes=synthetic, training=training, voxel_cfg=vc,
                                repeat=cfg.data.get("repeat", 1))
    cls = S3DISDataset if cfg.data.type == "s3dis" else ScanNetDataset
    prefix = cfg.data.prefix_train if training else cfg.data.prefix_val
    return cls(cfg.data.data_root, prefix=prefix, training=training,
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
    num_levels = model_config(cfg).unet_levels
    spp_cap = cfg.model.spp_cap
    shrink = read_plan_shrink(cfg.data)

    def prepare(points, batch_size):
        pb = upload_point_batch(points, device)
        return prepare_voxel_batch(pb, pb.coords.shape[0], batch_size, num_levels, spp_cap,
                                   shrink)

    return prepare


def rank_exchange(group) -> Callable[[int], list]:
    """``build_rank_loader``'s all-gather of one integer a rank over
    ``group``: a sum of one-hot vectors on the group's device."""
    def exchange(n: int) -> list:
        t = torch.zeros(group.world_size, dtype=torch.int64, device=group.device)
        t[group.rank] = n
        return group.all_reduce_sum(t).tolist()

    return exchange


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
          on_step: Optional[Callable[[dict], None]] = None, group=None) -> dict:
    """Train ``cfg``'s model on one device (``cuda`` unless named), or as
    one rank of the data-parallel ``group`` (``parallel/mesh.py``, on the
    group's device; ``train_dp`` starts the ranks).

    ``dataset`` / ``val_dataset`` replace the config's. ``on_stage(name)``
    is called as each stage of a step ends: ``loaded`` (the batch came from
    the loader), ``prepare``, then the stages of ``make_train_step`` (of
    ``make_dp_train_step`` in a group); ``on_step(losses)`` gets each
    step's losses as floats. Returns the model, the train state, the best
    validation metric, the per-epoch records and each step's seconds on the
    host clock (from the loader's batch to the losses read as floats).
    ``profile`` N traces the first epoch's first N steps with the port's
    tracing on (``utils/profiling.py``) and logs what it recorded a step
    (``_finish_profile``)."""
    log = logging.getLogger("train")
    dev = group.device if group is not None else resolve_device(device)
    lead = group is None or group.rank == 0  # validates, logs and writes the checkpoints
    model, crit = build_model(cfg, dev, seed)
    if group is not None:
        replicate(model, group)
    fixed_modules = model.cfg.fixed_modules
    if dataset is None:
        dataset = build_dataset(cfg, synthetic, training=True)
    prepare = make_prepare(cfg, dev)
    if pretrain or cfg.train.get("pretrain"):
        load_model_weights(pretrain or cfg.train.pretrain, model)
        log.info("loaded pretrain %s", pretrain or cfg.train.pretrain)

    # linear LR scaling: the base LR is set for a world batch of
    # base_batch_size (16 by default); in a group the world batch is one
    # scene a rank
    batch_size = cfg.train.batch_size
    if group is not None:
        if batch_size != group.world_size:
            log.info("dp mode: loader batch %d -> %d (one scene a rank)", batch_size,
                     group.world_size)
        batch_size = group.world_size
    lr0 = cfg.train.lr * (batch_size / cfg.train.get("base_batch_size", 16))
    if lr0 != cfg.train.lr:
        log.info("scale LR %.2e -> %.2e (world batch %d)", cfg.train.lr, lr0, batch_size)
    if fixed_modules:
        log.info("frozen modules: %s", list(fixed_modules))
    state = create_train_state(model, lr=lr0, weight_decay=cfg.train.weight_decay,
                               fixed_modules=fixed_modules)
    start_epoch = 1
    if resume:
        start_epoch = restore(resume, state) + 1
        log.info("resumed from %s at epoch %d", resume, start_epoch)
    mark = on_stage or _no_mark
    spformer = cfg.model.type == "spformer"
    if group is not None:
        step_fn = make_dp_train_step(
            model, crit, group, loss_fn=_spformer_loss_fn if spformer else _loss_fn,
            prepare_fn=packed_prepare(model.cfg.unet_levels, cfg.model.spp_cap,
                                      read_plan_shrink(cfg.data)), on_stage=on_stage)
        log.info("data-parallel over %d ranks (%s)", group.world_size, group.backend)
    else:
        step_fn = (make_spformer_train_step if spformer else make_train_step)(
            model, crit, on_stage=on_stage)

    # ISBNet: cosine after step_epoch; SPFormer: PolyLR, power 0.9
    epochs = cfg.train.epochs
    schedule = cfg.train.get("schedule", "poly" if cfg.model.type == "spformer" else "cosine")

    def lr_at(epoch):
        if schedule == "poly":
            return poly_lr(lr0, epoch - 1, epochs, power=cfg.train.get("poly_power", 0.9))
        return cosine_lr_after_step(lr0, epoch - 1, cfg.train.step_epoch, epochs)

    if not skip_validate and lead and val_dataset is None:
        val_dataset = build_dataset(cfg, synthetic, training=False)
    if val_dataset is not None and len(val_dataset) == 0:
        log.warning("no validation scenes; skipping in-training validation")
        val_dataset = None
    if skip_validate or not lead:
        val_dataset = None

    save_freq = cfg.train.get("save_freq", 16)
    if num_workers is None:
        num_workers = cfg.train.get("num_workers", 0)
    best_metric, records, step_s = -1.0, [], []
    os.makedirs(work_dir, exist_ok=True)
    with (open(osp.join(work_dir, "metrics.jsonl"), "a") if lead
          else contextlib.nullcontext()) as metrics_f, contextlib.ExitStack() as prof_stack:
        for epoch in range(start_epoch, epochs + 1):
            lr = lr_at(epoch)
            t0 = time.time()
            n_iter, meters = 0, {}
            prof = None
            if profile and lead and epoch == start_epoch:
                # the port's spans and counters, the loader's workers' too
                profiling.enable(True)
                prof = prof_stack.enter_context(profiling.trace(osp.join(work_dir, "trace"),
                                                                cuda=dev.type == "cuda"))
            if group is not None:
                # each rank loads its own scene of the world batch
                loader = build_rank_loader(dataset, group.world_size, group.rank,
                                           rank_exchange(group), seed=seed, epoch=epoch,
                                           num_workers=num_workers)
            else:
                loader = build_dataloader(dataset, batch_size, training=True, seed=seed,
                                          epoch=epoch, num_workers=num_workers)
            for lb in profiling.units(loader, start=state.step):
                t_step = time.perf_counter()
                mark("loaded")
                if group is not None:
                    # one scene, packed at the capacity of the world batch's largest
                    scene, n_max, weight = lb
                    buf = pack_point_batch_np(points_to_batch_np(
                        [scene], voxel_scale=dataset.voxel_cfg.scale, n_cap=next_bucket(n_max)))
                    with profiling.span("prepare.upload"):
                        profiling.count("h2d_bytes", buf.nbytes)
                        shard = torch.from_numpy(buf).to(dev)
                    state, losses = step_fn(state, shard, lr, weight)
                else:
                    prepared = prepare(lb.points, lb.batch_size)
                    mark("prepare")
                    state, losses = step_fn(state, prepared, lr)
                vals = {k: float(profiling.to_host(v, "train.losses")) for k, v in losses.items()}
                step_s.append(time.perf_counter() - t_step)
                for k, v in vals.items():
                    meters[k] = meters.get(k, 0.0) + v
                n_iter += 1
                if on_step is not None:
                    on_step(vals)
                if prof is not None and n_iter == profile:
                    prof = _finish_profile(prof_stack, prof, dev, log, n_iter)
            if prof is not None:  # the epoch had fewer than ``profile`` steps
                prof = _finish_profile(prof_stack, prof, dev, log, n_iter)
            dt = time.time() - t0
            means = {k: v / max(n_iter, 1) for k, v in meters.items()}
            log.info("epoch %d/%d loss %.4f lr %.2e (%.1fs, %d iters) | %s", epoch, epochs,
                     means.get("loss", 0.0), lr, dt, n_iter,
                     " ".join(f"{k} {v:.4f}" for k, v in sorted(means.items()) if k != "loss"))
            record = dict(epoch=epoch, lr=lr, seconds=dt, **means)

            is_best = False
            if val_dataset is not None and is_keep_epoch(epoch, save_freq):
                metric, detail = validate(model, cfg.model.type, val_dataset, cfg, log,
                                          lambda lb: prepare(lb.points, 1), max_scenes=val_scenes)
                record.update(detail)
                if metric > best_metric:
                    best_metric = metric
                    is_best = True
                    log.info("new best metric %.4f at epoch %d", metric, epoch)
            records.append(record)
            if lead:
                metrics_f.write(json.dumps(record) + "\n")
                metrics_f.flush()
                save_checkpoint(work_dir, dict(model=model.state_dict(),
                                               optimizer=state.optimizer.state_dict(),
                                               step=state.step, epoch=epoch),
                                epoch, save_freq=save_freq, best=is_best)
    if group is not None:
        group.barrier()  # the checkpoint is written before any rank returns
    log.info("done: %s (best metric %.4f)", work_dir, best_metric)
    return dict(model=model, state=state, best_metric=best_metric, records=records,
                step_s=step_s)


def _finish_profile(prof_stack, prof, dev, log, steps: int) -> None:
    """Stop the profiler (its trace goes to ``<work_dir>/trace/trace.json``,
    the loader workers' spans in it), turn tracing off, log what the port
    recorded a profiled step and, on the card, its idle share and the part
    of it outside every port span, and log the card's memory, as the JAX
    trainer does; returns None for ``prof``."""
    prof_stack.close()
    profiling.enable(False)
    _log_port_record(log, profiling.per_unit(profiling.drain(), steps))
    if dev.type == "cuda":
        idle = profiling.idle_attribution(prof.events())
        log.info("device idle %.1f%% of the profiled %.3f s, %.1f%% of it in no port span",
                 100 * idle["idle_s"] / max(idle["stretch_s"], 1e-9), idle["stretch_s"],
                 100 * idle["unattributed_s"] / max(idle["idle_s"], 1e-9))
    mem = profiling.device_memory_stats(dev)
    if mem:
        log.info("device memory: %.0f MiB in use, %.0f MiB peak", mem["bytes_in_use"] / 2**20,
                 mem["peak_bytes_in_use"] / 2**20)
    return None


def _log_port_record(log, got: dict) -> None:
    """The profiled steps' spans and counters (``profiling.per_unit``), a
    step: the main process's stages, the loader workers' scene, the host's
    reads of the card by site, the bytes each way, and the scenes ready
    when the step asked for them."""
    c = got["counts"]

    def by_site(key, scale=1.0):
        return ", ".join(f"{k[len(key) + 1:]} {v * scale:.4g}" for k, v in c.items()
                         if k.startswith(key + "."))

    log.info("port spans, ms a step over %d profiled: %s", got["units"],
             ", ".join(f"{k} {v:.1f}" for k, v in got["stages_ms"].items()))
    if got["worker_scenes"]:
        log.info("loader workers: %.1f ms a scene over %d scenes", got["worker_scene_ms"],
                 got["worker_scenes"])
    log.info("a step: %.4g host syncs (%s), %.4g MB to the host (%s), %.4g MB to the card, "
             "%.4g of %.4g scenes ready when asked", c.get("host_syncs", 0),
             by_site("host_syncs"), c.get("d2h_bytes", 0) / 1e6, by_site("d2h_bytes", 1e-6),
             c.get("h2d_bytes", 0) / 1e6, c.get("loader.ready", 0), c.get("loader.asked", 0))


def state_digest(state) -> str:
    """sha256 of the model's ``state_dict``, the optimizer's state and the
    step: equal on two ranks, or on a run and its resume, exactly when all
    of it is equal bit for bit."""
    h = hashlib.sha256(str(state.step).encode())
    tensors = list(state.model.state_dict().items())
    for i, s in sorted(state.optimizer.state_dict()["state"].items()):
        tensors += [(f"{i}.{k}", torch.as_tensor(v)) for k, v in sorted(s.items())]
    for name, t in tensors:
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def train_dp(cfg, work_dir: str, dp: int, *, device=None, log_file: Optional[str] = None,
             **kw) -> dict:
    """``train`` data-parallel in ``dp`` ranks spawned on this host
    (``parallel/mesh.py:spawn_ranks``); ``kw`` as ``train``'s, without the
    callbacks (a spawned rank cannot call back into this process). On the
    card the kernels are built here first, so the ranks only load them.
    Returns rank 0's records and best metric, and every rank's summary
    (``ranks``: its device, backend, step seconds, state digest)."""
    if kw.get("on_stage") or kw.get("on_step"):
        raise ValueError("train_dp: a spawned rank cannot call back into this process")
    dev = resolve_device(device)
    if dev.type == "cuda":
        from .. import cuda_build

        cuda_build.build_all()
    # CPU ranks share this process's threads
    threads = max(1, torch.get_num_threads() // dp)
    ranks = spawn_ranks(_dp_rank, dp, dp, dev.type, threads, cfg, work_dir, kw, log_file)
    return dict(records=ranks[0]["records"], best_metric=ranks[0]["best_metric"],
                ranks=[ranks[r] for r in range(dp)])


def _dp_rank(rank, init_method, results, world_size, device_type, threads, cfg, work_dir, kw,
             log_file) -> None:
    """One spawned rank of ``train_dp``: rank 0 logs at INFO (to ``log_file``
    too), the others their warnings."""
    import torch.distributed as dist

    handlers = [logging.StreamHandler()]
    if log_file and rank == 0:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING, handlers=handlers,
                        format=f"%(asctime)s rank {rank} %(levelname)s %(message)s", force=True)
    if device_type == "cpu":
        torch.set_num_threads(threads)
    group = data_parallel_mesh(world_size, rank, init_method, device_type)
    try:
        res = train(cfg, work_dir, group=group, **kw)
        results.put((rank, dict(rank=rank, device=str(group.device), backend=group.backend,
                                records=res["records"],
                                best_metric=res["best_metric"], step_s=res["step_s"],
                                steps=res["state"].step, digest=state_digest(res["state"]))))
    finally:
        dist.destroy_process_group()


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
                         "<work_dir>/trace/trace.json, with the port's spans and the "
                         "loader workers' scenes, and log their stages, host syncs and "
                         "bytes a step")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = load_config(args.config)
    if args.only_backbone:
        # the backbone stage of ISBNet's two-stage recipe; as in the JAX CLI,
        # the criterion's flag is set only where the config has the key
        cfg.model["semantic_only"] = True
        cfg.model["fixed_modules"] = []
        if "semantic_only" in cfg.get("criterion", {}):
            cfg.criterion["semantic_only"] = True
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
    kw = dict(device=args.device, seed=args.seed, resume=args.resume, pretrain=args.pretrain,
              synthetic=args.synthetic, skip_validate=args.skip_validate,
              val_scenes=args.val_scenes, num_workers=args.num_workers, profile=args.profile)
    if args.dp > 1:
        train_dp(cfg, work_dir, args.dp, log_file=osp.join(work_dir, "train.log"), **kw)
    else:
        train(cfg, work_dir, **kw)


if __name__ == "__main__":
    main()
