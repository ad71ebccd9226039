"""The multi-device dry run: one data-parallel training step of each model
over ``n`` ranks (the port of ``__graft_entry__.py:dryrun_multichip``).

    python -m gapro_tpu_torch.tools.dryrun_dp --n 4               # on the card
    python -m gapro_tpu_torch.tools.dryrun_dp --n 2 --device cpu --fast

One rank a device, spawned on this host (``parallel/mesh.py:spawn_ranks``),
NCCL where every rank has a card of its own and gloo where ranks share one
or run on the CPU (``choose_backend``). Rank r takes the synthetic scene of
seed r, packed as the train CLI packs it (``pack_point_batch_np``), and
voxelizes and plans it inside the step (``prepare_fn``); the last rank's
reduction weight is 0, a filler that exercises the weighted reduction.
Three stages, each a ``make_dp_train_step`` step from seed-0 weights:

* ISBNet at the tiny widths (``_tiny_cfgs``), lr 1e-3;
* SPFormer at the tiny widths, lr 2e-4, with ``_spformer_loss_fn``;
* unless ``scaled`` is False (the JAX tool's ``GAPRO_DRYRUN_FAST=1``):
  ISBNet at the full backbone width C = 32, 3 levels, 8,192 points a
  shard, every level at full capacity (shrink 1.0), lr 1e-3.

It raises where a loss is not finite, where the ranks' weights, statistics
and optimizer states differ after a step, or where a stage counts an
overflow: an ``ovf_*`` above 0 on any rank, the filler's included, or in
the reduced losses (the JAX tool asserts the reduced counters of the scaled
stage alone). Prints one ``ok`` line a stage, as the JAX tool.
"""

from __future__ import annotations

import argparse
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..data import make_synthetic_scene, remap_semantic_for_training
from ..cuda_build import launch_counts
from ..device import resolve_device
from ..losses.criterion import CriterionConfig
from ..losses.spformer_criterion import SPFormerCriterionConfig
from ..models.isbnet import ISBNet, ISBNetConfig
from ..models.prepare import (pack_point_batch_np, packed_prepare, points_to_batch_np,
                              prepare_voxel_batch, upload_point_batch)
from ..models.spformer import SPFormer, SPFormerConfig
from ..parallel.mesh import data_parallel_mesh, replicate, spawn_ranks
from ..train.state import create_train_state
from ..train.step import _loss_fn, _spformer_loss_fn, make_dp_train_step

TINY_N_CAP = 2048
SCALED_N_CAP = 8192


def _tiny_cfgs():
    """The tiny ISBNet's and its criterion's configurations."""
    model_cfg = ISBNetConfig(
        channels=8, num_blocks=3, n_sample_pa1=64, n_queries=16, neighbor=8, dec_dim=32,
        mask_dim_out=8, spp_cap=256,
        # untrained semantics are uniform (below the real 0.1 threshold);
        # keep everything foreground so the query path carries gradients
        filter_bg_thresh=0.0)
    return model_cfg, CriterionConfig(inst_cap=16)


def _tiny_point_batch(seed: int = 0):
    """One tiny synthetic scene as a host ``PointBatch`` of capacity 2048."""
    s = make_synthetic_scene(seed=seed, n_objects=3, points_per_object=200, n_floor=300,
                             n_wall=200)
    return points_to_batch_np(
        [dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
              semantic=remap_semantic_for_training(s.semantic_label),
              instance=s.instance_label)],
        voxel_scale=10, n_cap=TINY_N_CAP)


def _tiny_prepared(seed: int = 0, device="cpu"):
    """One tiny synthetic scene -> ``PreparedBatch`` (fixed capacities)."""
    return prepare_voxel_batch(upload_point_batch(_tiny_point_batch(seed), device), TINY_N_CAP,
                               1, 3, 256, 0.7)


def _spformer_cfgs():
    """The tiny SPFormer's and its criterion's configurations."""
    return (SPFormerConfig(media=8, blocks=3, num_layer=2, num_query=16, d_model=32, nhead=4,
                           hidden_dim=64, spp_cap=256),
            SPFormerCriterionConfig(inst_cap=16))


def _scaled_cfgs():
    """The scaled stage's configurations: the full backbone width C = 32
    (the part whose capacities matter); the heads stay small."""
    return (ISBNetConfig(channels=32, num_blocks=3, n_sample_pa1=64, n_queries=16, neighbor=8,
                         dec_dim=32, mask_dim_out=8, spp_cap=512, filter_bg_thresh=0.0),
            CriterionConfig(inst_cap=32))


def _scaled_point_batch(seed: int):
    """One scaled-stage scene: 8 objects, about 8,000 points, capacity 8192."""
    s = make_synthetic_scene(seed=seed, n_objects=8, points_per_object=600, n_floor=2000,
                             n_wall=1200)
    return points_to_batch_np(
        [dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
              semantic=remap_semantic_for_training(s.semantic_label),
              instance=s.instance_label)], voxel_scale=25, n_cap=SCALED_N_CAP)


@dataclass(frozen=True)
class Stage:
    """One stage of the dry run: a model, its criterion and loss, the step's
    learning rate, each shard's scene and the in-step prepare's plan."""

    name: str
    model_cfg: object
    crit_cfg: object
    lr: float
    point_batch: Callable
    spp_cap: int
    shrink: float

    @property
    def spformer(self) -> bool:
        return isinstance(self.model_cfg, SPFormerConfig)

    @property
    def loss_fn(self) -> Callable:
        return _spformer_loss_fn if self.spformer else _loss_fn

    def build(self, device):
        """The model, its weights from seed 0."""
        return (SPFormer if self.spformer else ISBNet)(self.model_cfg, seed=0, device=device)

    def shard(self, rank: int) -> np.ndarray:
        """Rank ``rank``'s packed [N, 17] buffer: the scene of seed ``rank``."""
        return pack_point_batch_np(self.point_batch(rank))

    def prepare_fn(self) -> Callable:
        return packed_prepare(self.model_cfg.unet_levels, self.spp_cap, self.shrink)


def stages(scaled: bool = True) -> list:
    """The dry run's stages, in order."""
    isb, isb_crit = _tiny_cfgs()
    spf, spf_crit = _spformer_cfgs()
    out = [Stage("ISBNet", isb, isb_crit, 1e-3, _tiny_point_batch, 256, 0.7),
           Stage("SPFormer", spf, spf_crit, 2e-4, _tiny_point_batch, 256, 0.7)]
    if scaled:
        # shrink 1.0: full capacity at every level (the 0.7 schedule
        # overflows the coarse levels at this density, which is what the
        # stage asserts on)
        cfg, crit = _scaled_cfgs()
        out.append(Stage("scaled C=32", cfg, crit, 1e-3, _scaled_point_batch, 512, 1.0))
    return out


def shard_weight(rank: int, n: int) -> float:
    """The reduction weight of rank ``rank`` of ``n``: 0 for the last, a filler."""
    return 0.0 if rank == n - 1 else 1.0


def _rank(rank, init_method, results, n, device_type, threads, scaled, save_dir) -> None:
    """One rank of ``dryrun_multichip``: each stage's step on this rank's
    shard. Puts, for each stage, its reduced losses, this rank's own
    losses, its assignment, its state's digest, the step's host ms and the
    kernels' launches in it; rank 0 saves the reduced gradients, BatchNorm
    statistics and losses under ``save_dir`` where it is given."""
    import torch.distributed as dist

    from .train import state_digest

    if device_type == "cpu":
        torch.set_num_threads(threads)
    group = data_parallel_mesh(n, rank, init_method, device_type)
    try:
        out = []
        for stage in stages(scaled):
            model = stage.build(group.device)
            replicate(model, group)
            st = create_train_state(model, lr=stage.lr)
            own = {}

            def loss_fn(m, prepared, crit, mark, stage=stage, own=own):
                res = stage.loss_fn(m, prepared, crit, mark=mark)
                own["losses"] = {k: float(v.detach()) for k, v in res[1][0].items()}
                own["assign"] = res[1][1]["assign"].cpu().numpy()
                return res

            step = make_dp_train_step(model, stage.crit_cfg, group, loss_fn=loss_fn,
                                      prepare_fn=stage.prepare_fn())
            buf = torch.from_numpy(stage.shard(rank)).to(group.device)
            before = launch_counts()
            if group.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, losses = step(st, buf, stage.lr, shard_weight(rank, n))
            if group.device.type == "cuda":
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v - before[k] for k, v in launch_counts().items()}
            reduced = {k: float(v) for k, v in losses.items()}
            if save_dir and rank == 0:
                grads = {k: None if p.grad is None else p.grad.detach().cpu()
                         for k, p in model.named_parameters()}
                stats = {k: b.detach().cpu() for k, b in model.named_buffers()}
                torch.save(dict(losses=reduced, grads=grads, stats=stats),
                           os.path.join(save_dir, f"{stage.name}.pt"))
            # numpy and floats, not tensors: a queue shares a tensor's
            # memory with a process that may have exited before it is read
            out.append(dict(stage=stage.name, losses=reduced, own=own["losses"],
                            assign=own["assign"], digest=state_digest(st), ms=ms,
                            launches=launches))
        results.put((rank, dict(backend=group.backend, device=str(group.device), stages=out)))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, scaled: bool = True,
                     save_dir: Optional[str] = None, timeout_s: float = 1800.0) -> dict:
    """One data-parallel step of each of ``stages(scaled)`` over
    ``n_devices`` ranks, on ``device`` (``cuda`` unless named; the kernels
    are built here first, so the ranks only load them). Prints a line a
    stage and raises on a loss not finite, ranks that differ after a step,
    or an overflow counted on any rank. Returns, by stage name, the reduced
    losses and every rank's report (``_rank``), and the group's backend."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        from .. import cuda_build

        cuda_build.build_all()
    threads = max(1, torch.get_num_threads() // n_devices)  # CPU ranks share these threads
    ranks = spawn_ranks(_rank, n_devices, n_devices, dev.type, threads, scaled, save_dir,
                        timeout_s=timeout_s)
    out = dict(backend=ranks[0]["backend"], devices=[ranks[r]["device"] for r in ranks])
    for i, stage in enumerate(stages(scaled)):
        reports = [ranks[r]["stages"][i] for r in range(n_devices)]
        losses = reports[0]["losses"]
        loss = losses["loss"]
        if not math.isfinite(loss):
            raise RuntimeError(f"dryrun_multichip({n_devices}) {stage.name}: the loss is not "
                               f"finite: {loss}")
        if len({r["digest"] for r in reports}) != 1:
            raise RuntimeError(f"dryrun_multichip({n_devices}) {stage.name}: the ranks' weights, "
                               f"statistics or optimizer states differ after the step")
        ovf = {k: v for k, v in losses.items() if k.startswith("ovf")}
        over = {(r, k): v for r, rep in enumerate(reports) for k, v in rep["own"].items()
                if k.startswith("ovf") and v > 0}
        if any(v != 0.0 for v in ovf.values()) or over:
            raise RuntimeError(f"dryrun_multichip({n_devices}) {stage.name}: capacity overflow: "
                               f"reduced {ovf}, by (rank, counter) {over}")
        line = f"dryrun_multichip({n_devices}) {stage.name} ok: loss={loss:.4f}"
        if stage.name.startswith("scaled"):
            line += f" ovf all zero {sorted(ovf)}"
        print(line, flush=True)
        out[stage.name] = dict(losses=losses, ranks=reports)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("gapro_tpu_torch dryrun_dp")
    ap.add_argument("--n", type=int, default=4, help="ranks, one a device")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--fast", action="store_true",
                    help="leave out the scaled C=32 stage")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, scaled=not args.fast)


if __name__ == "__main__":
    main()
