#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``gapro_tpu_torch/csrc/`` and:

1. kernel phase: runs each kernel against its plain PyTorch version on the
   card at the shapes the full-width ISBNet gives it (K1, the submanifold
   conv, at every level capacity and channel pair; K4, FPS, at N = 262144 ->
   2048 and N = 2048 -> 192 / 128 / 64), and times kernel, plain version and
   bound;
2. backward-kernel phase: at the same 14 conv shapes, the conv's backward
   on the card (dfeats by K1 on the reversed weights, dW by
   ``subm_conv_dw.cu``) against ``torch.autograd.grad`` of the plain conv,
   dW bit-identical across two launches, timed like phase 1;
3. reference phase: the tiny configuration on the card (kernels) against
   the same model on the CPU (plain versions), inference and one training
   step; the CPU test suite holds the CPU run against the JAX package;
4. inference path: full-width ISBNet inference (configs/isbnet_scannetv2.yaml,
   seeded random weights) on three synthetic scenes of about 240k points,
   prepare -> forward_inference -> get_instances, with the kernels' launch
   counts zeroed just before and read just after;
5. plain phase: scene 0 again with the plain versions in place of the
   kernels; outputs agree within the stated tolerance and the instance
   lists are identical;
6. training path: the full-width training step (batch 1, capacity 262144,
   inst_cap 192, AdamW at lr 1e-3, seeded GP labels) on scenes 0, 1 and 2
   after one cold step, through ``make_train_step``, with the counts zeroed
   just before and read just after;
7. plain training comparison: one step's losses, gradients and BatchNorm
   statistics on scene 0, kernels against plain versions, with the kernel
   run's assignment injected;
8. where the time goes: one request with its layer calls timed, and one
   request and (after phase 6) one training step under torch.profiler
   (device time by kernel, the card's busy share of the wall time).

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and fp32 CUDA-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

FULL_SHRINK = (0.67, 0.3, 0.25, 0.25, 0.25, 0.25)
ROUNDS = (192, 128, 64)
N_CAP = 262144
# Float outputs of the kernel path against the plain path: fp32, and the 53
# convs each sum their 27 * Cin products in another order, which compounds
# through the network's depth; 1e-3 of the output's scale.
PATH_RTOL = 1e-3
# One K1 launch against its plain version: 1e-4 of the output's scale.
K1_RTOL = 1e-4
CONF_SHIFT = 1.5
MASK_FILL = -1e4  # mask logit of an invalid superpoint (models/dyco.py)
TRAIN_LR = 1e-3
INST_CAP = 192
TINY_INST_CAP = 16
# One training step, card against CPU (tiny) or kernels against plain
# versions (full width): (losses, gradients, BatchNorm statistics), each of
# its scale. Gradients leaf by leaf, of the leaf's largest |g|, plus
# GRAD_ATOL of the largest |g| of the whole model: a bias right before a
# batch-statistics BatchNorm has an exact gradient of 0 and holds only
# rounding noise. Tiny (3 levels): the CPU tests' tolerances against JAX.
# Full width: the forward's outputs agree within PATH_RTOL, which carries
# into the losses and the statistics, and the backward runs through 53
# convs and 40 BatchNorms more, each summing in another order.
TINY_RTOLS = (1e-4, 1e-3, 1e-5)
PATH_RTOLS = (PATH_RTOL, 1e-2, PATH_RTOL)
GRAD_ATOL = 1e-5
# At full width fp32 rounding alone moves some gradient leaves by more than
# 1e-2 of their scale: a max-pool whose two largest entries lie within
# rounding may pick the other one and send that gradient to another voxel,
# which weighs most at the deep levels' few voxels. A third run, of the
# kernels on input colours one ulp apart, measures that spread. Kernels
# against plain versions must then be no worse than NOISE_FACTOR times it:
# the largest leaf error, in units of the leaf's tolerance, at most
# NOISE_FACTOR times the noise run's largest (and 1 if that is below 1), and
# at most NOISE_FACTOR times as many leaves over their tolerance.
NOISE_FACTOR = 2.0


def dw_rtol(v: int) -> float:
    """dW against its plain version, of the output's scale. Each entry sums
    up to V products; summed in another order, fp32 rounding grows like a
    random walk, about 2^-23 * sqrt(V) of the scale. The bound is 8 times
    that, and never below K1's 1e-4 (4.9e-4 at V = 262144)."""
    return max(K1_RTOL, 8 * 2.0 ** -23 * math.sqrt(v))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel wrappers to their plain versions."""
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.sparse import conv

    names = ((conv, "subm_conv_cuda", conv.subm_conv),
             (conv, "subm_conv_dfeats_cuda", conv.subm_conv),
             (conv, "subm_conv_dw_cuda", conv.subm_conv_dw),
             (fps_ops, "fps_cuda", fps_ops.fps_masked))
    saved = [getattr(mod, name) for mod, name, _ in names]
    for mod, name, plain in names:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), f in zip(names, saved):
            setattr(mod, name, f)


def zero_counts() -> None:
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.sparse import conv

    for f in (conv.subm_conv_cuda, conv.subm_conv_dfeats_cuda, conv.subm_conv_dw_cuda,
              fps_ops.fps_cuda):
        f.launches = 0


def read_counts() -> dict:
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.sparse import conv

    return {"subm_conv": conv.subm_conv_cuda.launches,
            "subm_conv_dfeats": conv.subm_conv_dfeats_cuda.launches,
            "subm_conv_dw": conv.subm_conv_dw_cuda.launches, "fps": fps_ops.fps_cuda.launches}


def k1_shape_counts(cfg, caps):
    """(V, Cin, Cout) -> launches per forward of the U-Net in sparse/unet.py."""
    shapes = Counter()
    c = cfg.channels
    shapes[(caps[0], 6 if cfg.with_coords else 3, c)] += 1  # input_conv
    for lvl in range(cfg.num_blocks):
        cl = c * (lvl + 1)
        shapes[(caps[lvl], cl, cl)] += 4  # block0, block1
        if lvl < cfg.num_blocks - 1:
            shapes[(caps[lvl], 2 * cl, cl)] += 1  # tail_block0.conv0 after the concat
            shapes[(caps[lvl], cl, cl)] += 3
    return shapes


def gp_labels(seed: int, n: int) -> dict:
    """Seeded per-point GP labels: prob ~ U(0.5, 1), mu ~ N(0, 1), var ~
    U(0, 0.5) with a fifth set to 0, so that both KL branches and the
    prob-weighted BCE run. Inference does not read them."""
    rng = np.random.default_rng(1000 + seed)
    var = rng.uniform(0.0, 0.5, n).astype(np.float32)
    var[rng.random(n) < 0.2] = 0.0
    return dict(prob=rng.uniform(0.5, 1.0, n).astype(np.float32),
                mu=rng.normal(size=n).astype(np.float32), var=var)


def scene_inputs(seed: int, tiny: bool = False):
    """A synthetic scene with labels and its padded point batch: the bench
    scene of about 240k points at voxel scale 50, or the tiny configuration's
    scene at voxel scale 10 (``__graft_entry__.py``)."""
    from gapro_tpu_torch.data import make_synthetic_scene, remap_semantic_for_training
    from gapro_tpu_torch.models import prepare

    if tiny:
        s = make_synthetic_scene(seed=seed, n_objects=3, points_per_object=200, n_floor=300,
                                 n_wall=200)
    else:
        s = make_synthetic_scene(seed=seed, n_objects=12, points_per_object=15000,
                                 n_floor=40000, n_wall=20000)
    pb = prepare.points_to_batch_np([dict(
        xyz=s.xyz, rgb=s.rgb, spp=s.spp, semantic=remap_semantic_for_training(s.semantic_label),
        instance=s.instance_label, **gp_labels(seed, len(s.xyz)))],
        voxel_scale=10 if tiny else 50, n_cap=2048 if tiny else N_CAP)
    return s, pb


def serve(model, s, pb, device):
    """One request: prepare -> forward_inference -> get_instances. Returns
    the prepared batch, the model outputs, the instance records and each
    stage's milliseconds (host clock, the card synchronised after each)."""
    import torch

    from gapro_tpu_torch.models import inference, prepare

    stamps = [time.perf_counter()]

    def stage():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    prepared = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, device), N_CAP, 1,
                                           model.cfg.num_blocks, model.cfg.spp_cap, FULL_SHRINK)
    stage()
    out = model.forward_inference(prepared.batch, ROUNDS)
    stage()
    inst = inference.get_instances("scene_synthetic", out, prepared.batch, s.spp,
                                   prepared.point2voxel, len(s.xyz))
    stage()
    ms = {k: (stamps[i + 1] - stamps[i]) * 1e3
          for i, k in enumerate(("prepare", "forward", "instances"))}
    return prepared, out, inst, ms


def compare_outputs(got: dict, want: dict, rtol: float, what: str) -> float:
    """Discrete outputs equal; floats within rtol of the output's scale.
    Reports every output that disagrees before failing. Returns the largest
    float error relative to scale."""
    import torch

    if set(got) != set(want):
        fail(f"{what}: output keys differ: {sorted(set(got) ^ set(want))}")
    worst, bad = 0.0, []
    for key in sorted(want):
        a, b = got[key], want[key]
        if not isinstance(b, torch.Tensor):
            if a != b:
                bad.append(f"{key} = {a} vs {b}")
            continue
        a, b = a.cpu(), b.cpu()
        if a.shape != b.shape:
            bad.append(f"{key} shape {tuple(a.shape)} vs {tuple(b.shape)}")
        elif b.dtype.is_floating_point:
            # the fill of invalid superpoints must be exact in both runs, and
            # does not count towards the scale of the other entries
            fill = b == MASK_FILL
            if not torch.equal(a == MASK_FILL, fill):
                bad.append(f"{key}: the {MASK_FILL} fill differs")
            a, b = a[~fill], b[~fill]
            scale = max(1.0, float(b.abs().max())) if b.numel() else 1.0
            err = float((a - b).abs().max()) / scale if b.numel() else 0.0
            worst = max(worst, err)
            if not torch.isfinite(a).all() or err > rtol:
                bad.append(f"{key} differs by {err:.3g} of its scale {scale:.3g} (> {rtol})")
        elif not torch.equal(a, b):
            bad.append(f"{key} differs in {int((a != b).sum())} of {b.numel()} entries")
    if bad:
        fail(f"{what}: " + "; ".join(bad))
    return worst


def same_instances(a, b) -> bool:
    return len(a) == len(b) and all(
        x["label_id"] == y["label_id"] and np.array_equal(x["pred_mask"]["counts"],
                                                          y["pred_mask"]["counts"])
        and math.isclose(x["conf"], y["conf"], rel_tol=PATH_RTOL, abs_tol=PATH_RTOL)
        for x, y in zip(a, b))


# The layer calls of one request timed by ``layer_times``: (module under
# gapro_tpu_torch, function looked up there at call time).
LAYERS = (
    ("models.prepare", "voxelize"), ("models.prepare", "build_unet_plan"),
    ("sparse.unet", "subm_conv_auto"), ("sparse.unet", "down_conv"),
    ("sparse.unet", "inverse_conv"), ("ops.fps", "fps"), ("models.aggregator", "ball_query"),
    ("models.isbnet", "dyco_mlp"), ("models.inference", "isbnet_postprocess"),
    ("models.inference", "rle_encode_rows"),
)


def layer_times(fn) -> dict:
    """Run ``fn`` once with every call of ``LAYERS`` wrapped in host timers,
    the card synchronised before and after each. Returns ms by layer."""
    import torch

    acc, saved = Counter(), []

    def timer(f, key):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            torch.cuda.synchronize()
            acc[key] += (time.perf_counter() - t0) * 1e3
            return out
        return timed

    for mod_name, name in LAYERS:
        mod = importlib.import_module(f"gapro_tpu_torch.{mod_name}")
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, timer(getattr(mod, name), f"{mod_name}.{name}"))
    try:
        fn()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    return dict(acc)


def profile_request(fn, what: str, top: int = 12) -> None:
    """Run ``fn`` once under torch.profiler and print the device time by
    kernel and the share of its wall time the card was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print(f"profile, {what}: wall {wall_ms:.1f} ms; the profiler recorded no device time",
              flush=True)
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = Counter()
    for e in kern:
        by_name[e.name[:70]] += e.time_range.elapsed_us() / 1e3
    print(f"profile, {what}: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms in "
          f"{len(kern)} launches (busy {busy_ms / wall_ms:.1%} of wall, idle {1 - busy_ms / wall_ms:.1%})",
          flush=True)
    for name, ms in by_name.most_common(top):
        print(f"  {ms:9.3f} ms  {name}", flush=True)


def backward_kernel_phase(cfg, caps, levels, dev) -> tuple:
    """The conv's backward at the 14 shapes of the full-width U-Net: dfeats
    (K1 on the reversed, transposed weights) and dW (``subm_conv_dw.cu``)
    against ``torch.autograd.grad`` of the plain conv, for a random dout.
    Returns the per-step sums (ms, plain ms, bound, max error) of each."""
    import torch

    from gapro_tpu_torch.sparse import conv

    g = torch.Generator().manual_seed(1)
    acc = {k: dict(ms=0.0, plain_ms=0.0, bound=0.0, bytes_ms=0.0, ops_ms=0.0, err=0.0)
           for k in ("dfeats", "dw")}
    stem = (caps[0], 6 if cfg.with_coords else 3)
    print("conv backward vs autograd of the plain conv (per launch; V, Cin, Cout, "
          "launches/step):", flush=True)
    for (v, cin, cout), count in sorted(k1_shape_counts(cfg, caps).items()):
        lp = levels[caps.index(v)]
        valid, nbr = lp.grid.valid, lp.subm_nbr
        feats = (torch.randn(v, cin, generator=g).to(dev) * valid[:, None]).contiguous()
        dout = (torch.randn(v, cout, generator=g).to(dev) * valid[:, None]).contiguous()
        b = math.sqrt(3.0 / (27 * cin))
        w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * b).to(dev)
        pf, pw = feats.clone().requires_grad_(), w.clone().requires_grad_()
        want_df, want_dw = torch.autograd.grad(conv.subm_conv(pf, nbr, pw, valid), (pf, pw), dout)
        w_rev = w.flip(0).transpose(1, 2).contiguous()
        got_df = conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid)
        got_dw = conv.subm_conv_dw_cuda(feats, nbr, dout)
        again = conv.subm_conv_dw_cuda(feats, nbr, dout)
        torch.cuda.synchronize()
        nnz = int((nbr >= 0).sum())
        flops = 2.0 * nnz * cin * cout
        n_df = count - (1 if (v, cin) == stem else 0)  # the stem's input has no gradient
        line = [f"  V={v:6d} Cin={cin:3d} Cout={cout:3d}"]
        for key, got, want, rtol, n, run, plain, nbytes in (
                ("dfeats", got_df, want_df, K1_RTOL, n_df,
                 lambda: conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid),
                 lambda: conv.subm_conv(dout, nbr, w_rev, valid),
                 v * 27 * 4 + v * cout * 4 + 27 * cin * cout * 4 + v + v * cin * 4),
                ("dw", got_dw, want_dw, dw_rtol(v), count,
                 lambda: conv.subm_conv_dw_cuda(feats, nbr, dout),
                 lambda: conv.subm_conv_dw(feats, nbr, dout),
                 v * 27 * 4 + v * cin * 4 + v * cout * 4 + 27 * cin * cout * 4)):
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            if err > rtol * scale:
                fail(f"{key} at V={v} Cin={cin} Cout={cout}: max |err| {err:.3g} > "
                     f"{rtol:.3g} x {scale:.3g}")
            ms, pms = cuda_ms(run, 10), cuda_ms(plain, 3)
            bms, by = bound_ms(nbytes, flops)
            a = acc[key]
            a["ms"] += n * ms
            a["plain_ms"] += n * pms
            a["bound"] += n * bms
            a["bytes_ms"] += n * nbytes / HBM_BYTES_PER_S * 1e3
            a["ops_ms"] += n * flops / FP32_FLOPS * 1e3
            a["err"] = max(a["err"], err)
            line.append(f"{key} x{n}: kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} "
                        f"ms ({by}), max|err| {err:.3g}")
        if not bool((got_df[~valid] == 0).all()):
            fail(f"dfeats at V={v}: invalid rows are not exactly 0")
        if not torch.equal(got_dw, again):
            fail(f"dW at V={v} Cin={cin} Cout={cout} differs between two launches")
        print("; ".join(line) + f"; {flops / 1e9:.3f} GFLOP; dW bit-identical", flush=True)
    for key, n in (("dfeats", 52), ("dw", 53)):
        a = acc[key]
        print(f"{key} per step ({n} launches): kernel {a['ms']:.3f} ms, plain "
              f"{a['plain_ms']:.3f} ms, bound {a['bound']:.3f} ms", flush=True)
    return acc["dfeats"], acc["dw"]


def grads_and_stats(model) -> tuple:
    grads = {n: (p.grad.detach().clone() if p.grad is not None else None)
             for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    return grads, stats


def compare_step(got: tuple, want: tuple, rtols: tuple, what: str, noise=None) -> str:
    """Losses, gradients and BatchNorm statistics of one step, each within
    its tolerance in ``rtols`` (losses, gradients, statistics). ``noise``, a
    third run of ``got``'s path on inputs one ulp apart, sets the gradients'
    bound as NOISE_FACTOR says. Returns a summary of the agreement."""
    import torch

    (lg, gg, sg), (lw, gw, sw) = got, want
    loss_rtol, grad_rtol, bn_rtol = rtols
    bad = []
    for k, w in lw.items():
        a, b = float(lg[k]), float(w)
        if not math.isfinite(a) or abs(a - b) > loss_rtol * max(1.0, abs(b)):
            bad.append(f"loss {k} {a:.6g} vs {b:.6g}")
    top = max(float(t.abs().max()) for t in gw.values() if t is not None)
    worst = []
    for k, w in gw.items():
        a = gg[k]
        if (a is None) != (w is None):
            bad.append(f"grad {k}: present in one run only")
            continue
        if w is None:
            continue
        a, w = a.cpu(), w.cpu()
        err = float((a - w).abs().max())
        tol = grad_rtol * float(w.abs().max()) + GRAD_ATOL * top
        spread = float((noise[1][k].cpu() - a).abs().max()) if noise is not None else 0.0
        worst.append((err / tol, spread / tol, k))
        if not torch.isfinite(a).all():
            bad.append(f"grad {k} is not finite")
    bn_err = 0.0
    for k, w in sw.items():
        a, w = sg[k].cpu(), w.cpu()
        err = float((a - w).abs().max()) / max(1.0, float(w.abs().max()))
        bn_err = max(bn_err, err)
        if err > bn_rtol:
            bad.append(f"BatchNorm {k} differs by {err:.3g} of its scale")
    worst.sort(reverse=True)
    over = sum(e > 1 for e, _, _ in worst)
    noise_max = max(n for _, n, _ in worst)
    noise_over = sum(n > 1 for _, n, _ in worst)
    bound = max(1.0, NOISE_FACTOR * noise_max)
    if noise is not None:
        print(f"{what}: the 8 gradient leaves furthest from agreement, as (error, the noise "
              f"run's spread) over the tolerance: "
              + "; ".join(f"{k} ({e:.3g}, {n:.3g})" for e, n, k in worst[:8]), flush=True)
        print(f"{what}: leaves over the tolerance: {over} of {len(worst)}; the noise run's "
              f"over it: {noise_over}; largest {worst[0][0]:.3g} against the noise run's "
              f"{noise_max:.3g}", flush=True)
    if worst[0][0] > bound or over > NOISE_FACTOR * noise_over:
        bad.append(f"gradients: {over} leaves over their tolerance (the noise run: "
                   f"{noise_over}), the largest at {worst[0][0]:.3g} of it ({worst[0][2]}; "
                   f"bound {bound:.3g})")
    if bad:
        fail(f"{what}: " + "; ".join(bad[:12]) + (f" (+{len(bad) - 12} more)" if len(bad) > 12
                                                   else ""))
    return (f"losses within {loss_rtol}, {len(worst)} gradient leaves, the furthest at "
            f"{worst[0][0]:.3g} of its tolerance ({worst[0][2]}), BatchNorm statistics within "
            f"{bn_err:.3g} of scale")


def one_step_grads(model, prepared, crit, assign=None) -> tuple:
    """Forward, targets, matching, criterion and backward of one training
    step, without the update: (losses, gradients, BatchNorm statistics),
    and the assignment with the matcher's own (``assign`` given or not)."""
    from gapro_tpu_torch.losses import criterion
    from gapro_tpu_torch.train import step

    model.train()
    loss, (losses, aux) = step._loss_fn(model, prepared, crit, assign=assign)
    loss.backward()
    own = aux["assign"] if assign is None else criterion.match(aux["outputs"], aux["targets"])
    grads, stats = grads_and_stats(model)
    return ({k: float(v.detach()) for k, v in losses.items()}, grads, stats), aux["assign"], own


def tiny_train_reference(tiny, dev) -> None:
    """One step of the tiny configuration on the card (kernels) and on the
    CPU (plain versions), from the same weights and scene; the CPU run takes
    the card's assignment."""
    import torch

    from gapro_tpu_torch.losses.criterion import CriterionConfig
    from gapro_tpu_torch.models import isbnet, prepare

    crit = CriterionConfig(inst_cap=TINY_INST_CAP)
    _, tpb = scene_inputs(0, tiny=True)
    runs = {}
    for d in ("cuda", "cpu"):
        tp = prepare.prepare_voxel_batch(prepare.upload_point_batch(tpb, d), 2048, 1, 3, 256, 0.7)
        model = isbnet.ISBNet(tiny, seed=0, device=d)
        card_assign = runs["cuda"][1].cpu() if d == "cpu" else None
        runs[d] = one_step_grads(model, tp, crit, assign=card_assign)
    summary = compare_step(runs["cuda"][0], runs["cpu"][0], TINY_RTOLS, "tiny step, card vs CPU")
    agreed = torch.equal(runs["cpu"][2].cpu(), runs["cuda"][1].cpu())
    print(f"reference: one tiny training step on the card equals the CPU run ({summary}); the "
          f"CPU run's own matcher {'agreed' if agreed else 'DISAGREED'} with the card's "
          f"assignment; loss {runs['cuda'][0][0]['loss']:.6f}", flush=True)


def train_path(cfg, scenes, dev) -> dict:
    """The full-width training path: one cold step on scene 0, then the
    counts zeroed and one step on each of scenes 0, 1 and 2 through
    ``make_train_step``, each timed by stage. Returns the launch counts and
    a callable for one more step (for the profile)."""
    import torch

    from gapro_tpu_torch.losses.criterion import CriterionConfig
    from gapro_tpu_torch.models import isbnet, prepare
    from gapro_tpu_torch.train import state, step

    model = isbnet.ISBNet(cfg, seed=0, device=dev)
    st = state.create_train_state(model, lr=TRAIN_LR)
    stamps = []

    def mark(name):
        torch.cuda.synchronize()
        stamps.append((name, time.perf_counter()))

    train_step = step.make_train_step(model, CriterionConfig(inst_cap=INST_CAP), on_stage=mark)

    def one(pb):
        nonlocal st
        stamps.clear()
        mark("start")
        prepared = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, dev), N_CAP, 1,
                                               cfg.num_blocks, cfg.spp_cap, FULL_SHRINK)
        mark("prepare")
        st, losses = train_step(st, prepared, TRAIN_LR)
        ms = {name: (t - stamps[i][1]) * 1e3 for i, (name, t) in enumerate(stamps[1:])}
        return prepared, {k: float(v) for k, v in losses.items()}, ms

    def report(label, prepared, losses, ms):
        print(f"{label}: {prepared.batch.plan.levels[0].grid.num_voxels} voxels, "
              f"{sum(ms.values()):.1f} ms ("
              + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) + " ms); "
              + ", ".join(f"{k} {v:.6g}" for k, v in losses.items()), flush=True)

    report("cold training step, scene 0", *one(scenes[0][1]))
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for seed, (_, pb) in enumerate(scenes):
        prepared, losses, ms = one(pb)
        times.append(sum(ms.values()))
        report(f"training step, scene {seed}", prepared, losses, ms)
        bad = [k for k, v in losses.items() if not math.isfinite(v)]
        if bad:
            fail(f"training step on scene {seed}: losses not finite: {bad}")
    launches = read_counts()
    print(f"training path launches over 3 steps: {launches}; per step median "
          f"{statistics.median(times):.1f} ms (all: {', '.join(f'{t:.1f}' for t in times)}); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    need = {"subm_conv": 53, "subm_conv_dfeats": 52, "subm_conv_dw": 53, "fps": 1}
    if any(launches[k] < 3 * n for k, n in need.items()):
        fail(f"the training path did not run through the kernels as expected: {launches}, "
             f"need at least {need} per step")
    return dict(launches=launches, again=lambda: one(scenes[1][1]))


def train_plain_compare(cfg, pb, dev) -> None:
    """Scene 0: one step's losses, gradients and BatchNorm statistics from
    the same initial weights through the kernels and through the plain
    versions, the plain run given the kernel run's assignment."""
    import torch

    from gapro_tpu_torch.losses.criterion import CriterionConfig
    from gapro_tpu_torch.models import isbnet, prepare

    crit = CriterionConfig(inst_cap=INST_CAP)
    prepared = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, dev), N_CAP, 1,
                                           cfg.num_blocks, cfg.spp_cap, FULL_SHRINK)
    kern, assign, _ = one_step_grads(isbnet.ISBNet(cfg, seed=0, device=dev), prepared, crit)
    nudged = prepared._replace(batch=dataclasses.replace(
        prepared.batch, feats=prepared.batch.feats * (1 + 2.0 ** -23)))
    noise, _, _ = one_step_grads(isbnet.ISBNet(cfg, seed=0, device=dev), nudged, crit,
                                 assign=assign)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_kernels():
        plain, _, own = one_step_grads(isbnet.ISBNet(cfg, seed=0, device=dev), prepared, crit,
                                       assign=assign)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    summary = compare_step(kern, plain, PATH_RTOLS, "training step, kernels vs plain",
                           noise=noise)
    n_gt = int((assign >= 0).sum())
    print(f"plain training step, scene 0: {plain_ms:.1f} ms; agrees with the kernels "
          f"({summary}); {n_gt} matched instances; the plain run's own matcher "
          f"{'agreed' if torch.equal(own, assign) else 'DISAGREED'}", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gapro_tpu_torch import cuda_build
    from gapro_tpu_torch.models import isbnet, prepare
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.sparse import conv
    from gapro_tpu_torch.sparse.plan import level_capacities

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    cuda_build.build_all()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc, one process per source)", flush=True)
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # Full width. Untrained semantics are near uniform over 19 classes (every
    # class below the 0.1 background threshold), which would leave no
    # foreground voxel and an empty query path; keep every voxel foreground,
    # as the repo's tiny configuration does (__graft_entry__.py).
    cfg = isbnet.ISBNetConfig(filter_bg_thresh=0.0)
    caps = level_capacities(N_CAP, cfg.num_blocks, FULL_SHRINK)
    scenes = [scene_inputs(seed) for seed in range(3)]
    model = isbnet.ISBNet(cfg, seed=0, device=dev)
    # Untrained box-confidence logits all sit below 0, where clip(conf, 0, 1)
    # zeroes every score and get_instances would rank nothing; shift the
    # conf head's output bias so the scores are positive.
    with torch.no_grad():
        model.inst_conf_head.dense2.bias += CONF_SHIFT

    # ---- 1. kernel phase ------------------------------------------------
    with plain_kernels():
        prep0 = prepare.prepare_voxel_batch(prepare.upload_point_batch(scenes[0][1], dev),
                                            N_CAP, 1, cfg.num_blocks, cfg.spp_cap, FULL_SHRINK)
    levels = prep0.batch.plan.levels
    g = torch.Generator().manual_seed(0)
    k1 = dict(ms=0.0, plain_ms=0.0, bound=0.0, bytes_ms=0.0, ops_ms=0.0, err=0.0)
    print("K1 subm_conv_cuda vs plain (per launch; V, Cin, Cout, launches/scene):", flush=True)
    for (v, cin, cout), count in sorted(k1_shape_counts(cfg, caps).items()):
        lp = levels[caps.index(v)]
        valid = lp.grid.valid
        feats = torch.randn(v, cin, generator=g).to(dev) * valid[:, None]
        b = math.sqrt(3.0 / (27 * cin))
        w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * b).to(dev)
        got = conv.subm_conv_cuda(feats, lp.subm_nbr, w, valid)
        want = conv.subm_conv(feats, lp.subm_nbr, w, valid)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        if err > K1_RTOL * scale:
            fail(f"K1 at V={v} Cin={cin} Cout={cout}: max |err| {err:.3g} > {K1_RTOL} x {scale:.3g}")
        if not bool((got[~valid] == 0).all()):
            fail(f"K1 at V={v}: invalid rows are not exactly 0")
        ms = cuda_ms(lambda: conv.subm_conv_cuda(feats, lp.subm_nbr, w, valid), 10)
        pms = cuda_ms(lambda: conv.subm_conv(feats, lp.subm_nbr, w, valid), 5)
        nnz = int((lp.subm_nbr >= 0).sum())
        nbytes = v * 27 * 4 + v * cin * 4 + 27 * cin * cout * 4 + v + v * cout * 4
        flops = 2.0 * nnz * cin * cout
        bms, by = bound_ms(nbytes, flops)
        print(f"  V={v:6d} Cin={cin:3d} Cout={cout:3d} x{count}: kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), max|err| {err:.3g}", flush=True)
        k1["ms"] += count * ms
        k1["plain_ms"] += count * pms
        k1["bound"] += count * bms
        k1["bytes_ms"] += count * nbytes / HBM_BYTES_PER_S * 1e3
        k1["ops_ms"] += count * flops / FP32_FLOPS * 1e3
        k1["err"] = max(k1["err"], err)
    print(f"K1 per scene (53 launches): kernel {k1['ms']:.3f} ms, plain {k1['plain_ms']:.3f} ms, "
          f"bound {k1['bound']:.3f} ms", flush=True)

    xyz0 = prep0.batch.coords_float[None].contiguous()
    valid0 = prep0.batch.valid[None].contiguous()
    k4 = dict(ms=0.0, plain_ms=0.0, bound=0.0, bytes_ms=0.0, ops_ms=0.0, err=0.0)
    print("K4 fps_cuda vs plain (N -> n):", flush=True)
    first_idx = None
    for n_pts, n_sample in [(N_CAP, cfg.n_sample_pa1)] + [(cfg.n_sample_pa1, r) for r in ROUNDS]:
        if n_pts == N_CAP:
            xyz, valid = xyz0, valid0
        else:
            xyz = xyz0[0, first_idx[0].long()][None].contiguous()
            valid = torch.ones(1, n_pts, dtype=torch.bool, device=dev)
        got = fps_ops.fps_cuda(xyz, valid, n_sample)
        want = fps_ops.fps_masked(xyz, valid, n_sample)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            nd = int((got[0] != want[0]).sum())
            fail(f"K4 at N={n_pts}, n={n_sample}: {nd} indices differ from the plain version")
        if first_idx is None:
            first_idx = got[0]
        ms = cuda_ms(lambda: fps_ops.fps_cuda(xyz, valid, n_sample), 5)
        pms = cuda_ms(lambda: fps_ops.fps_masked(xyz, valid, n_sample), 1)
        n_valid = int(valid.sum())
        nbytes = n_pts * 12 + n_pts + n_sample * 4
        ops = 10.0 * n_valid * (n_sample - 1)  # 3 sub, 3 mul, 2 add, min, compare
        bms, by = bound_ms(nbytes, ops)
        print(f"  N={n_pts:6d} n={n_sample:4d}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.5f} ms ({by}), indices equal", flush=True)
        k4["ms"] += ms
        k4["plain_ms"] += pms
        k4["bound"] += bms
        k4["bytes_ms"] += nbytes / HBM_BYTES_PER_S * 1e3
        k4["ops_ms"] += ops / FP32_FLOPS * 1e3
    print(f"K4 per scene (4 launches): kernel {k4['ms']:.3f} ms, plain {k4['plain_ms']:.3f} ms, "
          f"bound {k4['bound']:.4f} ms", flush=True)

    # ---- 2. backward-kernel phase -------------------------------------------
    dfeats_acc, dw_acc = backward_kernel_phase(cfg, caps, levels, dev)
    del prep0, levels

    # ---- 3. reference phase: tiny configuration, card against CPU --------
    tiny = isbnet.ISBNetConfig(channels=8, num_blocks=3, n_sample_pa1=64, n_queries=16,
                               neighbor=8, dec_dim=32, mask_dim_out=8, spp_cap=256,
                               filter_bg_thresh=0.0)
    _, tpb = scene_inputs(0, tiny=True)
    outs = {}
    for d in ("cpu", "cuda"):
        tp = prepare.prepare_voxel_batch(prepare.upload_point_batch(tpb, d), 2048, 1, 3, 256, 0.7)
        outs[d] = isbnet.ISBNet(tiny, seed=0, device=d).forward_inference(tp.batch, (16, 8, 4))
    err = compare_outputs(outs["cuda"], outs["cpu"], 1e-4, "tiny card vs CPU")
    print(f"reference: tiny configuration on the card equals the CPU run "
          f"(discrete equal, floats within {err:.3g} of scale)", flush=True)
    tiny_train_reference(tiny, dev)

    # ---- 4. inference path: full width, 3 scenes ----------------------------
    # One cold request first: it pays the allocator's growth and the
    # libraries' set-up, which a server pays once, not per scene.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages = serve(model, *scenes[0], dev)[3]
    print(f"cold request, scene 0: {(time.perf_counter() - t0) * 1e3:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()) + " ms)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    results, times = [], []
    for seed, (s, pb) in enumerate(scenes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepared, out, inst, stages = serve(model, s, pb, dev)
        times.append((time.perf_counter() - t0) * 1e3)
        results.append((prepared, out, inst))
        print(f"scene {seed}: {len(s.xyz)} points, {prepared.batch.plan.levels[0].grid.num_voxels} "
              f"voxels, {times[-1]:.1f} ms ("
              + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
              + f" ms), {len(inst)} instances, "
              + ", ".join(f"{k}={out[k]}" for k in sorted(out) if k.startswith("ovf_")), flush=True)
    launches = read_counts()
    print(f"path launches over 3 scenes: {launches}; per scene "
          f"median {statistics.median(times):.1f} ms (all: {', '.join(f'{t:.1f}' for t in times)}); "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if launches["subm_conv"] < 53 * 3 or launches["fps"] != 4 * 3:
        fail(f"the path did not run through the kernels as expected: {launches}")

    for prepared, out, inst in results:
        q = sum(ROUNDS)
        for key, shape in (("mask_logits", (1, q, cfg.spp_cap)), ("cls_logits", (1, q, 19)),
                           ("semantic_scores", (N_CAP, 19)), ("voxel_feats", (N_CAP, 32))):
            if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
                fail(f"{key}: shape {tuple(out[key].shape)} (want {shape}) or not finite")
        if not inst:
            fail("a full-width scene gave no instance")

    # ---- 5. plain phase: scene 0 with the plain versions --------------------
    with plain_kernels():
        _, out_plain, inst_plain, stages = serve(model, *scenes[0], dev)
    print(f"plain versions, scene 0: " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + " ms", flush=True)
    err = compare_outputs(results[0][1], out_plain, PATH_RTOL, "scene 0 kernels vs plain")
    if not same_instances(results[0][2], inst_plain):
        ml, mp = results[0][1]["mask_logits"], out_plain["mask_logits"]
        flips = (ml >= 0) != (mp >= 0)
        worst = float(mp[flips].abs().max()) if bool(flips.any()) else 0.0
        fail(f"scene 0 instance lists differ: {len(results[0][2])} vs {len(inst_plain)} records; "
             f"{int(flips.sum())} mask logits change sign, the largest by |{worst:.3g}|")
    print(f"plain: scene 0 through the plain versions agrees (discrete equal, floats within "
          f"{err:.3g} of scale, {len(inst_plain)} identical instances)", flush=True)
    del results, out_plain

    # ---- 6. training path: full width, 3 steps, then one profiled ----------
    train = train_path(cfg, scenes, dev)
    profile_request(train["again"], "training step, scene 1")

    # ---- 7. plain training comparison: scene 0 -------------------------------
    train_plain_compare(cfg, scenes[0][1], dev)

    # ---- 8. where the time goes: layer times, then profiles -----------------
    stages = {}
    layers = layer_times(lambda: stages.update(serve(model, *scenes[2], dev)[3]))
    print("layers, scene 2 (host clock, synchronised around each call): "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()) + " ms; "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(layers.items(), key=lambda kv: -kv[1]))
          + " ms", flush=True)
    profile_request(lambda: serve(model, *scenes[1], dev), "request, scene 1")

    tl = train["launches"]
    kernels = []
    for name, src, rep, k, n, extra in (
            ("subm_conv", "gapro_tpu_torch/csrc/subm_conv.cu",
             "gapro_tpu/sparse/window_conv.py:263", k1, launches["subm_conv"],
             dict(train_launches=tl["subm_conv"], bwd_launches=tl["subm_conv_dfeats"],
                  bwd_ms=dfeats_acc["ms"], bwd_plain_ms=dfeats_acc["plain_ms"],
                  bwd_bound_ms=dfeats_acc["bound"], bwd_max_abs_err=dfeats_acc["err"])),
            ("subm_conv_dw", "gapro_tpu_torch/csrc/subm_conv_dw.cu",
             "gapro_tpu/sparse/window_conv.py:404, gapro_tpu/sparse/window_conv.py:366", dw_acc,
             tl["subm_conv_dw"], {}),
            ("fps", "gapro_tpu_torch/csrc/fps.cu", "gapro_tpu/ops/fps_pallas.py:42", k4,
             launches["fps"], dict(train_launches=tl["fps"]))):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=n,
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound"],
            bound_by="bytes" if k["bytes_ms"] >= k["ops_ms"] else "operations",
            library_ms=None, **extra))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
