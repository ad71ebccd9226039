#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``gapro_tpu_torch/csrc/`` and:

1. kernel phase: runs each kernel against its plain PyTorch version on the
   card at the shapes the full-width ISBNet inference gives it (K1, the
   submanifold conv, at every level capacity and channel pair; K4, FPS, at
   N = 262144 -> 2048 and N = 2048 -> 192 / 128 / 64), and times kernel,
   plain version and bound;
2. reference phase: the tiny configuration on the card (kernels) against
   the same model on the CPU (plain versions), which the CPU test suite
   holds against the JAX package;
3. path phase: full-width ISBNet inference (configs/isbnet_scannetv2.yaml,
   seeded random weights) on three synthetic scenes of about 240k points,
   prepare -> forward_inference -> get_instances, with the kernels' launch
   counts zeroed just before and read just after;
4. plain phase: scene 0 again with the plain versions in place of the
   kernels; outputs agree within the stated tolerance and the instance
   lists are identical;
5. where the time goes: one request with its layer calls timed, and one
   under torch.profiler (device time by kernel, the card's busy share of
   the request's wall time).

It prints the card's name and power limit, one ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""

from __future__ import annotations

import contextlib
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

    saved = conv.subm_conv_cuda, fps_ops.fps_cuda
    conv.subm_conv_cuda, fps_ops.fps_cuda = conv.subm_conv, fps_ops.fps_masked
    try:
        yield
    finally:
        conv.subm_conv_cuda, fps_ops.fps_cuda = saved


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


def scene_inputs(seed: int):
    from gapro_tpu_torch.data import make_synthetic_scene, remap_semantic_for_training
    from gapro_tpu_torch.models import prepare

    s = make_synthetic_scene(seed=seed, n_objects=12, points_per_object=15000,
                             n_floor=40000, n_wall=20000)
    pb = prepare.points_to_batch_np([dict(
        xyz=s.xyz, rgb=s.rgb, spp=s.spp, semantic=remap_semantic_for_training(s.semantic_label),
        instance=s.instance_label)], voxel_scale=50, n_cap=N_CAP)
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


def profile_request(fn, top: int = 12) -> None:
    """Run ``fn`` once under torch.profiler and print the device time by
    kernel and the share of the request's wall time the card was busy."""
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
        print(f"profile, scene 1: wall {wall_ms:.1f} ms; the profiler recorded no device time",
              flush=True)
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = Counter()
    for e in kern:
        by_name[e.name[:70]] += e.time_range.elapsed_us() / 1e3
    print(f"profile, scene 1: wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms in "
          f"{len(kern)} launches (busy {busy_ms / wall_ms:.1%} of wall, idle {1 - busy_ms / wall_ms:.1%})",
          flush=True)
    for name, ms in by_name.most_common(top):
        print(f"  {ms:9.3f} ms  {name}", flush=True)


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
    del prep0, levels

    # ---- 2. reference phase: tiny configuration, card against CPU --------
    tiny = isbnet.ISBNetConfig(channels=8, num_blocks=3, n_sample_pa1=64, n_queries=16,
                               neighbor=8, dec_dim=32, mask_dim_out=8, spp_cap=256,
                               filter_bg_thresh=0.0)
    from gapro_tpu_torch.data import make_synthetic_scene

    ts = make_synthetic_scene(seed=0, n_objects=3, points_per_object=200, n_floor=300, n_wall=200)
    tpb = prepare.points_to_batch_np([dict(xyz=ts.xyz, rgb=ts.rgb, spp=ts.spp)],
                                     voxel_scale=10, n_cap=2048)
    outs = {}
    for d in ("cpu", "cuda"):
        tp = prepare.prepare_voxel_batch(prepare.upload_point_batch(tpb, d), 2048, 1, 3, 256, 0.7)
        outs[d] = isbnet.ISBNet(tiny, seed=0, device=d).forward_inference(tp.batch, (16, 8, 4))
    err = compare_outputs(outs["cuda"], outs["cpu"], 1e-4, "tiny card vs CPU")
    print(f"reference: tiny configuration on the card equals the CPU run "
          f"(discrete equal, floats within {err:.3g} of scale)", flush=True)

    # ---- 3. path phase: full-width inference, 3 scenes --------------------
    # One cold request first: it pays the allocator's growth and the
    # libraries' set-up, which a server pays once, not per scene.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stages = serve(model, *scenes[0], dev)[3]
    print(f"cold request, scene 0: {(time.perf_counter() - t0) * 1e3:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()) + " ms)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    conv.subm_conv_cuda.launches = 0
    fps_ops.fps_cuda.launches = 0
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
    launches = {"subm_conv": conv.subm_conv_cuda.launches, "fps": fps_ops.fps_cuda.launches}
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

    # ---- 4. plain phase: scene 0 with the plain versions --------------------
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

    # ---- 5. where the time goes: layer times, then one profiled request ------
    stages = {}
    layers = layer_times(lambda: stages.update(serve(model, *scenes[2], dev)[3]))
    print("layers, scene 2 (host clock, synchronised around each call): "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()) + " ms; "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(layers.items(), key=lambda kv: -kv[1]))
          + " ms", flush=True)
    profile_request(lambda: serve(model, *scenes[1], dev))

    kernels = []
    for name, src, rep, k in (
            ("subm_conv", "gapro_tpu_torch/csrc/subm_conv.cu",
             "gapro_tpu/sparse/window_conv.py:263", k1),
            ("fps", "gapro_tpu_torch/csrc/fps.cu", "gapro_tpu/ops/fps_pallas.py:42", k4)):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound"],
            bound_by="bytes" if k["bytes_ms"] >= k["ops_ms"] else "operations",
            library_ms=None))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
