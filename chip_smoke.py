#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``gapro_tpu_torch/csrc/`` and:

1. kernel phase: runs each kernel against its plain PyTorch version on the
   card at the shapes the full-width ISBNet gives it (K1, the submanifold
   conv, at every level capacity and channel pair, and both against the
   same conv in fp64 (rms, and the mean error along the output's sign,
   within K1_DRIFT_ULP); K4, FPS, at N = 262144 ->
   2048 and N = 2048 -> 192 / 128 / 64, and on one item of N = 1048576
   past what a cluster holds on chip, with its cluster shape and time a
   step; K5, the dynamic-conv mask head, at (B, Q, S) = (4, 256, 4096),
   (1, 256, 4096), (1, 192 / 128 / 64, 4096), (2, 256, 4096) with one item
   holding no valid superpoint and (1, 12, 130), both against the same
   function in fp64, and its recompute backward at the first), and times
   kernel, plain version and bound;
2. backward-kernel phase: at the same 14 conv shapes, the conv's backward
   on the card (dfeats by K1 on the reversed weights, dW by
   ``subm_conv_dw.cu``) against ``torch.autograd.grad`` of the plain conv,
   dW bit-identical across two launches and, with the plain dW, against
   the same dW in fp64 (rms, and the mean error along the output's sign
   within K1_DRIFT_ULP), timed like phase 1;
3. reference phase: the tiny configuration on the card (kernels) against
   the same model on the CPU (plain versions), inference and one training
   step; the CPU test suite holds the CPU run against the JAX package; then
   the scaled C = 32 gate (``__graft_entry__.py``'s C = 32, 3 levels, about
   8k points, shrink 1.0): one step on the card against the CPU, every
   ``ovf_*`` counter 0;
4. inference path: full-width ISBNet inference (configs/isbnet_scannetv2.yaml,
   seeded random weights) on three synthetic scenes of about 240k points,
   prepare -> forward_inference -> get_instances, with the kernels' launch
   counts zeroed just before and read just after;
5. plain phase: scene 0 again with the plain versions in place of the
   kernels; outputs agree within the stated tolerance and the instance
   lists are identical; then scene 0's stage-1 ball query (the grid form)
   on the card against the same call on the CPU, indices equal, timed
   against the tiled form;
6. training path: the full-width training step (batch 1, capacity 262144,
   inst_cap 192, AdamW at lr 1e-3, seeded GP labels) on scenes 0, 1 and 2
   after one cold step, through ``make_train_step``, with the counts zeroed
   just before and read just after;
7. plain training comparison: one step's losses, gradients and BatchNorm
   statistics on scene 0, kernels against plain versions, with the kernel
   run's assignment injected, against runs on inputs one ulp away from
   zero and one ulp towards it; and the backward kernels against theirs on
   a shared K1 forward; then K1, dfeats and dW against fp64 on that step's
   own activations and gradients (the mean along the sign within
   K1_DRIFT_ULP at every launch);
8. where the time goes: one request with its layer calls timed, and one
   request and (after phase 6) one training step under torch.profiler
   (device time by kernel, the card's busy share of the wall time);
9. the two stages of ISBNet's recipe through the port's train loop
   (gapro_tpu_torch/tools/train.py) at full width: first the backbone
   stage (configs/isbnet_backbone_scannetv2.yaml, semantic_only, batch 8,
   32 scenes with seeded GP labels from forked data workers: one cold
   step, three steps timed by stage with the counts zeroed just before and
   read just after, peak memory, validation by mIoU, accuracy and offset
   MAE on 2 scenes, one checkpoint), one batch-8 step held against the
   plain versions as in phase 7, and the conv kernels at the batch-8
   plan's shapes; then the full model at the config's batch 4 from that
   checkpoint (``pretrain``; the entries it loaded are counted), 16
   scenes, timed likewise, validation by AP on 2 scenes, and a resume from
   the checkpoint it wrote, equal bit for bit;
10. plain comparison at batch 4: one step's losses, kernels against plain
    versions, with the kernel run's assignment injected; then K4 against
    its plain version on that step's FPS input (B = 4, N = 1048576), and
    its wrapper there under torch.profiler;
11. the test CLI (gapro_tpu_torch/tools/test.py) on 2 full-size scenes:
    per-scene time and AP, counts zeroed just before and read just after;
12. one batch-4 training step with its layer calls timed (the ball query's
    beside its time in the tiled form), and one under torch.profiler;
13. SPFormer at full width (configs/spformer_scannetv2.yaml: 5 levels,
    400 queries, 6 decoder layers): the tiny configuration's widths on the
    card against the CPU (forward and one step); K1, dfeats and dW against
    their plain versions and fp64 at its U-Net's shapes; inference on the
    3 bench scenes (a cold request, then each timed, counts zeroed just
    before and read just after, peak memory); the trainer at batch 4 (one
    cold and three timed steps by stage, the matching's host time apart);
    one batch-4 step held against the plain versions as in phase 7; the
    conv kernels at that step's shapes; the test CLI on 2 scenes with AP
    and box AP;
14. the GP labeler (GaPro's stage 1, no kernel of ours): bench.py's sweep,
    16 scenes of its default preset at window 4 with ``LabelerConfig()``,
    one warm and three timed passes of ``generate_scene_labels_stream``
    (scenes/s, ``PHASE_STATS``, ``OVERFLOW_STATS``, the fit groups' shapes,
    peak memory), gate (a) scenes 0-3 as one window against the port on
    the CPU (``labeler_gate``), gate (b) two card passes bit for bit, gate
    (c) finite mu and var; one pass of bench.py's "real" preset; one pass
    under torch.profiler, and one fit group's kernels an Adam step and its
    device time against its wall time;
15. ISBNet on S3DIS (configs/isbnet_s3dis.yaml: 13 classes, the ball
    query's radius 1.5 times ScanNet's) on synthetic rooms written in the
    layout ``S3DISDataset`` reads: the x4_split request (a room of 1e6
    points served as 4 interleaved pieces, the heads on the merged room,
    the ceiling and floor from the semantics) on 3 rooms after a cold one,
    counts zeroed just before and read just after; room 0 against the plain
    versions; K4 at the merged room's stage 1, past its on-chip capacity,
    against its plain version index for index; K5 at the request's rounds;
    K1 against fp64 at the merged plan's shapes; the grid ball query at that
    radius; the trainer at batch 4 on 16 rooms (one of 1.6e6 points, so
    the 300000-point crop runs after the 25% subsample), validation on the 2
    Area_5 rooms, one checkpoint; one batch-4 step against the plain
    versions with no admission, and K1 and dfeats against fp64 on its own
    inputs; dfeats and dW against their plain versions (and dW against
    fp64) at its plan's shapes, and the conv kernels timed there; the test
    CLI with x4_split on the Area_5 rooms (AP, mCov, mWCov, mPrec, mRec);
16. the learning smoke (gapro_tpu_torch/tools/smoke_learn.py) on the card:
    first its kernels against their plain versions at its own shapes (K1,
    dfeats and dW at its ISBNet's and SPFormer's U-Net on its plan, K4 and
    K5 at M = 16 on one step's and one request's inputs); then ISBNet and
    SPFormer, 300 steps each on its two synthetic scenes, then AP, counts
    zeroed just before and read just after; fails unless the loss falls
    and AP25 passes 0.1;
17. data-parallel training at full width: one ``make_dp_train_step`` step
    on two gloo ranks on the card at the weights (1, 1) and (1, 0)
    against an emulation in this process (each scene's step with that
    rank's assignment, reduced alike: equal bit for bit), then a
    world-size-1 NCCL group's step, equal bit for bit to
    ``make_train_step``'s, then ``tools/train.py:train_dp``
    with 2 ranks for an epoch of 8 scenes with validation on one and a
    resume, each rank's step times printed; then the same for SPFormer
    (``_spformer_loss_fn``, ``make_spformer_train_step``, its config);
18. the self-training loop at full width on 2 bench scenes written in
    ScanNet's layout: ``export_features`` from phase 9's trained weights,
    ``gen_ps --use_deepfeat``, an epoch on the labels it wrote, and the
    test CLI with ``--save_pointwise``, each stage timed;
19-22. the labeler across device lists, raw-data preparation, the
    reference-checkpoint loader, the library functions;
23. the multi-device dry run (``tools/dryrun_dp.py``) at 4 gloo ranks
    sharing the card: every ``ovf_*`` 0 on every rank, the ranks equal bit
    for bit, rank 0's reduction against an emulation within the noise gate;
24. the visualization CLI on the test CLI's exports of 2 full-width
    scenes: the eight tasks in PLY and HTML, point counts, the
    ``instance_pred`` colours against the masks, ``write_ply`` timed;
25. the bf16 conv mode (``GAPRO_CONV_DTYPE=bf16``): K1-bf16 at every
    forward conv shape of the full-width ISBNet, in its level's function,
    against its plain version and fp64 of the bf16 operands, timed beside
    the fp32 K1; the request on the 3 bench scenes and the batch-1 step,
    each held against its fp64 run with the plain bf16 path as the
    yardstick, K1-bf16's drift on the step's activations; the trainer at
    batch 4 for an epoch of 8 scenes; SPFormer's batch-4 step; the
    learning smoke's ISBNet; each beside the fp32 path's time.

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
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 CUDA-core FLOP/s and
# dense TF32 and bf16 tensor-core FLOP/s.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
# The conv kernels take each fp32 product in the split form 3xTF32 (three
# TF32 products: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi): the cost of that form,
# 3 times the function's operations at the TF32 rate, is shown beside their
# bound, which counts the function's own operations.
TF32_PASSES = 3

FULL_SHRINK = (0.67, 0.3, 0.25, 0.25, 0.25, 0.25)
ROUNDS = (192, 128, 64)
N_CAP = 262144
# Float outputs of the kernel path against the plain path: fp32, and the 53
# convs each sum their 27 * Cin products in another order, which compounds
# through the network's depth; 1e-3 of the output's scale.
PATH_RTOL = 1e-3
# One K1 launch against its plain version: 1e-4 of the output's scale; and
# against the same conv in fp64, a root-mean-square error at most
# NOISE_FACTOR times the plain fp32 version's. A sum that drifts one way
# passes the first within 1e-4 and still moves the training step's
# gradients far past the noise run's (PERF.md §6).
K1_RTOL = 1e-4
# K1's mean error against fp64 along the output's sign, in fp32 ulps of the
# output's largest entry, at most this in absolute value at every shape: a
# bias the rms gate lets through reaches every conv of every path. K1
# summed 12 wgmmas in the tensor cores' accumulator, which truncates, and
# drifted by -0.13 to -0.25; with per-k-step sums it read -0.03 to -0.05,
# as dW did; each k-step's truncation is now given back on average
# (csrc/subm_conv.cu: untruncate; PERF.md §6). Held on random inputs at
# every K1 shape and on the activations and gradients of real training
# steps (k1_step_drift). dW (csrc/subm_conv_dw.cu) is held to the same
# bound at every shape (backward_kernel_phase) and at every launch of real
# steps: with per-k-step sums alone it read -0.03 to -0.05 on random inputs
# and -0.08 on the batch-1 step's own, and takes untruncate too.
K1_DRIFT_ULP = 0.06
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
# and a voxel whose loss term sits on a tie of |x| or max(x, 0) flips its
# gradient; either weighs most at the deep levels' few voxels. Runs of each
# path on input colours one ulp away from zero and one ulp towards it
# (``nudged``) measure that spread: a leaf's spread is the larger of the
# two directions' (one direction is a single draw of the ties, which a
# rounding change redraws), and the plain path's own runs find the leaves
# where the reference is the one on a tie, as in the batch-8 backbone step
# (PERF.md §6). Kernels against plain versions must then be no worse than
# NOISE_FACTOR times the kernel path's spread: the largest leaf error, in
# units of the leaf's tolerance, at most NOISE_FACTOR times the largest
# spread (and 1 if that is below 1), and at most NOISE_FACTOR times as
# many leaves over their tolerance as the larger of the two runs' counts.
NOISE_FACTOR = 2.0
# K5 against its plain version: the JAX package's own tolerance for the same
# function summed in another order (tests/test_dyco_pallas.py).
K5_RTOL, K5_ATOL = 2e-5, 2e-4
# K5's launches on the paths: (B, Q, S, items with no valid superpoint,
# what). S is spp_cap; a batch-4 training step, a validation scene (one
# round of n_queries), the three rounds of a request, an item with no valid
# superpoint (as items 2 and 3 of the batch-4 step, ROADMAP.md §3), and a
# ragged shape.
DYCO_SHAPES = ((4, 256, 4096, 0, "training step, batch 4"),
               (1, 256, 4096, 0, "validation scene"),
               (1, 192, 4096, 0, "request round 1"), (1, 128, 4096, 0, "request round 2"),
               (1, 64, 4096, 0, "request round 3"),
               (2, 256, 4096, 1, "item 1 with no valid superpoint"),
               (1, 12, 130, 0, "ragged"))
# The full-size bench scene (tools/bench_model.py), about 240k points.
FULL_SCENE = dict(n_objects=12, points_per_object=15000, n_floor=40000, n_wall=20000)
BATCH = 4  # configs/isbnet_scannetv2.yaml: train.batch_size
TRAIN_SCENES = 16  # four steps of batch 4: one cold, three timed
VAL_SCENES = 2
TEST_SCENES = 2
DATA_WORKERS = 4


# configs/isbnet_scannetv2.yaml as a dict: the card's machine has no PyYAML
# (tests/test_torch_trainer.py holds the two equal).
ISBNET_SCANNETV2 = {
    "model": {"type": "isbnet", "channels": 32, "num_blocks": 7, "instance_classes": 18,
              "semantic_classes": 19, "semantic_only": False, "with_coords": True,
              "filter_bg_thresh": 0.1, "dec_dim": 128, "n_sample_pa1": 2048, "n_queries": 256,
              "radius_scale": 1.0, "neighbor": 32, "mask_dim_out": 32, "spp_cap": 4096},
    "criterion": {"instance_classes": 18, "voxel_scale": 50.0, "trainall": False,
                  "inst_cap": 192},
    "data": {"type": "scannetv2", "data_root": "dataset/scannetv2",
             "label_type": "gaussian_process_kl_pseudo_labels",
             "plan_shrink": [0.67, 0.3, 0.25, 0.25, 0.25, 0.25], "prefix_train": "train",
             "prefix_val": "val", "repeat": 4,
             "voxel": {"scale": 50, "spatial_shape": [128, 512], "max_npoint": 250000,
                       "min_npoint": 5000}},
    "train": {"batch_size": 4, "epochs": 120, "step_epoch": 100, "lr": 0.001,
              "weight_decay": 0.0001, "save_freq": 16, "eval_every": 16, "pretrain": None},
    "test": {"logit_thresh": 0.0, "score_thresh": 0.2, "npoint_thresh": 100,
             "type_nms": "matrix", "topk": 100},
}


# configs/isbnet_backbone_scannetv2.yaml (the backbone pre-training stage,
# semantic_only, batch 8) and configs/spformer_scannetv2.yaml as dicts (held
# equal to the YAML files by tests/test_torch_trainer.py).
ISBNET_BACKBONE_SCANNETV2 = {
    "model": {"type": "isbnet", "channels": 32, "num_blocks": 7, "instance_classes": 18,
              "semantic_classes": 19, "semantic_only": True, "with_coords": True,
              "spp_cap": 4096},
    "criterion": {"instance_classes": 18, "voxel_scale": 50.0, "semantic_only": True,
                  "inst_cap": 192},
    "data": {"type": "scannetv2", "data_root": "dataset/scannetv2",
             "label_type": "gaussian_process_kl_pseudo_labels",
             "plan_shrink": [0.67, 0.3, 0.25, 0.25, 0.25, 0.25], "prefix_train": "train",
             "prefix_val": "val", "repeat": 4,
             "voxel": {"scale": 50, "spatial_shape": [128, 512], "max_npoint": 250000,
                       "min_npoint": 5000}},
    "train": {"batch_size": 8, "epochs": 120, "step_epoch": 100, "lr": 0.001,
              "weight_decay": 0.0001, "save_freq": 16, "eval_every": 16, "pretrain": None},
}
SPFORMER_SCANNETV2 = {
    "model": {"type": "spformer", "media": 32, "blocks": 5, "num_class": 18, "num_layer": 6,
              "num_query": 400, "d_model": 256, "nhead": 8, "hidden_dim": 1024,
              "activation": "gelu", "iter_pred": True, "attn_mask": True, "with_coords": True,
              "spp_cap": 4096},
    "criterion": {"num_class": 18, "non_object_weight": 0.1,
                  "loss_weight": [0.5, 1.0, 1.0, 0.5, 0.2], "cost_weight": [0.5, 1.0, 1.0],
                  "inst_cap": 192},
    "data": {"type": "scannetv2", "data_root": "dataset/scannetv2",
             "label_type": "gaussian_process_kl_pseudo_labels",
             "plan_shrink": [0.67, 0.3, 0.25, 0.25], "prefix_train": "train",
             "prefix_val": "val", "repeat": 1,
             "voxel": {"scale": 50, "spatial_shape": [128, 512], "max_npoint": 250000,
                       "min_npoint": 5000}},
    "train": {"batch_size": 4, "epochs": 512, "step_epoch": 512, "lr": 0.0002,
              "weight_decay": 0.05, "save_freq": 16, "eval_every": 16, "pretrain": None},
    "test": {"topk_insts": 100, "score_thresh": 0.0, "npoint_thresh": 100},
}


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


def device_ms(fn, kernels: tuple, iters: int = 10) -> float:
    """The device time a call of ``fn`` spends in the kernels whose names
    hold one of ``kernels``, from torch.profiler over ``iters`` calls: the
    kernel time without the wrapper's host work (0 if the profiler records
    no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(k in e.name for k in kernels)) / 1e3 / iters


def bound_ms(nbytes: float, ops: float, rate: float = FP32_FLOPS):
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def tc_bounds(nbytes: float, flops: float) -> dict:
    """The bounds of a kernel on the tensor cores (K1, dW, K5) for the
    function's ``flops`` on ``nbytes``: the one it is held to (those
    operations at the TF32 tensor-core rate), and, beside it, fp32 on the
    CUDA cores and the cost of the 3xTF32 form the kernels take (three TF32
    products for each fp32 one)."""
    bms, by = bound_ms(nbytes, flops, TF32_FLOPS)
    return dict(bound=bms, by=by, fp32=bound_ms(nbytes, flops)[0],
                x3=bound_ms(nbytes, TF32_PASSES * flops, TF32_FLOPS)[0])


def spatial_tables(nbr):
    """K1's tables in the grid's own (spatial) row order, to time against
    the mask-sorted order of the plan's ``ConvTables``: ``rows()`` as there."""
    import types

    import torch

    from gapro_tpu_torch.sparse.plan import tile_masks

    order = torch.arange(nbr.shape[0], dtype=torch.int32, device=nbr.device)
    rows = (order, tile_masks(nbr, order))
    return types.SimpleNamespace(rows=lambda: rows)


def computed_slots(masks, cin: int) -> int:
    """The (row, offset) slots K1 computes under the tile masks ``masks``:
    TILE_ROWS rows for every offset its 32-column chunks touch (a chunk
    spans 32 // cin offsets where cin < 32; cin is padded to a multiple of
    8, as the kernel pads it)."""
    from gapro_tpu_torch.sparse.plan import KOFF, TILE_ROWS

    span = max(1, 32 // (-(-cin // 8) * 8))
    groups = masks * 0
    for k in range(KOFF):  # a chunk is live when any of its offsets is
        groups |= ((masks >> k) & 1) << (k // span)
    live = sum(int(((groups >> c) & 1).sum()) for c in range((KOFF + span - 1) // span))
    return TILE_ROWS * span * live


def sass_counts() -> dict:
    """Instructions in the SASS (``cuobjdump -sass``) that show a kernel
    runs as designed: tensor-core instructions in the conv libraries and
    K5's (HGMMA is wgmma, HMMA mma.sync), in K1-bf16's also its copies
    (LDGSTS: cp.async; UTMALDG: TMA) and cluster barriers (its split
    reduction); in the FPS library the cluster barriers
    (CGABAR: barrier.cluster arrive and wait), the stores into other blocks'
    shared memory (STAS: st.async), the mbarrier operations (SYNCS) and the
    GPU-scope memory barriers (MEMBAR.ALL.GPU). Empty where the toolkit has
    no cuobjdump."""
    from gapro_tpu_torch import cuda_build

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = shutil.which("cuobjdump") or (tool if os.path.exists(tool) else None)
    if tool is None:
        return {}
    out = {}
    for name, ops in (("subm_conv", ("HGMMA", "HMMA")),
                      ("subm_conv_bf16", ("HGMMA", "HMMA", "LDGSTS", "UTMALDG", "CGABAR")),
                      ("subm_conv_dw", ("HGMMA", "HMMA")), ("dyco", ("HGMMA", "HMMA")),
                      ("fps", ("CGABAR", "STAS", "SYNCS", "MEMBAR.ALL.GPU"))):
        sass = subprocess.run([tool, "-sass", str(cuda_build.BUILD_DIR / f"lib{name}.so")],
                              capture_output=True, text=True, timeout=120, check=True).stdout
        lines = sass.splitlines()
        out[name] = {op: sum(op in line for line in lines) for op in ops}
    return out


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel wrappers to their plain versions."""
    import torch

    from gapro_tpu_torch.models import dyco
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.sparse import conv

    fp32 = torch.float32
    names = ((conv, "subm_conv_cuda", lambda f, n, w, v, tables: conv.subm_conv(f, n, w, v, fp32)),
             (conv, "subm_conv_bf16_cuda",
              lambda f, n, w, v, tables, window: conv.subm_conv_bf16(f, n, w, v, window)),
             (conv, "subm_conv_dfeats_cuda",
              lambda f, n, w, v, tables: conv.subm_conv(f, n, w, v, fp32)),
             (conv, "subm_conv_dw_cuda", lambda f, n, d, tables: conv.subm_conv_dw(f, n, d)),
             (fps_ops, "fps_cuda", fps_ops.fps_masked),
             (dyco, "dyco_cuda", dyco.dyco_mlp_plain))
    saved = [getattr(mod, name) for mod, name, _ in names]
    for mod, name, plain in names:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), f in zip(names, saved):
            setattr(mod, name, f)


def zero_counts() -> None:
    from gapro_tpu_torch.models import dyco
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.sparse import conv

    for f in (conv.subm_conv_cuda, conv.subm_conv_bf16_cuda, conv.subm_conv_dfeats_cuda,
              conv.subm_conv_dw_cuda, fps_ops.fps_cuda, dyco.dyco_cuda):
        f.launches = 0


def read_counts() -> dict:
    from gapro_tpu_torch.cuda_build import launch_counts

    return launch_counts()


def k1_shape_counts(cfg, caps):
    """(V, Cin, Cout) -> launches per forward of the U-Net in sparse/unet.py."""
    shapes = Counter()
    c = cfg.unet_width
    shapes[(caps[0], 6 if cfg.with_coords else 3, c)] += 1  # input_conv
    for lvl in range(cfg.unet_levels):
        cl = c * (lvl + 1)
        shapes[(caps[lvl], cl, cl)] += 4  # block0, block1
        if lvl < cfg.unet_levels - 1:
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


def instance_diff(a, b, out_a, out_b) -> str:
    """How two instance lists of one request differ, record by record (label,
    points whose mask differs, confidence), beside the discrete decisions
    the float outputs' rounding can flip: voxels whose semantic argmax
    differs and mask logits that change sign."""
    from gapro_tpu_torch.utils.rle import rle_decode

    if same_instances(a, b):
        return f"{len(b)} identical instances"
    diffs = []
    for i, (x, y) in enumerate(zip(a, b)):
        pts = int((rle_decode(x["pred_mask"]) != rle_decode(y["pred_mask"])).sum())
        if pts or x["label_id"] != y["label_id"] or not math.isclose(
                x["conf"], y["conf"], rel_tol=PATH_RTOL, abs_tol=PATH_RTOL):
            diffs.append(f"#{i} label {x['label_id']}/{y['label_id']}, {pts} points, conf "
                         f"{x['conf']:.6g}/{y['conf']:.6g}")
    argmax = int((out_a["semantic_scores"].argmax(1) != out_b["semantic_scores"].argmax(1)).sum())
    signs = int(((out_a["mask_logits"] >= 0) != (out_b["mask_logits"] >= 0)).sum())
    return (f"instance lists of {len(a)} and {len(b)} records differ in {len(diffs)}: "
            + "; ".join(diffs[:6]) + f" (semantic argmax differs at {argmax} voxels, "
            f"{signs} mask logits change sign)")


def same_instances(a, b) -> bool:
    return len(a) == len(b) and all(
        x["label_id"] == y["label_id"] and np.array_equal(x["pred_mask"]["counts"],
                                                          y["pred_mask"]["counts"])
        and math.isclose(x["conf"], y["conf"], rel_tol=PATH_RTOL, abs_tol=PATH_RTOL)
        for x, y in zip(a, b))


# The layer calls of one request timed by ``layer_times``: (module under
# gapro_tpu_torch, function looked up there at call time, the layer's name).
LAYERS = (
    ("models.prepare", "voxelize", "voxelize"),
    ("models.prepare", "build_unet_plan", "build_unet_plan"),
    ("sparse.unet", "subm_conv_auto", "subm_conv_auto"), ("sparse.unet", "down_conv", "down_conv"),
    ("sparse.unet", "inverse_conv", "inverse_conv"), ("ops.fps", "fps", "fps"),
    ("models.aggregator", "ball_query_masked", "ball_query"),
    ("models.isbnet", "dyco_mlp", "dyco_mlp"),
    ("models.inference", "isbnet_postprocess", "isbnet_postprocess"),
    ("models.inference", "rle_encode_rows", "rle_encode_rows"),
)
BALL_QUERY_LAYER = "models.aggregator.ball_query"
GRID_MIN_N = 4 * 8192  # ops/ballquery.py:ball_query_masked takes the grid form from here
# The tiled ball query's layer time in a batch-4 forward before the grid
# form (PERF.md §5, two runs on an NVIDIA H100 80GB HBM3, 700.00 W).
BALL_QUERY_TILED_B4_MS = "313.8 / 315.0"


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

    for mod_name, name, layer in LAYERS:
        mod = importlib.import_module(f"gapro_tpu_torch.{mod_name}")
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, timer(getattr(mod, name), f"{mod_name}.{layer}"))
    try:
        fn()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    return dict(acc)


# The conv kernels and their helpers in a trace: K1 with its B tiling and
# split sum, dW with its split sum, K1-bf16 (paired or unpaired) with its
# prologue.
CONV_KERNELS = {"subm_conv_kernel": "K1", "tile_b_kernel": "K1",
                "subm_conv_sum_splits_kernel": "K1", "subm_conv_dw_kernel": "dW",
                "subm_conv_dw_sum_splits_kernel": "dW", "subm_conv_bf16_kernel": "K1-bf16",
                "subm_conv_bf16_kernel_unpaired": "K1-bf16",
                "subm_conv_bf16_prologue_kernel": "K1-bf16"}
# The kernel a launch of each is counted by (the others are its helpers).
CONV_MAIN = ("subm_conv_kernel", "subm_conv_dw_kernel", "subm_conv_bf16_kernel",
             "subm_conv_bf16_kernel_unpaired")


def kernels_a_call(fn, traces: int = 3):
    """The names of the device kernels one call of ``fn`` launches, from
    the fullest of ``traces`` torch.profiler traces (CPU and CUDA
    activities, as ``profile_request``; a trace may lose events, never add
    one), after a warm call; None where no trace records a kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    best = []
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the demangled name without its namespace, return type and arguments
        names = [re.sub(r"\(.*", "", e.name.replace("(anonymous namespace)::", "")
                        .removeprefix("void ")) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        best = max(best, names, key=len)
    return best or None


def profile_request(fn, what: str, top: int = 12, attempts: int = 3) -> None:
    """Run ``fn`` under torch.profiler and print the device time by kernel,
    the share of its wall time the card was busy, and the conv kernels' time
    and launches. A trace that holds fewer conv launches than the wrappers
    counted lost events, and is taken again, up to ``attempts`` times; if
    the last is still short, that is printed with the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        before = read_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        after = read_counts()
        # device kernels; a named range's span on the device timeline (the
        # optimizer's step, DycoFn.backward) is not a kernel of its own
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        conv_ms, conv_n = Counter(), Counter()
        for e in kern:
            # the demangled name, "void (anonymous namespace)::subm_conv_kernel<64>(...)"
            name = next((w for w in re.findall(r"\w+", e.name) if w in CONV_KERNELS), None)
            if name:
                key = CONV_KERNELS[name]
                conv_ms[key] += e.time_range.elapsed_us() / 1e3
                conv_n[key] += name in CONV_MAIN
        want = {"K1": sum(after[k] - before[k] for k in ("subm_conv", "subm_conv_dfeats")),
                "dW": after["subm_conv_dw"] - before["subm_conv_dw"],
                "K1-bf16": after["subm_conv_bf16"] - before["subm_conv_bf16"]}
        if all(conv_n[k] == n for k, n in want.items()):
            break
        print(f"profile, {what}: the trace holds {dict(conv_n)} conv launches of {want}; "
              + ("taken again" if attempt < attempts else
                 f"still short after {attempts} traces, the conv sums below miss launches"),
              flush=True)
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
    marks = [e for e in prof.events()
             if e.name == "DycoFn.backward" and e.device_type == torch.autograd.DeviceType.CPU]
    if marks:
        def kernels(e):
            return len(e.kernels) + sum(kernels(c) for c in e.cpu_children)
        dyco_us = sum(getattr(e, "device_time_total", None) or e.cuda_time_total for e in marks)
        print(f"profile, {what}: DycoFn.backward (K5's plain recompute) {dyco_us / 1e3:.3f} ms "
              f"of device time in {sum(kernels(e) for e in marks)} kernels, {len(marks)} call(s)",
              flush=True)
    print(f"profile, {what}: K1 (forward and dfeats) {conv_ms['K1']:.3f} ms in {conv_n['K1']} "
          f"launches of subm_conv_kernel, dW {conv_ms['dW']:.3f} ms in {conv_n['dW']} launches of "
          f"subm_conv_dw_kernel"
          + (f", K1-bf16 {conv_ms['K1-bf16']:.3f} ms in {conv_n['K1-bf16']} launches of "
             f"subm_conv_bf16_kernel (paired or unpaired)" if want["K1-bf16"] else "")
          + f" (each with its helper kernels); the wrappers counted {want}", flush=True)


def conv_acc() -> dict:
    """Per-step sums of a conv kernel over its launches at a U-Net's shapes."""
    return dict(ms=0.0, plain_ms=0.0, bound=0.0, fp32=0.0, x3=0.0, bytes_ms=0.0, ops_ms=0.0,
                flops=0.0, err=0.0, fp64=0.0, drift=0.0)


def add_conv(acc: dict, n: int, ms: float, pms: float, nbytes: float, flops: float,
             err: float) -> dict:
    """Adds ``n`` launches of one shape to ``acc``; returns the shape's bounds."""
    bd = tc_bounds(nbytes, flops)
    for key, val in (("ms", ms), ("plain_ms", pms), ("bound", bd["bound"]), ("fp32", bd["fp32"]),
                     ("x3", bd["x3"]), ("flops", flops),
                     ("bytes_ms", nbytes / HBM_BYTES_PER_S * 1e3),
                     ("ops_ms", flops / TF32_FLOPS * 1e3)):
        acc[key] += n * val
    acc["err"] = max(acc["err"], err)
    return bd


def conv_line(key: str, n: int, ms: float, pms: float, bd: dict, flops: float, err: float) -> str:
    return (f"{key} x{n}: kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s), plain {pms:.4f} ms, "
            f"bound {bd['bound']:.4f} ms ({bd['by']}, TF32; fp32 {bd['fp32']:.4f}, 3xTF32 "
            f"{bd['x3']:.4f}), max|err| {err:.3g}")


def conv_step_line(key: str, n: int, a: dict) -> str:
    return (f"{key} per step ({n} launches): kernel {a['ms']:.3f} ms "
            f"({a['flops'] / a['ms'] / 1e9:.2f} TFLOP/s on the pairs that hold a neighbour), "
            f"plain {a['plain_ms']:.3f} ms, bound {a['bound']:.3f} ms (TF32; {a['bound'] / a['ms']:.1%}"
            f" of it reached), fp32 bound {a['fp32']:.3f} ms ({a['fp32'] / a['ms']:.1%}), 3xTF32 "
            f"{a['x3']:.3f} ms ({a['x3'] / a['ms']:.1%})")


def conv_extra(acc: dict, sass) -> dict:
    """The conv kernels' keys of the ``kernels`` line beside the common ones:
    ``bound_ms`` is their TF32 bound; these are the fp32 bound and the cost
    of the 3xTF32 form, the TFLOP/s on the pairs that hold a neighbour, the
    largest ratio of the kernel's rms error against fp64 to the plain fp32
    version's, and the tensor-core instructions of the library's SASS."""
    return dict(bound_fp32_ms=acc["fp32"], bound_3xtf32_ms=acc["x3"],
                tflops=acc["flops"] / acc["ms"] / 1e9, fp64_rms_ratio=acc["fp64"], sass=sass)


def batch4_row_orders(plan, cfg, dev) -> None:
    """K1 forward and dfeats at levels 0 and 1 of a batch-4 plan, in the
    mask-sorted and the spatial row order: at batch 4 level 0's features
    (134 MB at 32 channels) no longer fit the 50 MB L2."""
    import torch

    from gapro_tpu_torch.sparse import conv

    g = torch.Generator().manual_seed(2)
    for lvl in (0, 1):
        lp = plan.levels[lvl]
        valid, nbr = lp.grid.valid, lp.subm_nbr
        c = cfg.channels * (lvl + 1)
        feats = (torch.randn(nbr.shape[0], c, generator=g).to(dev) * valid[:, None]).contiguous()
        w = ((torch.rand(27, c, c, generator=g) * 2 - 1) * math.sqrt(3.0 / (27 * c))).to(dev)
        w_rev = w.flip(0).transpose(1, 2)
        spatial = spatial_tables(nbr)
        nnz = int((nbr >= 0).sum())
        slots = [computed_slots(t.rows()[1], c) / nnz for t in (lp.conv, spatial)]
        fwd = order_times(lambda: conv.subm_conv_cuda(feats, nbr, w, valid, tables=lp.conv),
                          lambda: conv.subm_conv_cuda(feats, nbr, w, valid, tables=spatial))
        dfe = order_times(
            lambda: conv.subm_conv_dfeats_cuda(feats, nbr, w_rev, valid, tables=lp.conv),
            lambda: conv.subm_conv_dfeats_cuda(feats, nbr, w_rev, valid, tables=spatial))
        flops = 2.0 * nnz * c * c
        print(f"batch-{BATCH} row orders, level {lvl} (V={nbr.shape[0]}, {c} -> {c}, {nnz} pairs): "
              f"K1 sorted {fwd[0]:.4f} ms ({flops / fwd[0] / 1e9:.2f} TFLOP/s), spatial "
              f"{fwd[1]:.4f} ms; dfeats sorted {dfe[0]:.4f} ms, spatial {dfe[1]:.4f} ms; slots "
              f"{slots[0]:.2f} sorted, {slots[1]:.2f} spatial", flush=True)


def order_times(run_sorted, run_spatial) -> tuple:
    """K1 in the mask-sorted and in the spatial row order, timed in turns
    (sorted, spatial, spatial, sorted); the mean of each."""
    t = [cuda_ms(f, 10) for f in (run_sorted, run_spatial, run_spatial, run_sorted)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def fp64_drift(got, plain, ref, valid=None, name: str = "K1") -> tuple:
    """A kernel's and the plain fp32 version's distance from the same
    function in fp64 over the entries ``valid`` selects (all by default),
    in fp32 ulps of the output's largest entry: the root mean square, and
    the mean of the error along the sign of the output (a drift towards
    zero is negative). Returns (the kernel's rms, the plain version's rms,
    a summary, the kernel's mean along the sign)."""
    pick = (lambda x: x[valid]) if valid is not None else (lambda x: x.reshape(-1))
    ref = pick(ref)
    ulp = float(ref.abs().max()) * 2.0 ** -23
    rms, along, out = [], [], []
    for label, x in ((name, got), ("plain", plain)):
        e = pick(x).double() - ref
        rms.append(float(e.square().mean().sqrt()) / ulp)
        along.append(float((e * ref.sign()).mean()) / ulp)
        out.append(f"{label} rms {rms[-1]:.3g}, along the sign {along[-1]:+.3g}")
    return rms[0], rms[1], "; ".join(out) + " ulp", along[0]


def k1_phase(cfg, caps, levels, dev, row_orders: bool = True) -> dict:
    """K1 against its plain version at the conv shapes of a full-width
    U-Net (``cfg``: an ISBNet or SPFormer config), timed with its
    bounds, its TFLOP/s on the pairs that hold a neighbour and its computed
    (row, offset) slots over those pairs in both row orders; with
    ``row_orders``, at levels 0 and 1 its time in both orders. Returns the
    per-scene sums."""
    import torch

    from gapro_tpu_torch.sparse import conv

    g = torch.Generator().manual_seed(0)
    k1 = conv_acc()
    print("K1 subm_conv_cuda vs plain (per launch; V, Cin, Cout, launches/scene; slots: the "
          "(row, offset) slots computed over the pairs that hold a neighbour, mask-sorted and "
          "spatial row order):", flush=True)
    for (v, cin, cout), count in sorted(k1_shape_counts(cfg, caps).items()):
        lp = levels[caps.index(v)]
        valid, nbr = lp.grid.valid, lp.subm_nbr
        feats = torch.randn(v, cin, generator=g).to(dev) * valid[:, None]
        b = math.sqrt(3.0 / (27 * cin))
        w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * b).to(dev)
        got = conv.subm_conv_cuda(feats, nbr, w, valid, tables=lp.conv)
        want = conv.subm_conv(feats, nbr, w, valid)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        err = float((got - want).abs().max())
        if err > K1_RTOL * scale:
            fail(f"K1 at V={v} Cin={cin} Cout={cout}: max |err| {err:.3g} > {K1_RTOL} x {scale:.3g}")
        if not bool((got[~valid] == 0).all()):
            fail(f"K1 at V={v}: invalid rows are not exactly 0")
        ref = conv.subm_conv(feats.double(), nbr, w.double(), valid)
        rms, plain_rms, drift, along = fp64_drift(got, want, ref, valid)
        if rms > NOISE_FACTOR * plain_rms:
            fail(f"K1 at V={v} Cin={cin} Cout={cout} is further from fp64 than fp32 is: {drift}")
        if abs(along) > K1_DRIFT_ULP:
            fail(f"K1 at V={v} Cin={cin} Cout={cout} drifts along the output's sign by more "
                 f"than {K1_DRIFT_ULP} ulp against fp64: {drift}")
        k1["fp64"] = max(k1["fp64"], rms / plain_rms)
        k1["drift"] = max(k1["drift"], abs(along))
        spatial = spatial_tables(nbr)
        if not torch.equal(conv.subm_conv_cuda(feats, nbr, w, valid, tables=spatial)[~valid],
                           got[~valid]):
            fail(f"K1 at V={v}: invalid rows differ between the row orders")
        ms = cuda_ms(lambda: conv.subm_conv_cuda(feats, nbr, w, valid, tables=lp.conv), 10)
        pms = cuda_ms(lambda: conv.subm_conv(feats, nbr, w, valid), 5)
        nnz = int((nbr >= 0).sum())
        nbytes = v * 27 * 4 + v * cin * 4 + 27 * cin * cout * 4 + v + v * cout * 4
        flops = 2.0 * nnz * cin * cout
        bd = add_conv(k1, count, ms, pms, nbytes, flops, err)
        slots = [computed_slots(t.rows()[1], cin) / nnz for t in (lp.conv, spatial)]
        line = (f"  V={v:6d} Cin={cin:3d} Cout={cout:3d}; "
                + conv_line("fwd", count, ms, pms, bd, flops, err)
                + f"; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB; slots {slots[0]:.2f} sorted, "
                  f"{slots[1]:.2f} spatial; against fp64: " + drift)
        if row_orders and v in caps[:2]:
            ts, tp = order_times(
                lambda: conv.subm_conv_cuda(feats, nbr, w, valid, tables=lp.conv),
                lambda: conv.subm_conv_cuda(feats, nbr, w, valid, tables=spatial))
            line += f"; row order: sorted {ts:.4f} ms, spatial {tp:.4f} ms"
        print(line, flush=True)
    print(conv_step_line("K1", sum(k1_shape_counts(cfg, caps).values()), k1)
          + f"; against fp64 the mean along the sign at most {k1['drift']:.3g} ulp in "
            f"absolute value (gate {K1_DRIFT_ULP}), rms at most {k1['fp64']:.3g} times the "
            f"plain version's", flush=True)
    return k1


def k1_step_drift(model, prepared, crit, what: str) -> dict:
    """The conv kernels against fp64 on what a real training step feeds
    them: every K1 launch of one step's forward (the activations after
    BatchNorm and ReLU, many of them exact zeros, and the model's weights),
    every dfeats launch of its backward (the step's gradients) and every dW
    launch (those activations against those gradients), each beside the
    plain fp32 version and the fp64 conv on the same inputs. Fails when the
    mean error along the output's sign passes K1_DRIFT_ULP at any launch,
    as ``k1_phase`` and ``backward_kernel_phase`` do on random inputs.
    Returns the largest such mean in absolute value of each kernel."""
    import torch

    from gapro_tpu_torch.sparse import conv

    rows = []
    k1, dfeats, dw = conv.subm_conv_cuda, conv.subm_conv_dfeats_cuda, conv.subm_conv_dw_cuda

    def record(name, a, valid, got, plain, ref):
        if bool(ref.abs().max() > 0):
            rms, plain_rms, drift, along = fp64_drift(got, plain, ref, valid, name)
            zeros = a[valid] if valid is not None else a
            rows.append((name, tuple(got.shape), float((zeros == 0).float().mean()),
                         rms / plain_rms, along, drift))

    def held(kernel, name):
        def run(a, nbr, w, valid, tables):
            got = kernel(a, nbr, w, valid, tables=tables)
            with torch.no_grad():
                record(name, a, valid, got, conv.subm_conv(a, nbr, w, valid),
                       conv.subm_conv(a.double(), nbr, w.double(), valid))
            return got
        run.launches = 0  # the kernel counts its launch here: a check's launch, not the path's
        return run

    def held_dw(a, nbr, dout, tables):
        got = dw(a, nbr, dout, tables=tables)
        with torch.no_grad():
            record("dW", a, None, got, conv.subm_conv_dw(a, nbr, dout),
                   conv.subm_conv_dw(a.double(), nbr, dout.double()))
        return got
    held_dw.launches = 0

    conv.subm_conv_cuda, conv.subm_conv_dfeats_cuda = held(k1, "K1"), held(dfeats, "dfeats")
    conv.subm_conv_dw_cuda = held_dw
    try:
        one_step_grads(model, prepared, crit)
    finally:
        conv.subm_conv_cuda, conv.subm_conv_dfeats_cuda, conv.subm_conv_dw_cuda = k1, dfeats, dw
    torch.cuda.synchronize()
    for name in ("K1", "dfeats", "dW"):
        mine = [r for r in rows if r[0] == name]
        worst = max(mine, key=lambda r: abs(r[4]))
        print(f"{what}, {name} on the step's own inputs against fp64 ({len(mine)} launches, "
              f"{min(r[2] for r in mine):.1%} to {max(r[2] for r in mine):.1%} of the input "
              f"entries exactly 0): the mean along the sign from {min(r[4] for r in mine):+.3g} "
              f"to {max(r[4] for r in mine):+.3g} ulp (gate {K1_DRIFT_ULP}), rms "
              f"{min(r[3] for r in mine):.3g} to {max(r[3] for r in mine):.3g} times the plain "
              f"version's; the furthest at {worst[1]}: {worst[5]}", flush=True)
    for name, shape, _, _, along, drift in rows:
        if abs(along) > K1_DRIFT_ULP:
            fail(f"{what}: {name} at {shape} on the step's own inputs drifts along the output's "
                 f"sign by more than {K1_DRIFT_ULP} ulp against fp64: {drift}")
    return {name: max(abs(r[4]) for r in rows if r[0] == name) for name in ("K1", "dfeats", "dW")}


def backward_kernel_phase(cfg, caps, levels, dev, row_orders: bool = True) -> tuple:
    """The conv's backward at the shapes of a full-width U-Net: dfeats (K1
    on the reversed weights) and dW (``subm_conv_dw.cu``) against
    ``torch.autograd.grad`` of the plain conv, for a random dout; with
    ``row_orders``, dfeats at levels 0 and 1 in both row orders. Returns
    the per-step sums of each."""
    import torch

    from gapro_tpu_torch.sparse import conv

    g = torch.Generator().manual_seed(1)
    acc = {k: conv_acc() for k in ("dfeats", "dw")}
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
        w_rev = w.flip(0).transpose(1, 2)  # as SubmConvFn passes it
        got_df = conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid, tables=lp.conv)
        got_dw = conv.subm_conv_dw_cuda(feats, nbr, dout, tables=lp.conv)
        again = conv.subm_conv_dw_cuda(feats, nbr, dout, tables=lp.conv)
        torch.cuda.synchronize()
        nnz = int((nbr >= 0).sum())
        flops = 2.0 * nnz * cin * cout
        n_df = count - (1 if (v, cin) == stem else 0)  # the stem's input has no gradient
        line = [f"  V={v:6d} Cin={cin:3d} Cout={cout:3d}"]
        for key, got, want, rtol, n, run, plain, nbytes in (
                ("dfeats", got_df, want_df, K1_RTOL, n_df,
                 lambda: conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid, tables=lp.conv),
                 lambda: conv.subm_conv(dout, nbr, w_rev, valid),
                 v * 27 * 4 + v * cout * 4 + 27 * cin * cout * 4 + v + v * cin * 4),
                ("dw", got_dw, want_dw, dw_rtol(v), count,
                 lambda: conv.subm_conv_dw_cuda(feats, nbr, dout, tables=lp.conv),
                 lambda: conv.subm_conv_dw(feats, nbr, dout),
                 v * 27 * 4 + v * cin * 4 + v * cout * 4 + 27 * cin * cout * 4)):
            scale = max(1.0, float(want.abs().max()))
            err = float((got - want).abs().max())
            if err > rtol * scale:
                fail(f"{key} at V={v} Cin={cin} Cout={cout}: max |err| {err:.3g} > "
                     f"{rtol:.3g} x {scale:.3g}")
            ms, pms = cuda_ms(run, 10), cuda_ms(plain, 3)
            bd = add_conv(acc[key], n, ms, pms, nbytes, flops, err)
            line.append(conv_line(key, n, ms, pms, bd, flops, err))
        if not bool((got_df[~valid] == 0).all()):
            fail(f"dfeats at V={v}: invalid rows are not exactly 0")
        if not torch.equal(got_dw, again):
            fail(f"dW at V={v} Cin={cin} Cout={cout} differs between two launches")
        rms, plain_rms, drift, along = fp64_drift(
            got_dw, conv.subm_conv_dw(feats, nbr, dout),
            conv.subm_conv_dw(feats.double(), nbr, dout.double()), name="dW")
        if rms > NOISE_FACTOR * plain_rms:
            fail(f"dW at V={v} Cin={cin} Cout={cout} is further from fp64 than fp32 is: {drift}")
        if abs(along) > K1_DRIFT_ULP:
            fail(f"dW at V={v} Cin={cin} Cout={cout} drifts along the output's sign by more "
                 f"than {K1_DRIFT_ULP} ulp against fp64: {drift}")
        acc["dw"]["fp64"] = max(acc["dw"]["fp64"], rms / plain_rms)
        acc["dw"]["drift"] = max(acc["dw"]["drift"], abs(along))
        line.append("dW against fp64: " + drift)
        if row_orders and v in caps[:2]:
            spatial = spatial_tables(nbr)
            ts, tp = order_times(
                lambda: conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid, tables=lp.conv),
                lambda: conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid, tables=spatial))
            line.append(f"dfeats row order: sorted {ts:.4f} ms, spatial {tp:.4f} ms")
        print("; ".join(line) + f"; {flops / 1e9:.3f} GFLOP; dW bit-identical", flush=True)
    shapes = k1_shape_counts(cfg, caps)
    n = sum(shapes.values())
    for key, count in (("dfeats", n - 1), ("dw", n)):
        print(conv_step_line(key, count, acc[key]), flush=True)
    print(f"dW against fp64 at the {len(shapes)} shapes: rms at most {acc['dw']['fp64']:.3g} "
          f"times the plain fp32 version's (gate {NOISE_FACTOR}); the mean along the sign at "
          f"most {acc['dw']['drift']:.3g} ulp in absolute value (gate {K1_DRIFT_ULP}); "
          f"bit-identical across launches", flush=True)
    return acc["dfeats"], acc["dw"]


def grads_and_stats(model) -> tuple:
    grads = {n: (p.grad.detach().clone() if p.grad is not None else None)
             for n, p in model.named_parameters()}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()}
    return grads, stats


def compare_step(got: tuple, want: tuple, rtols: tuple, what: str, noise=None,
                 want_noise=None, admit_outliers: bool = False, diagnose: bool = False) -> str:
    """Losses, gradients and BatchNorm statistics of one step, each within
    its tolerance in ``rtols`` (losses, gradients, statistics). ``noise``,
    two more runs of ``got``'s path on inputs one ulp away from zero and one
    ulp towards it (``nudged``), sets the gradients' bound as NOISE_FACTOR
    says: a leaf's spread is the larger of the two directions' spreads, the
    noise runs' count of leaves over the tolerance the larger of their two
    counts. Each direction's reading is printed on its own line, with what
    the gate would read from the away direction alone (the old one-sample
    gate's nudge, ``feats * (1 + 2^-23)``, moved every value away from
    zero). ``want_noise``, the same two runs of ``want``'s path, finds the
    leaves where ``want`` is the outlier: one of its own one-ulp runs moves
    the leaf past the tolerance, and ``got`` lies within the tolerance of
    that run. Both readings are printed; with ``admit_outliers`` the gate
    holds those leaves against that run of ``want``'s path instead of
    ``want``, and every other leaf as before. With ``diagnose`` a
    disagreement is printed, not failed: another gate holds the step.
    Returns a summary of the agreement."""
    import torch

    (lg, gg, sg), (lw, gw, sw) = got, want
    loss_rtol, grad_rtol, bn_rtol = rtols
    bad = []
    for k, w in lw.items():
        a, b = float(lg[k]), float(w)
        if not math.isfinite(a) or abs(a - b) > loss_rtol * max(1.0, abs(b)):
            bad.append(f"loss {k} {a:.6g} vs {b:.6g}")
    top = max(float(t.abs().max()) for t in gw.values() if t is not None)

    def dist(x, y, tol):
        return float((x.cpu() - y.cpu()).abs().max()) / tol

    runs = noise or ()
    worst, outliers, spreads, want_over = [], [], [], [0] * len(want_noise or ())
    for k, w in gw.items():
        a = gg[k]
        if (a is None) != (w is None):
            bad.append(f"grad {k}: present in one run only")
            continue
        if w is None:
            continue
        a, w = a.cpu(), w.cpu()
        tol = grad_rtol * float(w.abs().max()) + GRAD_ATOL * top
        err = dist(a, w, tol)
        spreads.append([dist(run[1][k], a, tol) for run in runs])
        if want_noise is not None:
            alt = []
            for i, run in enumerate(want_noise):
                want_spread, err_alt = dist(run[1][k], w, tol), dist(a, run[1][k], tol)
                want_over[i] += want_spread > 1
                if want_spread > 1 and err_alt <= 1 and err > 1:
                    alt.append((err_alt, want_spread))
            if alt:
                outliers.append((k, err, *min(alt), max(spreads[-1], default=0.0)))
        worst.append((err, max(spreads[-1], default=0.0), k))
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
    noise_over = max((sum(sp[i] > 1 for sp in spreads) for i in range(len(runs))), default=0)
    bound = max(1.0, NOISE_FACTOR * noise_max)
    if noise is not None:
        for i, direction in enumerate(NUDGES):
            d_max = max(sp[i] for sp in spreads)
            d_over = sum(sp[i] > 1 for sp in spreads)
            d_bound = max(1.0, NOISE_FACTOR * d_max)
            held = worst[0][0] <= d_bound and over <= NOISE_FACTOR * d_over
            print(f"{what}: the noise run one ulp {direction}: largest spread {d_max:.3g} of the "
                  f"tolerance, {d_over} leaves over it; from it alone the bound would be "
                  f"{d_bound:.3g} and {NOISE_FACTOR * d_over:.0f} leaves allowed over"
                  + (f" (the up-only gate: {'held' if held else 'FAILED'})" if i == 0 else ""),
                  flush=True)
        print(f"{what}: the 8 gradient leaves furthest from agreement, as (error, the larger "
              f"noise spread) over the tolerance: "
              + "; ".join(f"{k} ({e:.3g}, {n:.3g})" for e, n, k in worst[:8]), flush=True)
        print(f"{what}: leaves over the tolerance: {over} of {len(worst)}; the noise runs' "
              f"over it: {noise_over}; largest {worst[0][0]:.3g} against the noise runs' "
              f"{noise_max:.3g} (bound {bound:.3g}, {NOISE_FACTOR * noise_over:.0f} leaves "
              f"allowed over)", flush=True)
    if want_noise is not None:
        print(f"{what}: the second path's own one-ulp runs move {max(want_over)} leaves past the "
              f"tolerance ({' and '.join(f'{n} {d}' for n, d in zip(want_over, NUDGES))}); "
              f"leaves over it where the second path is the outlier (error, error against its "
              f"nearest one-ulp run, that run's spread, the noise runs' spread): "
              + ("; ".join(f"{k} ({e:.3g}, {e2:.3g}, {n2:.3g}, {n:.3g})"
                           for k, e, e2, n2, n in outliers) or "none"), flush=True)
    gate = worst
    if admit_outliers and outliers:
        alt = {k: e2 for k, _, e2, _, _ in outliers}
        gate = sorted(((alt.get(k, e), n, k) for e, n, k in worst), reverse=True)
        print(f"{what}: with those {len(outliers)} leaves held against the second path's "
              f"one-ulp run: {sum(e > 1 for e, _, _ in gate)} over, the largest "
              f"{gate[0][0]:.3g} ({gate[0][2]})", flush=True)
    gate_over = sum(e > 1 for e, _, _ in gate)
    if gate[0][0] > bound or gate_over > NOISE_FACTOR * noise_over:
        bad.append(f"gradients: {gate_over} leaves over their tolerance (the noise runs: "
                   f"{noise_over}), the largest at {gate[0][0]:.3g} of it ({gate[0][2]}; "
                   f"bound {bound:.3g})")
    if bad:
        msg = f"{what}: " + "; ".join(bad[:12]) + (f" (+{len(bad) - 12} more)" if len(bad) > 12
                                                    else "")
        if not diagnose:
            fail(msg)
        print(f"{msg} (the diagnosis: this reading does not gate the step)", flush=True)
    summary = "" if noise is None else f"; the noise runs move {noise_over} leaves past it"
    if bad:
        summary += f"; the noise gate would fail on {len(bad)} entries (a diagnosis)"
    if want_noise is not None:
        summary += f", the second path's {max(want_over)}"
    return (f"losses within {loss_rtol}, {len(worst)} gradient leaves, the furthest at "
            f"{worst[0][0]:.3g} of its tolerance ({worst[0][2]}){summary}, BatchNorm statistics "
            f"within {bn_err:.3g} of scale")


# The whole-step gate's two one-ulp runs: the input colours moved one ulp
# away from zero, and one ulp towards it (``nudged``).
NUDGES = ("away from zero", "towards zero")


def nudged(prepared, direction: str):
    """``prepared`` with its voxel colours one ulp ``direction`` (one of
    NUDGES) by ``torch.nextafter``; an exact 0 stays 0 either way."""
    import torch

    feats = prepared.batch.feats
    target = torch.zeros_like(feats)
    if direction == NUDGES[0]:
        target = torch.where(feats == 0, target, torch.copysign(torch.full_like(feats, math.inf),
                                                                feats))
    return prepared._replace(batch=dataclasses.replace(
        prepared.batch, feats=torch.nextafter(feats, target)))


def one_step_grads(model, prepared, crit, assign=None) -> tuple:
    """Forward, targets, matching, criterion and backward of one training
    step of ISBNet or SPFormer, without the update: (losses, gradients,
    BatchNorm statistics), and the assignment with the matcher's own
    (``assign`` given or not; both None for a semantic_only step)."""
    from gapro_tpu_torch.losses import criterion, spformer_criterion
    from gapro_tpu_torch.models.spformer import SPFormer
    from gapro_tpu_torch.train import step

    spf = isinstance(model, SPFormer)
    model.train()
    loss_fn = step._spformer_loss_fn if spf else step._loss_fn
    loss, (losses, aux) = loss_fn(model, prepared, crit, assign=assign)
    loss.backward()
    own = aux["assign"]
    if assign is not None:
        own = (spformer_criterion.spformer_match_layers(aux["outputs"], aux["targets"], crit)
               if spf else criterion.match(aux["outputs"], aux["targets"]))
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
    need = {"subm_conv": 53, "subm_conv_dfeats": 52, "subm_conv_dw": 53, "fps": 1, "dyco": 1}
    if any(launches[k] < 3 * n for k, n in need.items()):
        fail(f"the training path did not run through the kernels as expected: {launches}, "
             f"need at least {need} per step")
    return dict(launches=launches, again=lambda: one(scenes[1][1]))


def train_plain_compare(make_model, prepared, crit, what: str = "training step, scene 0",
                        admit_outliers: bool = False, fp64: bool = False):
    """One step's losses, gradients and BatchNorm statistics from the same
    initial weights (``make_model()``) through the kernels and through the
    plain versions, every other run given the kernel run's assignment. The
    whole path is held to the kernel path's two 1-ulp noise runs (away from
    zero and towards it) as NOISE_FACTOR says (``compare_step``; with
    ``admit_outliers``, a leaf where one of the plain path's own 1-ulp runs
    crosses the tolerance and the kernels lie within the tolerance of that
    run is held against that run); the backward
    kernels, on a shared K1 forward, to the tolerances themselves. The
    kernel run's gradients and losses must be finite. With ``fp64`` the
    step is held against its fp64 run instead (``fp64_hold``), and the
    noise-run reading is printed beside it as a diagnosis."""
    import torch

    from gapro_tpu_torch.sparse import conv

    kern, assign, _ = one_step_grads(make_model(), prepared, crit)
    noise = [one_step_grads(make_model(), nudged(prepared, d), crit, assign=assign)[0]
             for d in NUDGES]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_kernels():
        plain, _, own = one_step_grads(make_model(), prepared, crit, assign=assign)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    with plain_kernels():
        plain_noise = [one_step_grads(make_model(), nudged(prepared, d), crit, assign=assign)[0]
                       for d in NUDGES]
    k1 = conv.subm_conv_cuda
    with plain_kernels():
        conv.subm_conv_cuda = k1  # put back on leaving plain_kernels
        k1_forward, _, _ = one_step_grads(make_model(), prepared, crit, assign=assign)
    backward = compare_step(kern, k1_forward, PATH_RTOLS,
                            f"{what}, backward kernels vs plain (both through K1)")
    print(f"{what}: the backward kernels agree with their plain versions ({backward})",
          flush=True)
    if fp64:
        # the two-direction reading above stays as the diagnosis; this
        # cell passes or fails on the hold against fp64 below
        summary = compare_step(kern, plain, PATH_RTOLS, f"{what}, kernels vs plain",
                               noise=noise, want_noise=plain_noise,
                               admit_outliers=admit_outliers, diagnose=True)
        hold = fp64_hold(kern, plain, fp64_step(make_model, prepared, crit, assign), what)
        summary += f"; against fp64: {hold['summary']}"
    else:
        summary = compare_step(kern, plain, PATH_RTOLS, f"{what}, kernels vs plain", noise=noise,
                               want_noise=plain_noise, admit_outliers=admit_outliers)
    match = ("no matching (semantic_only)" if assign is None else
             f"{int((assign >= 0).sum())} matched instances; the plain run's own matcher "
             f"{'agreed' if torch.equal(own, assign) else 'DISAGREED'}")
    print(f"{what}: the plain run {plain_ms:.1f} ms; agrees with the kernels ({summary}); "
          f"{match}", flush=True)
    return hold if fp64 else None


# The S3DIS batch-4 step is held against its own fp64 run. Per leaf (a
# loss, a gradient or a BatchNorm statistic) the kernel path's rms error
# against fp64 over the plain path's is its ratio, the floor (FP64_FLOOR of
# the scale: the step's largest |g| for gradients, max(1, |x|) for a loss
# or a statistic, as compare_step's scales; 8 fp32 ulps, a few roundings
# of a value that size) under each error; the plain path's ratio is the
# mirror, its error over the kernel path's. A leaf is over when its ratio
# passes FP64_FACTOR, the factor K1 and K5 are held to against fp64 per
# launch. At the deep levels' few voxels both paths' errors are one
# amplified rounding mode, so a leaf's ratio is a draw either way (the
# first H100 reading: the kernel path 6 leaves over, largest 3.59; the
# plain path 22 over, largest 5.62; PERF.md §6). So the kernel path is held
# as compare_step holds a path to its noise runs, with the plain path's
# mirror as the noise: at most NOISE_FACTOR times as many leaves over as
# the plain path's, and its largest ratio at most NOISE_FACTOR times the
# plain path's largest (and FP64_FACTOR if that is below 1). That step's
# one-ulp runs move 81 leaves by up to 28.6 tolerances, so the noise gate
# there allowed 162 leaves and 57.1 tolerances (PERF.md §6).
FP64_FACTOR = 2.0
FP64_FLOOR = 2.0 ** -20


def to_fp64(prepared):
    """``prepared`` with every floating tensor of it and of its batch in
    float64 (the plan's tables are integers and stay as they are)."""
    import torch

    def cast(v):
        return v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v

    batch = prepared.batch
    batch = dataclasses.replace(batch, **{f.name: cast(getattr(batch, f.name))
                                          for f in dataclasses.fields(batch)})
    return prepared._replace(batch=batch, **{k: cast(v) for k, v in prepared._asdict().items()
                                             if k != "batch"})


def fp64_step(make_model, prepared, crit, assign) -> tuple:
    """One ISBNet step through the plain versions with the model and the
    inputs in float64 on the device, given ``assign``: (losses, gradients,
    statistics) in float64."""
    from gapro_tpu_torch.train import step

    model = make_model().double()
    model.train()
    with plain_kernels():
        loss, (losses, _) = step._loss_fn(model, to_fp64(prepared), crit, assign=assign)
        loss.backward()
    return ({k: float(v.detach()) for k, v in losses.items()}, *grads_and_stats(model))


def fp64_hold(kern: tuple, plain: tuple, ref: tuple, what: str, spread=()) -> dict:
    """Hold each leaf of ``kern`` (losses, gradients, statistics) against
    ``ref``, an fp64 run of the same step, measured by ``plain``'s error
    against ``ref``, as FP64_FACTOR and NOISE_FACTOR say. With ``spread``,
    more runs of the plain path, the kernel path's error is measured by the
    largest of the plain runs', and in the mirror that sets the bounds each
    plain run's by the largest of the kernel path's and the other runs',
    the largest ratio of them a leaf's; NOISE_FACTOR leaves are allowed
    over FP64_FACTOR at least. Prints how many
    leaves each path has over the factor and the largest ratios; fails if
    the kernel path is past its bounds or not finite. Returns the counts and
    the largest ratios."""
    import torch

    (lk, gk, sk), (lp, gp, sp), (lr, gr, sr) = kern, plain, ref
    plains = (plain, *spread)
    top = max((float(t.abs().max()) for t in gr.values() if t is not None), default=0.0)

    def rms(a, b):
        d = (torch.as_tensor(a, dtype=torch.float64).cpu()
             - torch.as_tensor(b, dtype=torch.float64).cpu())
        return float(d.pow(2).mean().sqrt()) if d.numel() else 0.0

    rows = []  # (name, kernel error, plain errors, floor)
    for k, r in lr.items():
        rows.append((f"loss {k}", rms(lk[k], r), [rms(p[0][k], r) for p in plains],
                     FP64_FLOOR * max(1.0, abs(float(r)))))
    for k, r in gr.items():
        if r is None:
            if gk[k] is not None or gp[k] is not None:
                fail(f"{what}: gradient {k} is missing from the fp64 run only")
            continue
        rows.append((f"grad {k}", rms(gk[k], r), [rms(p[1][k], r) for p in plains],
                     FP64_FLOOR * top))
    for k, r in sr.items():
        if r.is_floating_point():
            rows.append((f"stat {k}", rms(sk[k], r), [rms(p[2][k], r) for p in plains],
                         FP64_FLOOR * max(1.0, float(r.abs().max()))))
    if not all(math.isfinite(ek) for _, ek, _, _ in rows):
        fail(f"{what}: a leaf of the kernel path is not finite")
    kr = sorted(((max(ek, fl) / max(*ep, fl), n) for n, ek, ep, fl in rows), reverse=True)
    pr = sorted(((max(max(e, fl) / max(ek, *ep[:j], *ep[j + 1:], fl)
                      for j, e in enumerate(ep)), n) for n, ek, ep, fl in rows), reverse=True)
    k_over = sum(r > FP64_FACTOR for r, _ in kr)
    p_over = sum(r > FP64_FACTOR for r, _ in pr)
    bound = max(FP64_FACTOR, NOISE_FACTOR * pr[0][0])
    # with a spread a leaf counts in the mirror only where one plain run lies
    # FP64_FACTOR times as far from fp64 as the kernel path and every other
    # run: one or two leaves of hundreds, so that a mirror of none is a draw
    allowed = NOISE_FACTOR * max(p_over, 1 if spread else 0)
    print(f"{what}, against fp64: {len(rows)} leaves (rms error, floor {FP64_FLOOR:.3g} of "
          f"scale" + (f"; the plain path's the largest of {len(plains)} runs" if spread else "")
          + f"); over {FP64_FACTOR} times the other path's error: the kernel path "
          f"{k_over}, the plain path {p_over}; largest ratio: the kernel path's {kr[0][0]:.3g} "
          f"({kr[0][1]}), the plain path's {pr[0][0]:.3g} ({pr[0][1]}); the kernel path's "
          f"bound {bound:.3g}, {allowed:.0f} leaves allowed over", flush=True)
    for name, ratios in (("kernel", kr), ("plain", pr)):
        print(f"{what}, against fp64: the 8 largest ratios of the {name} path: "
              + "; ".join(f"{n} {r:.3g}" for r, n in ratios[:8]), flush=True)
    if kr[0][0] > bound or k_over > allowed:
        fail(f"{what}: against fp64 the kernel path has {k_over} leaves over {FP64_FACTOR} "
             f"times the plain path's rms error ({allowed:.0f} allowed), the largest "
             f"{kr[0][0]:.3g} ({kr[0][1]}; bound {bound:.3g})")
    return dict(leaves=len(rows), kernel_over=k_over, plain_over=p_over, largest=kr[0][0],
                largest_leaf=kr[0][1], plain_largest=pr[0][0], bound=bound,
                summary=f"{len(rows)} leaves; {k_over} of the kernel path over {FP64_FACTOR} "
                        f"times the plain path's rms error, the plain path's mirror {p_over}; "
                        f"largest {kr[0][0]:.3g} ({kr[0][1]}) against the bound {bound:.3g}")


class GPLabelled:
    """A dataset whose scenes carry seeded GP labels (``gp_labels``), as the
    pseudo-labelled ScanNet split does."""

    def __init__(self, base):
        self.base = base
        self.voxel_cfg = base.voxel_cfg

    def __len__(self):
        return len(self.base)

    def scan_id(self, index):
        return self.base.scan_id(index)

    def load(self, index):
        scene = self.base.load(index)
        scene.update(gp_labels(index, len(scene["xyz"])))
        return scene


def full_config(epochs: int = 1):
    """``ISBNET_SCANNETV2`` as the trainer reads it, with every voxel kept
    foreground (``filter_bg_thresh`` 0, as in the other phases: untrained
    semantics leave no voxel above 0.1)."""
    from gapro_tpu_torch.train.config import AttrDict

    cfg = AttrDict.wrap(ISBNET_SCANNETV2)  # new dicts and lists all the way down
    cfg.model["filter_bg_thresh"] = 0.0
    cfg.train["epochs"] = epochs
    return cfg


# K4 before its cluster design (PERF.md §6, two runs on an NVIDIA H100 80GB
# HBM3, 700.00 W): ms a scene in 4 launches, and in a profiled batch-4 step.
K4_BEFORE_SCENE_MS = "6.665 / 6.640"
K4_BEFORE_B4_MS = "22.0 / 22.0"


@contextlib.contextmanager
def capture(mod, name: str, calls: list):
    """Record the positional arguments of every call of ``mod.name``. A
    kernel's wrapper counts its launches on the name it is called by, so
    the recorder carries its own ``launches``: the path's counts stay as
    they were."""
    f = getattr(mod, name)

    def recorded(*args, **kwargs):
        calls.append(args)
        return f(*args, **kwargs)

    recorded.launches = 0
    setattr(mod, name, recorded)
    try:
        yield
    finally:
        setattr(mod, name, f)


# The GP labeler against another run of it (the card against the CPU, or the
# port against the JAX package). 50 fp32 Adam steps amplify rounding, so:
# the fits' start (ELBO and gradients at the initial parameters) is held
# against fp64 as K1 is, within NOISE_FACTOR of the plain CPU run's error;
# after the 50 steps, mu and var within `bound` x (FIT_ATOL + FIT_RTOL *
# |other|), the cross-implementation bound of tests/test_parity_gp.py:90-91
# (`bound` 1, as the CPU tests hold the port against JAX and gate (a) holds
# that file's six cases, PARITY_FIT_BOUND). On bench.py's scenes the fit's own
# spread is larger than that: a one-ulp change of the pooled features moves
# the card's mu and var by 1.4595 of it, and the card against the CPU came to
# 1.5636, while the same fits with TF32 products inside the 50 steps came to
# 2.4191 (H100, PERF.md §6). LABELER_FIT_BOUND sits between the two, and each
# run repeats that TF32 control and fails if it passes the bound. On the
# superpoints a fit decides, at most LABEL_FLIP_RATE of the labels that are
# confident on both sides (conf >= LABEL_CONF) may differ
# (tests/test_parity_gp.py:146); everything else is identical.
FIT_ATOL = FIT_RTOL = 0.05
LABELER_FIT_BOUND = 2.0
PARITY_FIT_BOUND = 1.0
LABEL_CONF = 0.6
LABEL_FLIP_RATE = 0.05


@contextlib.contextmanager
def record_fits(pipeline, out: dict):
    """Record the job list of every window a labeler pipeline module fits
    (``out["jobs"]``) and each window's per-job (probs, probs_new, labels,
    mu, var) (``out["fits"]``), in order."""
    submit, fetch = pipeline._fit_jobs_submit, pipeline._fit_jobs_fetch
    out.setdefault("jobs", [])
    out.setdefault("fits", [])

    def rec_submit(jobs, *args, **kwargs):
        out["jobs"].append(list(jobs))
        return submit(jobs, *args, **kwargs)

    def rec_fetch(*args, **kwargs):
        res = fetch(*args, **kwargs)
        out["fits"].append(res)
        return res

    pipeline._fit_jobs_submit, pipeline._fit_jobs_fetch = rec_submit, rec_fetch
    try:
        yield out
    finally:
        pipeline._fit_jobs_submit, pipeline._fit_jobs_fetch = submit, fetch


def fit_ratio(fits_a, fits_b) -> float:
    """The largest |a - b| / (FIT_ATOL + FIT_RTOL |b|) of the fits' mu and
    var (per-job tuples), inf if a value is not finite."""
    worst = 0.0
    for ra, rb in zip(fits_a, fits_b):
        for k in (3, 4):
            if not (np.isfinite(ra[k]).all() and np.isfinite(rb[k]).all()):
                return math.inf
            if len(ra[k]):
                lim = FIT_ATOL + FIT_RTOL * np.abs(rb[k])
                worst = max(worst, float(np.max(np.abs(ra[k] - rb[k]) / lim)))
    return worst


def _per_spp(values, inverse):
    out = np.zeros(int(inverse.max()) + 1 if inverse.size else 0, values.dtype)
    out[inverse] = values
    return out


def labeler_gate(a: dict, b: dict, window: int, bound: float = 1.0) -> tuple:
    """Hold labeler run ``a`` against run ``b`` (each ``record_fits``'
    record plus ``labels``, the per-scene label tuples): job lists
    identical; fits within ``bound`` x (FIT_ATOL + FIT_RTOL |b|); every point of a
    superpoint no fit decides with identical sem, inst and prob; on the
    superpoints a fit decides, the flip rate of labels confident on both
    sides at most LABEL_FLIP_RATE. Returns (numbers, violations)."""
    bad = []
    if len(a["jobs"]) != len(b["jobs"]):
        bad.append(f"{len(a['jobs'])} against {len(b['jobs'])} fitted windows")
    for w, (ja, jb) in enumerate(zip(a["jobs"], b["jobs"])):
        same = len(ja) == len(jb) and all(
            (x.b1, x.b2, x.scene) == (y.b1, y.b2, y.scene)
            and all(np.array_equal(getattr(x, f), getattr(y, f))
                    for f in ("b1_inds", "b2_inds", "intersect_inds"))
            for x, y in zip(ja, jb))
        if not same:
            bad.append(f"window {w}: the job lists differ")
    ratio = max((fit_ratio(fa, fb) for fa, fb in zip(a["fits"], b["fits"])), default=0.0)
    if not ratio <= bound:
        bad.append(f"fits differ by {ratio:.3f} of FIT_ATOL + FIT_RTOL |mu, var| (at most "
                   f"{bound:.3f})")
    n_conf = n_flip = n_pts_gp = 0
    for s, (la, lb) in enumerate(zip(a["labels"], b["labels"])):
        inv = la[5]
        gp = np.zeros(int(inv.max()) + 1, bool)
        for job in a["jobs"][s // window] if s // window < len(a["jobs"]) else []:
            if job.scene == s % window:
                gp[job.intersect_inds] = True
        rest = ~gp[inv]
        n_pts_gp += int((~rest).sum())
        for k, name in ((0, "sem"), (1, "inst"), (2, "prob")):
            if not np.array_equal(la[k][rest], lb[k][rest]):
                bad.append(f"scene {s}: {name} differs on a point no fit decides")
        conf = ((_per_spp(la[2], inv) >= LABEL_CONF) & (_per_spp(lb[2], inv) >= LABEL_CONF)
                & gp)
        n_conf += int(conf.sum())
        n_flip += int((conf & ((_per_spp(la[1], inv) != _per_spp(lb[1], inv))
                               | (_per_spp(la[0], inv) != _per_spp(lb[0], inv)))).sum())
    flip_rate = n_flip / max(n_conf, 1)
    if flip_rate > LABEL_FLIP_RATE:
        bad.append(f"{n_flip} of {n_conf} confident fitted superpoints flip "
                   f"({flip_rate:.4f} > {LABEL_FLIP_RATE})")
    return dict(jobs=sum(len(j) for j in a["jobs"]), fit_ratio=ratio, fit_bound=bound,
                confident=n_conf, flips=n_flip, flip_rate=flip_rate, gp_points=n_pts_gp), bad


# The labeler sweep of bench.py: its presets (bench.py:53-57), 16 scenes,
# window 4, LabelerConfig() (50 Adam steps at lr 0.1, 128 inducing points,
# at most 512 train and 1024 test rows a fit). Nothing is cut.
LABELER_PRESETS = {
    "default": dict(n_objects=12, points_per_object=4000, n_floor=30000, n_wall=16000),
    "real": dict(n_objects=24, points_per_object=4500, n_floor=25000, n_wall=12000)}
LABELER_SCENES = 16
LABELER_WINDOW = 4
LABELER_PASSES = 3  # timed passes after one warm pass


def labeler_inputs(scene) -> dict:
    """``submit_scene``'s arguments for a synthetic scene, as bench.py's
    ``scene_inputs``: boxes from the instances, xyz + rgb features."""
    from gapro_tpu_torch.labeler import instance_info

    _, cls, boxes, vols, _ = instance_info(scene.xyz, scene.instance_label,
                                           scene.semantic_label, with_corners=False)
    return dict(coords=scene.xyz, gp_feats=np.concatenate([scene.xyz, scene.rgb], 1),
                spp=scene.spp, instance_cls=cls, instance_box=boxes, instance_box_volume=vols)


def labeler_sweep(scenes, device, window: int = LABELER_WINDOW) -> tuple:
    """One pass of the stream over ``scenes`` (box derivation included, as in
    bench.py). Returns (label tuples, seconds)."""
    from gapro_tpu_torch.labeler import LabelerConfig, generate_scene_labels_stream

    t0 = time.perf_counter()
    labels = [out for _, out in generate_scene_labels_stream(
        (labeler_inputs(s) for s in scenes), LabelerConfig(), window=window, device=device)]
    return labels, time.perf_counter() - t0


def same_labels(a: list, b: list) -> bool:
    return len(a) == len(b) and all(
        len(x) == len(y) and all(u.dtype == v.dtype and np.array_equal(u, v) for u, v in zip(x, y))
        for x, y in zip(a, b))


def labeler_window(scenes, device):
    """One window's jobs and pooled features, as the stream builds them."""
    from gapro_tpu_torch.labeler import LabelerConfig
    from gapro_tpu_torch.labeler import pipeline as lp

    cfg = LabelerConfig()
    res = [lp.enumerate_scene(lp.submit_scene(cfg=cfg, device=device, **labeler_inputs(s)), cfg)
           for s in scenes]
    return [j._replace(scene=si) for si, r in enumerate(res) for j in r.jobs], \
        [r.feats_spp for r in res]


def one_ulp_up(t):
    import torch

    return torch.nextafter(t, torch.full_like(t, math.inf))


@contextlib.contextmanager
def tf32_fits():
    """The control of gate (a): the fits with TF32 products inside their 50
    steps (``fit_numerics`` replaced by one that turns TF32 on)."""
    import torch

    from gapro_tpu_torch.gp import variational as tv

    keep = tv.fit_numerics

    @contextlib.contextmanager
    def tf32():
        m = torch.backends.cuda.matmul
        prev, m.allow_tf32 = m.allow_tf32, True
        try:
            yield
        finally:
            m.allow_tf32 = prev

    tv.fit_numerics = tf32
    try:
        yield
    finally:
        tv.fit_numerics = keep


# tests/test_parity_gp.py's problems (its _problem and CASES, copied: that
# file imports JAX): two labeled clusters in 6 dims and queries between them
PARITY_CASES = [dict(seed=0), dict(seed=1, n1=12, n2=90, sep=0.8), dict(seed=2, aniso=True),
                dict(seed=3, n1=80, n2=80, sep=2.5),
                dict(seed=4, aniso=True, n1=25, n2=120, sep=0.6), dict(seed=5, n1=5, n2=7, q=4)]


def parity_problem(seed, n1=40, n2=50, q=30, d=6, aniso=False, sep=1.2):
    rng = np.random.default_rng(seed)
    c1 = rng.normal(size=d).astype(np.float32)
    c2 = c1 + (sep * rng.normal(size=d) / np.sqrt(d)).astype(np.float32)
    scale = np.ones(d, np.float32)
    if aniso:
        scale[0] = 8.0
    x1 = c1 + rng.normal(size=(n1, d)).astype(np.float32) * 0.3 * scale
    x2 = c2 + rng.normal(size=(n2, d)).astype(np.float32) * 0.3 * scale
    tx = np.concatenate([x1, x2]).astype(np.float32)
    ty = np.concatenate([-np.ones(n1), np.ones(n2)]).astype(np.float32)
    qx = 0.5 * (c1 + c2) + rng.normal(size=(q, d)).astype(np.float32) * 0.4 * scale
    return tx, ty, qx.astype(np.float32)


def parity_batch():
    """PARITY_CASES as lanes of one padded batch: (tx, ty, tm, qx, qm)."""
    probs = [parity_problem(**c) for c in PARITY_CASES]
    b, t, q = len(probs), max(len(p[0]) for p in probs), max(len(p[2]) for p in probs)
    d = probs[0][0].shape[1]
    tx, ty, tm = np.zeros((b, t, d), np.float32), np.ones((b, t), np.float32), np.zeros((b, t), bool)
    qx, qm = np.zeros((b, q, d), np.float32), np.zeros((b, q), bool)
    for i, (x, y, z) in enumerate(probs):
        tx[i, :len(x)], ty[i, :len(x)], tm[i, :len(x)] = x, y, True
        qx[i, :len(z)], qm[i, :len(z)] = z, True
    return tx, ty, tm, qx, qm


def parity_fits(device, up: bool = False) -> list:
    """PARITY_CASES' 50-step fits on ``device`` (inputs one ulp up with
    ``up``), per lane (probs, probs_new, labels, mu, var) on its queries."""
    import torch

    from gapro_tpu_torch.gp import fit_gp_batch

    tx, ty, tm, qx, qm = (torch.from_numpy(a).to(device) for a in parity_batch())
    if up:
        tx, qx = one_ulp_up(tx), one_ulp_up(qx)
    res = fit_gp_batch(tx, ty, tm, qx, qm, 50, 0.1, None)
    keep = qm.cpu().numpy()
    return [tuple(getattr(res, f)[i].cpu().numpy()[keep[i]]
                  for f in ("probs", "probs_new", "labels", "mu", "var"))
            for i in range(len(keep))]


def labeler_parity(dev) -> dict:
    """PARITY_CASES, card against the port on the CPU, in units of FIT_ATOL
    + FIT_RTOL |CPU|: ``card_cpu`` (gated at PARITY_FIT_BOUND), the one-ulp
    noise runs ``card_ulp`` and ``cpu_ulp``, and ``tf32``, the control on
    the card."""
    cpu = parity_fits("cpu")
    card = parity_fits(dev)
    with tf32_fits():
        tf32 = parity_fits(dev)
    return dict(card_cpu=fit_ratio(card, cpu), card_ulp=fit_ratio(parity_fits(dev, up=True), card),
                cpu_ulp=fit_ratio(parity_fits("cpu", up=True), cpu), tf32=fit_ratio(tf32, cpu))


def labeler_first_step(scenes, dev) -> dict:
    """The fits' start, before 50 Adam steps amplify rounding: each fit
    group's ELBO and its gradient at the initial parameters, on the card in
    fp32, on the CPU in fp32 and in fp64, for one window. Returns, per
    quantity, the card's rms error against fp64 over the CPU fp32 run's (the
    gate: at most NOISE_FACTOR, as K1's against fp64)."""
    import torch

    from gapro_tpu_torch.gp import variational as tv
    from gapro_tpu_torch.labeler import LabelerConfig
    from gapro_tpu_torch.labeler import pipeline as lp

    cfg = LabelerConfig()
    jobs, feats = labeler_window(scenes, "cpu")
    flat = torch.cat(feats)
    offsets = np.cumsum([0] + [f.shape[0] for f in feats])
    names = ("elbo",) + tv.GPParams._fields
    sq = {k: np.zeros(2) for k in names}  # squared error: card, CPU fp32

    def start(ibuf, tb, device, dtype):
        tx, ty, tm, _, _ = lp._gather_rows(torch.from_numpy(ibuf).to(device),
                                           flat.to(device, dtype), tb)
        m = min(cfg.n_inducing, tb)
        with tv.fit_numerics():
            leaves = [p.to(dtype).requires_grad_(True) for p in tv.init_params(tx[:, :m])]
            e = tv.elbo(tv.GPParams(*leaves), tm[:, :m], tx, ty.to(dtype), tm)
            grads = torch.autograd.grad(-e.sum(), leaves)
        return [x.detach().cpu().double().numpy() for x in (e, *grads)]

    for (tb, qb), idxs in lp._job_buckets(jobs, cfg).items():
        ibuf = lp._group_index(jobs, idxs, tb, qb, offsets)
        ref = start(ibuf, tb, "cpu", torch.float64)
        for col, got in enumerate((start(ibuf, tb, dev, torch.float32),
                                   start(ibuf, tb, "cpu", torch.float32))):
            for k, g, r in zip(names, got, ref):
                sq[k][col] += float(np.sum((g - r) ** 2))
    # a gradient that is exactly 0 at the start (the inducing points and the
    # lengthscale: with S = I the predictions do not depend on them) must
    # stay exactly 0 on the card
    return {k: (0.0 if v[0] == 0 else math.inf if v[1] == 0 else math.sqrt(v[0] / v[1]))
            for k, v in sq.items()}


def labeler_group_profile(scenes, dev) -> None:
    """The largest fit group of one window alone: kernels an Adam step (the
    kernel count of 2 steps less that of 1), and its device time against its
    wall time at 50 steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gapro_tpu_torch.labeler import LabelerConfig
    from gapro_tpu_torch.labeler import pipeline as lp

    cfg = LabelerConfig()
    jobs, feats = labeler_window(scenes, dev)
    (tb, qb), idxs = max(lp._job_buckets(jobs, cfg).items(), key=lambda kv: len(kv[1]))
    group = [jobs[j] for j in idxs]

    def traced(c):
        lp._fit_jobs_fetch(lp._fit_jobs_submit(group, feats, c))  # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lp._fit_jobs_fetch(lp._fit_jobs_submit(group, feats, c))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith(("Memcpy", "Memset"))]
        return len(kern), sum(e.time_range.elapsed_us() for e in kern) / 1e3, wall

    n1 = traced(dataclasses.replace(cfg, training_iter=1))[0]
    n2 = traced(dataclasses.replace(cfg, training_iter=2))[0]
    n50, dev_ms, wall_ms = traced(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lp._fit_jobs_fetch(lp._fit_jobs_submit(group, feats, cfg))
    untraced = (time.perf_counter() - t0) * 1e3
    print(f"labeler fit group (tb, qb, B) = ({tb}, {qb}, {lp.next_bucket(len(group), min_size=4)}),"
          f" {len(group)} jobs: {n2 - n1} kernels an Adam step ({n50} at {cfg.training_iter} "
          f"steps); traced: device {dev_ms:.3f} ms against wall {wall_ms:.3f} ms (busy "
          f"{dev_ms / wall_ms:.1%}); untraced wall {untraced:.3f} ms, {untraced / cfg.training_iter:.3f}"
          f" ms a step", flush=True)


def labeler_phase(dev) -> dict:
    """GaPro's stage 1 on the card: the GP labeler's stream over bench.py's
    sweep (see LABELER_PRESETS), with its gates. Returns its numbers."""
    import torch

    from gapro_tpu_torch.data import make_synthetic_scene
    from gapro_tpu_torch.labeler import LabelerConfig
    from gapro_tpu_torch.labeler import pipeline as lp

    t_phase = time.perf_counter()
    spent = {}  # seconds of each part of the phase

    def mark(part: str) -> None:
        spent[part] = time.perf_counter() - t_phase - sum(spent.values())

    scenes = [make_synthetic_scene(seed=s, **LABELER_PRESETS["default"])
              for s in range(LABELER_SCENES)]
    n_boxes = [len(labeler_inputs(s)["instance_box"]) + 1 for s in scenes]  # + the floor
    print("labeler, default preset: points a scene "
          f"{sorted({len(s.xyz) for s in scenes})}, boxes (with the floor) {n_boxes}, "
          f"superpoints {[int(s.spp.max()) + 1 for s in scenes]}", flush=True)

    # warm pass, its fits recorded: gate (a)'s card side and the groups
    lp.reset_overflow_stats()
    with record_fits(lp, {}) as card:
        card["labels"], sec = labeler_sweep(scenes, dev)
    jobs_per_scene = [sum(j.scene == i for j in w) for w in card["jobs"]
                      for i in range(LABELER_WINDOW)]
    groups = [[(tb, qb, lp.next_bucket(len(ix), min_size=4))
               for (tb, qb), ix in lp._job_buckets(w, lp.LabelerConfig()).items()]
              for w in card["jobs"]]
    mark("scenes and warm pass")
    print(f"labeler warm pass: {LABELER_SCENES / sec:.3f} scenes/s; jobs a scene "
          f"{jobs_per_scene}; fit groups (tb, qb, B) by window {groups}", flush=True)

    # gate (c): finite wherever a fit wrote, and every fit finite
    for s, out in enumerate(card["labels"]):
        if not (np.isfinite(out[3]).all() and np.isfinite(out[4]).all()):
            fail(f"labeler gate (c): scene {s}'s mu or var is not finite")
    if any(not np.isfinite(r[k]).all() for w in card["fits"] for r in w for k in (0, 3, 4)):
        fail("labeler gate (c): a fit's probs, mu or var is not finite")

    # timed passes; the kernels of K1-K6 are counted (none runs on this path)
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    rates, passes = [], []
    for p in range(LABELER_PASSES):
        lp.reset_overflow_stats()
        labels, sec = labeler_sweep(scenes, dev)
        rates.append(LABELER_SCENES / sec)
        passes.append(labels)
        print(f"labeler pass {p + 1}/{LABELER_PASSES}: {sec:.3f} s = {rates[-1]:.3f} scenes/s | "
              + " ".join(f"{k}={v:.4f}" for k, v in lp.PHASE_STATS.items())
              + f" | {lp.OVERFLOW_STATS}", flush=True)
    launches = read_counts()
    mark("timed passes")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"labeler, default preset: scenes/s median {statistics.median(rates):.3f}, best "
          f"{max(rates):.3f}; peak device memory {peak:.3f} GiB above what the earlier phases "
          f"hold; launches of the port's kernels in the timed passes {launches} (the labeler "
          "has none)", flush=True)

    # gate (b): two card passes bit for bit, and a third with the caller's
    # TF32 on (the fit turns it off for its products; the labels must not move)
    if not same_labels(card["labels"], passes[0]):
        fail("labeler gate (b): two card passes differ")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_labels, _ = labeler_sweep(scenes, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if not same_labels(passes[0], tf32_labels):
        fail("labeler gate (b): a pass with the caller's TF32 on differs from one with it off")
    mark("gate (b): a pass with TF32 on")
    print("labeler gate (b): the warm pass, timed pass 1 and a pass with the caller's "
          "torch.backends.cuda.matmul.allow_tf32 on are identical bit for bit (sem, inst, prob, "
          "mu, var)", flush=True)

    # gate (a): scenes 0-3 as one window, card against the port on the CPU;
    # the CPU side on one thread, so that its sums take one order on every run
    # (PyTorch's CPU reductions split them by the thread team)
    cfg = LabelerConfig()
    window0 = scenes[:LABELER_WINDOW]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _, feats_card = labeler_window(window0, dev)
        _, feats_cpu = labeler_window(window0, "cpu")
        if not all(torch.equal(a.cpu(), b) for a, b in zip(feats_card, feats_cpu)):
            fail("labeler gate (a): the pooled features differ between the card and the CPU")
        first = labeler_first_step(window0, dev)
        if not all(v <= NOISE_FACTOR for v in first.values()):
            fail(f"labeler gate (a): the fits' start on the card against fp64, over the CPU fp32 "
                 f"run's error: {first}")
        mark("gate (a): features and the fits' start")
        with record_fits(lp, {}) as cpu:
            cpu["labels"], cpu_sec = labeler_sweep(window0, "cpu")
        mark("gate (a): the CPU window")
        parity = labeler_parity(dev)
    finally:
        torch.set_num_threads(threads)
    jobs0 = card["jobs"][0]
    noise = fit_ratio(lp._fit_jobs_batched(jobs0, [one_ulp_up(f) for f in feats_card], cfg),
                      card["fits"][0])
    with tf32_fits():
        control = fit_ratio(lp._fit_jobs_batched(jobs0, feats_card, cfg), cpu["fits"][0])
    numbers, bad = labeler_gate(
        dict(jobs=card["jobs"][:1], fits=card["fits"][:1], labels=card["labels"][:LABELER_WINDOW]),
        cpu, LABELER_WINDOW, bound=LABELER_FIT_BOUND)
    print(f"labeler gate (a): scenes 0-{LABELER_WINDOW - 1}, card against the CPU ({cpu_sec:.2f} s "
          f"there, one thread): pooled features identical; the fits' start against fp64 at "
          + ", ".join(f"{k} {v:.3f}" for k, v in first.items())
          + f" of the CPU fp32 run's rms error; {numbers['jobs']} identical jobs; after "
          f"{cfg.training_iter} steps, in units of FIT_ATOL + FIT_RTOL |CPU|: mu and var at "
          f"{numbers['fit_ratio']:.4f} (bound {LABELER_FIT_BOUND}; the card's one-ulp noise run "
          f"{noise:.4f}; the TF32 control {control:.4f}); {numbers['flips']} of "
          f"{numbers['confident']} confident fitted superpoints flip; every other point identical",
          flush=True)
    print("labeler gate (a): tests/test_parity_gp.py's six cases as lanes of one batch, card "
          f"against the CPU {parity['card_cpu']:.4f} (bound {PARITY_FIT_BOUND}); one-ulp noise "
          f"runs: card {parity['card_ulp']:.4f}, CPU {parity['cpu_ulp']:.4f}; the TF32 control "
          f"{parity['tf32']:.4f}", flush=True)
    if not parity["card_cpu"] <= PARITY_FIT_BOUND:
        bad.append(f"tests/test_parity_gp.py's cases differ by {parity['card_cpu']:.4f} "
                   f"(at most {PARITY_FIT_BOUND})")
    if bad:
        fail(f"labeler gate (a), card against CPU: {bad} ({numbers}, {parity})")
    if not control > LABELER_FIT_BOUND:
        fail(f"labeler gate (a): the TF32 control passes the bound ({control:.4f}, at most "
             f"{LABELER_FIT_BOUND}): the gate cannot tell it from a sound fit")
    mark("gate (a): parity cases, noise, control, check")

    # the "real" preset, one pass
    real = [make_synthetic_scene(seed=s, **LABELER_PRESETS["real"]) for s in range(LABELER_SCENES)]
    lp.reset_overflow_stats()
    _, sec = labeler_sweep(real, dev)
    real_rate = LABELER_SCENES / sec
    mark("real preset")
    print(f"labeler, real preset ({len(real[0].xyz)} points a scene), one pass: {sec:.3f} s = "
          f"{real_rate:.3f} scenes/s | "
          + " ".join(f"{k}={v:.4f}" for k, v in lp.PHASE_STATS.items())
          + f" | {lp.OVERFLOW_STATS}", flush=True)

    # where the time goes
    profile_request(lambda: labeler_sweep(window0, dev),
                    f"labeler, one window ({LABELER_WINDOW} default-preset scenes)")
    labeler_group_profile(window0, dev)
    mark("profiles")
    print(f"labeler phase: {time.perf_counter() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")", flush=True)
    return dict(rates=rates, real_rate=real_rate, peak_gib=peak)


def k4_case(xyz, valid, n_sample: int, what: str) -> dict:
    """K4 against its plain version on one input, bit for bit, timed (the
    wrapper: compaction, the kernel, the map back) with its bound; prints
    the cluster it launched and its time a step."""
    import torch

    from gapro_tpu_torch.ops import fps as fps_ops

    b, n, _ = xyz.shape
    got = fps_ops.fps_cuda(xyz, valid, n_sample)
    want = fps_ops.fps_masked(xyz, valid, n_sample)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        nd = int((got[0] != want[0]).sum())
        fail(f"K4, {what} (B={b}, N={n}, n={n_sample}): {nd} indices differ from the plain version")
    ms = cuda_ms(lambda: fps_ops.fps_cuda(xyz, valid, n_sample), 5)
    cms = cuda_ms(lambda: fps_ops.compact_valid(xyz, valid), 20)
    cxyz, _, count = fps_ops.compact_valid(xyz, valid)
    kms = cuda_ms(lambda: fps_ops._launch_compacted(cxyz, count, n_sample), 20)
    pms = cuda_ms(lambda: fps_ops.fps_masked(xyz, valid, n_sample), 1)
    counts = valid.sum(1).tolist()
    shape = fps_ops.launch_shape(n)
    fit = fps_ops._max_active_clusters(n)
    if fit < b:
        fail(f"K4, {what}: {b} clusters of {shape['cluster']} blocks, only {fit} fit at once")
    nbytes = b * (n * 12 + n + n_sample * 4)
    ops = 10.0 * sum(counts) * (n_sample - 1)  # 3 sub, 3 mul, 2 add, min, compare
    bms, by = bound_ms(nbytes, ops)
    spill = [max(c - shape["on_chip"], 0) for c in counts]
    print(f"  {what}: B={b} N={n} n={n_sample}, valid {counts}; clusters of {shape['cluster']} "
          f"blocks, {b * shape['cluster']} blocks ({fit} such clusters fit at once), "
          f"{shape['on_chip']} points on chip an item, past it {spill}; wrapper {ms:.4f} ms: "
          f"compaction {cms:.4f} ms, the kernel alone {kms:.4f} ms "
          f"({kms * 1e3 / max(n_sample - 1, 1):.3f} us a step), the map back and launches "
          f"{ms - cms - kms:.4f} ms; plain {pms:.4f} ms, bound {bms:.5f} ms ({by}; the wrapper "
          f"{ms / bms:.1f}x it), indices equal", flush=True)
    return dict(ms=ms, kernel_ms=kms, compact_ms=cms, plain_ms=pms, bound=bms,
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3, ops_ms=ops / FP32_FLOPS * 1e3,
                cluster=shape["cluster"], idx=got[0])


def k4_phase(prep0, cfg, dev) -> dict:
    """K4 at a request's shapes (N = 262144 -> 2048 on scene 0's voxels,
    then N = 2048 -> 192 / 128 / 64 on those samples), and on one item of
    N = 1048576 whose valid points exceed what a cluster holds on chip
    (n = 64, to keep the plain run short). Returns the per-scene sums with
    the past-capacity case under ``spill``."""
    import torch

    xyz0 = prep0.batch.coords_float[None].contiguous()
    valid0 = prep0.batch.valid[None].contiguous()
    k4 = dict(ms=0.0, kernel_ms=0.0, plain_ms=0.0, bound=0.0, bytes_ms=0.0, ops_ms=0.0, err=0.0,
              clusters=[])
    print("K4 fps_cuda vs plain:", flush=True)
    first_idx = None
    for n_pts, n_sample in [(N_CAP, cfg.n_sample_pa1)] + [(cfg.n_sample_pa1, r) for r in ROUNDS]:
        if n_pts == N_CAP:
            xyz, valid = xyz0, valid0
        else:
            xyz = xyz0[0, first_idx[0].long()][None].contiguous()
            valid = torch.ones(1, n_pts, dtype=torch.bool, device=dev)
        r = k4_case(xyz, valid, n_sample, f"request, N={n_pts} -> {n_sample}")
        if first_idx is None:
            first_idx = r["idx"]
        for key in ("ms", "kernel_ms", "plain_ms", "bound", "bytes_ms", "ops_ms"):
            k4[key] += r[key]
        k4["clusters"].append(r["cluster"])
    print(f"K4 per scene (4 launches): wrapper {k4['ms']:.3f} ms (before the cluster design: "
          f"{K4_BEFORE_SCENE_MS} ms), the kernel alone {k4['kernel_ms']:.3f} ms, plain "
          f"{k4['plain_ms']:.3f} ms, bound {k4['bound']:.4f} ms", flush=True)
    g = torch.Generator().manual_seed(3)
    lo, hi = xyz0[0][valid0[0]].amin(0).cpu(), xyz0[0][valid0[0]].amax(0).cpu()
    xyz = (lo + (hi - lo) * torch.rand(1, 4 * N_CAP, 3, generator=g)).to(dev)
    valid = (torch.rand(1, 4 * N_CAP, generator=g) < 0.4).to(dev)  # about 419000 valid
    k4["spill"] = k4_case(xyz, valid, 64, "one item past the on-chip capacity")
    return k4


def ball_query_phase(request, what: str) -> None:
    """The stage-1 ball query of one ``request()`` (the grid form at its N)
    on the card against the same call on the CPU, indices and counts equal;
    then the grid and the tiled form timed at that call, and the queries
    whose neighbours the 512-candidate cap changes."""
    import torch

    from gapro_tpu_torch.models import aggregator
    from gapro_tpu_torch.ops import ballquery

    calls = []
    with capture(aggregator, "ball_query_masked", calls):
        request()
    args = calls[0]
    q, p, qv, pv, radius, k = args
    if p.shape[1] < GRID_MIN_N:
        fail(f"the stage-1 ball query ran at N={p.shape[1]}, below the grid form's {GRID_MIN_N}")
    got = ballquery.ball_query_masked(*args)
    want = ballquery.ball_query_masked(q.cpu(), p.cpu(), qv.cpu(), pv.cpu(), radius, k)
    for a, w, name in zip(got, want, ("indices", "counts")):
        if not torch.equal(a.cpu(), w):
            fail(f"grid ball query, card vs CPU: {int((a.cpu() != w).sum())} {name} differ")
    grid_ms = cuda_ms(lambda: ballquery.ball_query_grid(*args), 5)
    tiled_ms = cuda_ms(lambda: ballquery.ball_query_tiled(*args), 1)
    capped = int((got[0] != ballquery.ball_query_tiled(*args)[0]).any(-1).sum())
    print(f"ball query, {what} stage 1 (Q={q.shape[1]}, N={p.shape[1]}, {int(pv.sum())} valid, "
          f"radius {radius}, k={k}): the grid form on the card equals the CPU run (indices and "
          f"counts); grid {grid_ms:.3f} ms, tiled {tiled_ms:.3f} ms a call; the cap changes the "
          f"neighbours of {capped} of {int(qv.sum())} queries", flush=True)


def dyco_inputs(dev, b, q, s, m=32, seed=0, empty=0):
    """Mask-head inputs at the model's scales: weights of O(1/sqrt(fan_in)),
    unit features and geometry, a fifth of the superpoints invalid, and none
    valid in the last ``empty`` items."""
    import torch

    g = torch.Generator().manual_seed(seed)
    h = m // 2
    r = lambda *shape, scale=1.0: (torch.randn(*shape, generator=g) * scale).to(dev)
    args = (r(b, q, m + 6, m, scale=(m + 6) ** -0.5), r(b, q, m, h, scale=m ** -0.5),
            r(b, q, h, 1, scale=h ** -0.5), r(b, q, m, scale=0.1), r(b, q, h, scale=0.1),
            r(b, q, 3), r(b, q, 3).abs(), r(b, s, m), r(b, s, 3), r(b, s, 3).abs())
    valid = torch.rand(b, s, generator=g) > 0.2
    valid[b - empty:] = False
    return (*args, valid.to(dev))


def dyco_ops(pairs: int, m: int = 32) -> float:
    """K5's operations: the function's multiply-adds, 2 (M + 6) M + 2 M H +
    2 H a (query, valid superpoint) pair (H = M / 2; the kernel skips no
    valid pair, and the invalid ones are not the function's)."""
    h = m // 2
    return float(pairs) * (2 * (m + 6) * m + 2 * m * h + 2 * h)


def dyco_bytes(b: int, q: int, s: int, m: int = 32) -> int:
    """K5's bytes: each query's weights and geometry, each superpoint's
    features, geometry and validity read once, the [B, Q, S] logits written
    once."""
    h = m // 2
    return (4 * (b * q * ((m + 6) * m + m * h + h + m + h + 6) + b * s * (m + 6) + b * q * s)
            + b * s)


def k5_case(args, what: str) -> dict:
    """K5 against the plain einsum version on one input (TF32 is off):
    within K5_RTOL / K5_ATOL, invalid superpoints exactly MASK_FILL, two
    launches bit-identical, and its rms error against the same function in
    fp64 at most NOISE_FACTOR times the plain version's; timed with its
    bounds (``tc_bounds``)."""
    import torch

    from gapro_tpu_torch.models import dyco

    b, q, s, m = args[0].shape[0], args[0].shape[1], args[-1].shape[1], args[0].shape[-1]
    got, again = dyco.dyco_cuda(*args), dyco.dyco_cuda(*args)
    want = dyco.dyco_mlp_plain(*args)
    ref = dyco.dyco_mlp_plain(*(a.double() for a in args[:-1]), args[-1])
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    bad = (got - want).abs() > K5_ATOL + K5_RTOL * want.abs()
    if bool(bad.any()):
        fail(f"K5 at B={b} Q={q} S={s} ({what}): {int(bad.sum())} logits outside rtol "
             f"{K5_RTOL}, atol {K5_ATOL}; max |err| {err:.3g}")
    if not bool((got.transpose(1, 2)[~args[-1]] == MASK_FILL).all()):
        fail(f"K5 at B={b} Q={q} S={s} ({what}): invalid superpoints are not exactly {MASK_FILL}")
    if not torch.equal(got, again):
        fail(f"K5 at B={b} Q={q} S={s} ({what}) differs between two launches")
    pairs = q * int(args[-1].sum())  # the function's pairs: valid superpoints only
    drift, ratio = "no valid superpoint", 0.0
    if pairs:
        rms, plain_rms, drift, _ = fp64_drift(got, want, ref, args[-1][:, None, :].expand_as(want),
                                              name="K5")
        if rms > NOISE_FACTOR * plain_rms:
            fail(f"K5 at B={b} Q={q} S={s} ({what}) is further from fp64 than fp32 is: {drift}")
        ratio = rms / plain_rms
    del ref
    ms = cuda_ms(lambda: dyco.dyco_cuda(*args), 10)
    dms = device_ms(lambda: dyco.dyco_cuda(*args), ("dyco_kernel", "image_kernel"))
    pms = cuda_ms(lambda: dyco.dyco_mlp_plain(*args), 3)
    ops, nbytes = dyco_ops(pairs, m), dyco_bytes(b, q, s, m)
    bd = tc_bounds(nbytes, ops)
    print(f"  B={b} Q={q:3d} S={s:4d} M={m} ({what}): wrapper {ms:.4f} ms (its two kernels "
          f"{dms:.4f} ms of device time), plain {pms:.4f} ms, "
          f"bound {bd['bound']:.4f} ms ({bd['by']}, TF32; fp32 {bd['fp32']:.4f}, 3xTF32 "
          f"{bd['x3']:.4f}; {ops / 1e9:.3f} GFLOP over {pairs} valid pairs, "
          f"{ops / ms / 1e9:.2f} TFLOP/s), max|err| {err:.3g}, bit-identical; against fp64: "
          + drift, flush=True)
    return dict(ms=ms, device_ms=dms, plain_ms=pms, bound_ms=bd["bound"], bound_by=bd["by"],
                fp32=bd["fp32"], x3=bd["x3"], bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=ops / TF32_FLOPS * 1e3, err=err, fp64=ratio)


def dyco_kernel_phase(dev) -> dict:
    """K5 at each shape of ``DYCO_SHAPES`` (``k5_case``), then ``DycoFn``'s
    gradients on the card against ``torch.autograd.grad`` of the plain
    version at the training shape. Returns the timings by shape and the
    largest error."""
    import torch

    from gapro_tpu_torch.models import dyco

    print("K5 dyco_cuda vs plain (B, Q, S):", flush=True)
    res = dict(err=0.0, fp64=0.0, shapes={})
    for b, q, s, empty, what in DYCO_SHAPES:
        r = k5_case(dyco_inputs(dev, b, q, s, seed=q + s, empty=empty), what)
        res["err"], res["fp64"] = max(res["err"], r["err"]), max(res["fp64"], r["fp64"])
        res["shapes"][what] = r
    b, q, s, _, _ = DYCO_SHAPES[0]
    args = dyco_inputs(dev, b, q, s, seed=7)
    xs = [a.clone().requires_grad_() for a in args[:-1]]
    ys = [a.clone().requires_grad_() for a in args[:-1]]
    ct = torch.randn(b, q, s, generator=torch.Generator().manual_seed(8)).to(dev)
    gk = torch.autograd.grad(dyco.DycoFn.apply(*xs, args[-1]), xs, ct)
    gp = torch.autograd.grad(dyco.dyco_mlp_plain(*ys, args[-1]), ys, ct)
    worst = 0.0
    for i, (a, w) in enumerate(zip(gk, gp)):
        e = float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, e)
        if e > 1e-5:
            fail(f"DycoFn gradient of input {i} differs from the plain version's by {e:.3g} "
                 f"of its scale")
    print(f"K5 backward (DycoFn, plain recompute) at B={b} Q={q} S={s}: the ten gradients "
          f"within {worst:.3g} of their scale of autograd through the plain version", flush=True)
    print(f"K5 against fp64: rms at most {res['fp64']:.3g} times the plain fp32 version's "
          f"(gate {NOISE_FACTOR})", flush=True)
    return res


def stage_line(ms: dict) -> str:
    return f"{sum(ms.values()):.1f} ms (" + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()) + " ms)"


def trainer_phase(dev, work_dir: str, cfg, train_ds, need: dict, label: str = "trainer",
                  val_ds=None, pretrain=None, resume: bool = False) -> dict:
    """The port's trainer (``gapro_tpu_torch/tools/train.py:train``) at full
    width and the config's batch, one epoch of ``train_ds`` loaded by
    ``DATA_WORKERS`` forked workers: one cold step, then the counts zeroed
    and the other steps timed by stage, each kernel launched at least
    ``need[kernel]`` times a step; then validation on ``VAL_SCENES`` scenes
    of ``val_ds`` (none if None); the weights first loaded from
    ``pretrain``, if given; with ``resume``, the checkpoint it wrote taken
    up again through ``resume`` and compared bit for bit."""
    import torch

    from gapro_tpu_torch.tools import train as port_train

    batch = cfg.train.batch_size
    stamps, steps, out = [], [], {}
    n_steps = len(train_ds) // batch

    def mark(name):
        torch.cuda.synchronize()
        stamps.append((name, time.perf_counter()))

    def on_step(losses):
        ms = {name: (t - stamps[i][1]) * 1e3 for i, (name, t) in enumerate(stamps[1:])}
        if steps:
            ms = {"data": (stamps[0][1] - out["end"]) * 1e3, **ms}
        out["end"] = stamps[-1][1]
        stamps.clear()
        steps.append((ms, losses))
        step_label = "cold training step" if len(steps) == 1 else f"training step {len(steps) - 1}"
        print(f"{label}, batch {batch}, {step_label}: {stage_line(ms)}; "
              + ", ".join(f"{k} {v:.6g}" for k, v in losses.items()), flush=True)
        bad = [k for k, v in losses.items() if not math.isfinite(v)]
        if bad:
            fail(f"{label} step {len(steps)}: not finite: {bad}")
        if len(steps) == 1:
            torch.cuda.reset_peak_memory_stats()
            zero_counts()
        elif len(steps) == n_steps:
            out["launches"] = read_counts()
            out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30

    val_ms = []
    validate = port_train.validate

    def timed_validate(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = validate(*args, **kwargs)
        torch.cuda.synchronize()
        val_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    loads = []
    load_weights = port_train.load_model_weights

    def recorded_load(path, model):
        init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        load_weights(path, model)
        loads.append((init, {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}))

    port_train.validate = timed_validate
    port_train.load_model_weights = recorded_load
    try:
        res = port_train.train(cfg, work_dir, device=dev, dataset=train_ds, val_dataset=val_ds,
                               skip_validate=val_ds is None, val_scenes=VAL_SCENES,
                               num_workers=DATA_WORKERS, on_stage=mark, on_step=on_step,
                               pretrain=pretrain)
    finally:
        port_train.validate = validate
        port_train.load_model_weights = load_weights
    if len(steps) != n_steps or len(val_ms) != (val_ds is not None):
        fail(f"{label} ran {len(steps)} steps (want {n_steps}) and {len(val_ms)} validations")
    if len(loads) != (pretrain is not None):
        fail(f"{label} loaded the pretrain weights {len(loads)} times (given: {pretrain})")
    timed = [sum(ms.values()) for ms, _ in steps[1:]]
    launches = out["launches"]
    ovf = {k: [v[k] for _, v in steps] for k in steps[0][1] if k.startswith("ovf_")}
    rec = res["records"][-1]
    print(f"{label}: {n_steps - 1} timed steps of batch {batch}, median "
          f"{statistics.median(timed):.1f} ms (all: {', '.join(f'{t:.1f}' for t in timed)}); "
          f"launches over them {launches}; peak device memory {out['peak_gib']:.2f} GiB; "
          f"ovf counters by step {ovf}"
          + (" (ovf_inst_voxels is the constant 0 of a semantic_only step, not a count)"
             if cfg.model.get("semantic_only") else ""), flush=True)
    if val_ds is not None:
        print(f"{label} validation, {VAL_SCENES} scenes: {val_ms[0]:.1f} ms; "
              + " ".join(f"{k} {v:.4f}" for k, v in rec.items() if k.startswith("val_")),
              flush=True)
    if any(launches[k] < (n_steps - 1) * n for k, n in need.items()):
        fail(f"{label} did not run through the kernels as expected: {launches}, need at "
             f"least {need} per step")

    if resume:
        again = port_train.train(cfg, work_dir, device=dev, dataset=train_ds,
                                 skip_validate=True, resume=os.path.join(work_dir, "latest"))
        want, got = res["model"].state_dict(), again["model"].state_dict()
        diff = [k for k in want if not torch.equal(want[k], got[k])]
        wo = res["state"].optimizer.state_dict()["state"]
        go = again["state"].optimizer.state_dict()["state"]
        diff += [f"optimizer {i}.{k}" for i in wo for k in wo[i]
                 if not torch.equal(torch.as_tensor(wo[i][k]), torch.as_tensor(go[i][k]))]
        if diff or again["state"].step != res["state"].step or again["records"]:
            fail(f"resume from the trainer's checkpoint differs: {diff[:8]}, step "
                 f"{again['state'].step} vs {res['state'].step}")
        latest = os.path.basename(os.path.realpath(os.path.join(work_dir, "latest")))
        print(f"{label} checkpoint: resumed from {latest} at step {again['state'].step}: "
              f"{len(want)} model entries (BatchNorm statistics included) and the optimizer "
              f"state equal bit for bit", flush=True)
    return dict(cfg=cfg, train_ds=train_ds, state=res["state"], launches=launches,
                step_ms=timed, peak_gib=out["peak_gib"], ovf=ovf,
                pretrain_load=loads[0] if loads else None,
                val_ms=val_ms[0] if val_ms else None, record=rec, steps=steps)


def conv_need(model_cfg) -> dict:
    """The conv kernels' launches a training step of a U-Net: K1 on every
    submanifold conv, dfeats on all but the stem's, dW on every one."""
    n = sum(k1_shape_counts(model_cfg, range(model_cfg.unet_levels)).values())
    return {"subm_conv": n, "subm_conv_dfeats": n - 1, "subm_conv_dw": n}


def path_conv_times(cfg, plan, dev, what: str) -> dict:
    """K1, dfeats and dW at the shapes of a path's plan (each level's own
    neighbour table and valid rows, random features): per-step sums of
    the kernels' times (CUDA events) and of their bounds, counted from
    this plan's pairs. Returns {kernel: (ms, bound ms, launches)}."""
    import torch

    from gapro_tpu_torch.sparse import conv

    g = torch.Generator().manual_seed(3)
    levels = plan.levels
    caps = [lp.subm_nbr.shape[0] for lp in levels]
    acc = {k: [0.0, 0.0, 0] for k in ("K1", "dfeats", "dW")}
    for (v, cin, cout), count in sorted(k1_shape_counts(cfg, caps).items()):
        lp = levels[caps.index(v)]
        valid, nbr = lp.grid.valid, lp.subm_nbr
        feats = (torch.randn(v, cin, generator=g).to(dev) * valid[:, None]).contiguous()
        dout = (torch.randn(v, cout, generator=g).to(dev) * valid[:, None]).contiguous()
        w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * math.sqrt(3.0 / (27 * cin))).to(dev)
        w_rev = w.flip(0).transpose(1, 2)
        nnz = int((nbr >= 0).sum())
        flops = 2.0 * nnz * cin * cout
        n_df = count - (1 if (v, cin) == (caps[0], 6 if cfg.with_coords else 3) else 0)
        for key, n, run, nbytes in (
                ("K1", count, lambda: conv.subm_conv_cuda(feats, nbr, w, valid, tables=lp.conv),
                 v * 27 * 4 + v * cin * 4 + 27 * cin * cout * 4 + v + v * cout * 4),
                ("dfeats", n_df,
                 lambda: conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid, tables=lp.conv),
                 v * 27 * 4 + v * cout * 4 + 27 * cin * cout * 4 + v + v * cin * 4),
                ("dW", count, lambda: conv.subm_conv_dw_cuda(feats, nbr, dout, tables=lp.conv),
                 v * 27 * 4 + v * cin * 4 + v * cout * 4 + 27 * cin * cout * 4)):
            acc[key][0] += n * cuda_ms(run, 3)
            acc[key][1] += n * tc_bounds(nbytes, flops)["bound"]
            acc[key][2] += n
    print(f"conv kernels at the {what}'s shapes (levels {caps}), per step: "
          + "; ".join(f"{k} {ms:.3f} ms in {n} launches, bound {b:.3f} ms ({b / ms:.1%} of it)"
                      for k, (ms, b, n) in acc.items()), flush=True)
    return {k: tuple(v) for k, v in acc.items()}


def trainer_plain_compare(cfg, train_ds, dev):
    """One batch-4 step's losses through the kernels and through the plain
    versions (the plain run given the kernel run's assignment), from the
    same weights, on the trainer's first batch. Returns the prepared batch,
    its ``prepare`` for the profile, and the kernel run's FPS input."""
    import torch

    from gapro_tpu_torch.data.dataset import build_dataloader
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.tools import train as port_train
    from gapro_tpu_torch.train import step

    loader = build_dataloader(train_ds, BATCH, training=True, seed=0, epoch=1,
                              num_workers=DATA_WORKERS)
    lb = next(loader)
    loader.close()  # shuts the workers down
    prepare = port_train.make_prepare(cfg, dev)
    prepared = prepare(lb.points, lb.batch_size)
    runs, fps_calls = {}, []
    for name in ("kernels", "plain"):
        model, crit = port_train.build_model(cfg, dev, seed=0)
        model.train()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), (plain_kernels() if name == "plain"
                               else capture(fps_ops, "fps", fps_calls)):
            _, (losses, aux) = step._loss_fn(model, prepared, crit,
                                             assign=runs["kernels"][1] if runs else None)
        torch.cuda.synchronize()
        runs[name] = ({k: float(v) for k, v in losses.items()}, aux["assign"],
                      (time.perf_counter() - t0) * 1e3, aux["outputs"])
    (lk, assign, kms, _), (lp, _, pms, _) = runs["kernels"], runs["plain"]
    # The flat superpoint capacity (spp_cap) is shared by the whole batch.
    # compact_unique numbers the batch's superpoints in order, scene by
    # scene; those numbered past the capacity are dropped by the segment
    # sums before ovf_spp_slots counts anything, so count them here.
    b, cap = prepared.batch, cfg.model.spp_cap
    has = b.valid & (b.spp >= 0)
    n_spp = int(b.spp[has].max()) + 1
    slot = [f"{int((has & (b.batch_idx == i) & (b.spp < cap)).sum())}/"
            f"{int((has & (b.batch_idx == i)).sum())}" for i in range(lb.batch_size)]
    dense = runs["kernels"][3]["sp_dense_valid"].sum(1).tolist()
    print(f"batch-4 superpoints: {n_spp} in the batch against the flat capacity {cap} "
          f"({max(0, n_spp - cap)} dropped, which no ovf_* counter counts; ovf_spp_slots "
          f"{lk['ovf_spp_slots']:.0f}); voxels with a superpoint slot by scene {slot}; valid "
          f"dense superpoint slots by scene {dense}", flush=True)
    bad = [f"{k} {lk[k]:.6g} vs {v:.6g}" for k, v in lp.items()
           if not math.isfinite(lk[k]) or abs(lk[k] - v) > PATH_RTOL * max(1.0, abs(v))]
    if bad:
        fail("batch-4 losses, kernels vs plain: " + "; ".join(bad))
    print(f"plain batch-4 step (forward, targets, criterion): kernels {kms:.1f} ms, plain "
          f"{pms:.1f} ms; every loss within {PATH_RTOL} ({len(lk)} terms, "
          f"{int((assign >= 0).sum())} matched instances over {lb.batch_size} scenes)",
          flush=True)
    return lb, prepare, fps_calls[0]


def test_cli_phase(model, dev, cfg=None, per_scene=None, label: str = "test CLI") -> dict:
    """The port's test CLI (``gapro_tpu_torch/tools/test.py:run_test``) on
    ``TEST_SCENES`` full-size scenes with ``model`` and ``cfg`` (ISBNet's
    full config by default), the counts zeroed just before and read just
    after: each kernel of ``per_scene`` launched that many times a scene,
    and every scene gives an instance."""
    import torch

    from gapro_tpu_torch.data.dataset import SyntheticDataset
    from gapro_tpu_torch.tools import test as port_test
    from gapro_tpu_torch.tools import train as port_train

    cfg = cfg or full_config()
    per_scene = per_scene or {"dyco": 3, "fps": 4}
    ds = SyntheticDataset(n_scenes=TEST_SCENES, training=False,
                          voxel_cfg=port_train.voxel_cfg(cfg), **FULL_SCENE)
    torch.cuda.synchronize()
    zero_counts()
    res = port_test.run_test(cfg, device=dev, dataset=ds, model=model)
    launches = read_counts()
    n_inst = [len(p) for p in res["preds"]]
    ap = {k: v for k, v in res["result"].items() if k != "classes"}
    line = (f"{label}, {TEST_SCENES} scenes: per scene "
            + ", ".join(f"{t * 1e3:.1f}" for t in res["seconds"])
            + f" ms; instances {n_inst}; launches {launches}; AP {json.dumps(ap)}")
    if res["box_result"] is not None:
        line += "; box AP " + json.dumps({k: v for k, v in res["box_result"].items()
                                          if k != "classes"})
    print(line, flush=True)
    if any(launches[k] != n * TEST_SCENES for k, n in per_scene.items()) or not all(n_inst):
        fail(f"{label} did not run through the kernels as expected: {launches}, "
             f"instances {n_inst}")
    return dict(launches=launches, seconds=res["seconds"])


# The scaled C = 32 gate (__graft_entry__.py's multi-device stage): the
# full backbone width, 3 levels, small heads, a flat superpoint capacity of
# 512 and inst_cap 32, on a scene of about 8k points at voxel scale 25,
# capacity 8192, every level at its full capacity (shrink 1.0). Every
# ovf_* counter must read 0. tests/test_torch_c32_gate.py holds the CPU
# run against the JAX package.
C32_GATE = dict(channels=32, num_blocks=3, n_sample_pa1=64, n_queries=16, neighbor=8,
                dec_dim=32, mask_dim_out=8, spp_cap=512, filter_bg_thresh=0.0)
C32_INST_CAP = 32
C32_N_CAP = 8192


def c32_points(seed: int = 0):
    """The C = 32 gate's scene as a padded point batch (numpy), each point
    with a seeded GP label (prob ~ U(0.5, 1), mu ~ N(0, 1), var ~ U(0, 0.5)
    with a fifth set to 0, drawn as ``tests/test_torch_train.py`` draws
    them), so that both KL branches and the prob-weighted BCE run."""
    from gapro_tpu_torch.data import make_synthetic_scene, remap_semantic_for_training
    from gapro_tpu_torch.models import prepare

    s = make_synthetic_scene(seed=seed, n_objects=8, points_per_object=600, n_floor=2000,
                             n_wall=1200)
    n = len(s.xyz)
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.0, 0.5, n).astype(np.float32)
    var[rng.random(n) < 0.2] = 0.0
    return prepare.points_to_batch_np([dict(
        xyz=s.xyz, rgb=s.rgb, spp=s.spp, semantic=remap_semantic_for_training(s.semantic_label),
        instance=s.instance_label, prob=rng.uniform(0.5, 1.0, n).astype(np.float32),
        mu=rng.normal(size=n).astype(np.float32), var=var)], voxel_scale=25, n_cap=C32_N_CAP)


def c32_gate_phase(dev) -> dict:
    """One training step of the C = 32 gate on the card (kernels) and on
    the CPU (plain versions) from the same weights, the CPU run given the
    card's assignment: within the tiny tolerances, every ovf_* counter 0 on
    both, the card's run through the kernels."""
    from gapro_tpu_torch.losses.criterion import CriterionConfig
    from gapro_tpu_torch.models import isbnet, prepare

    crit = CriterionConfig(inst_cap=C32_INST_CAP)
    pb = c32_points()
    runs = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        tp = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, d), C32_N_CAP, 1, 3,
                                         C32_GATE["spp_cap"], 1.0)
        model = isbnet.ISBNet(isbnet.ISBNetConfig(**C32_GATE), seed=0, device=d)
        zero_counts()
        runs[name] = one_step_grads(model, tp, crit,
                                    assign=runs["card"][1].cpu() if runs else None)
        if name == "card":
            launches = read_counts()
    summary = compare_step(runs["card"][0], runs["cpu"][0], TINY_RTOLS, "C=32 gate, card vs CPU")
    ovf = {d: {k: v for k, v in r[0][0].items() if k.startswith("ovf_")} for d, r in runs.items()}
    if len(ovf["card"]) != 5 or any(v != 0 for o in ovf.values() for v in o.values()):
        fail(f"C=32 gate: the ovf_* counters are not all 0: {ovf}")
    need = dict(conv_need(isbnet.ISBNetConfig(**C32_GATE)), fps=1, dyco=1)
    if any(launches[k] < n for k, n in need.items()):
        fail(f"C=32 gate: the card's step did not run through the kernels: {launches}")
    print(f"C=32 gate: one step on the card equals the CPU run ({summary}); ovf counters "
          f"{ovf['card']} on the card and {ovf['cpu']} on the CPU; card launches {launches}; "
          f"loss {runs['card'][0][0]['loss']:.6f}", flush=True)
    return dict(launches=launches)


BACKBONE_BATCH = 8  # configs/isbnet_backbone_scannetv2.yaml: train.batch_size
BACKBONE_SCENES = 32  # four steps of batch 8: one cold, three timed


def backbone_config(epochs: int = 1):
    """``ISBNET_BACKBONE_SCANNETV2`` as the trainer reads it."""
    from gapro_tpu_torch.train.config import AttrDict

    cfg = AttrDict.wrap(ISBNET_BACKBONE_SCANNETV2)
    cfg.train["epochs"] = epochs
    return cfg


def backbone_phase(dev, work_dir: str, val_ds) -> dict:
    """ISBNet's backbone pre-training stage (``semantic_only``) at full
    width and the config's batch 8: the trainer on ``BACKBONE_SCENES``
    bench scenes with seeded GP labels (cold step, three timed steps by
    stage, peak memory, validation by ``PointWiseEval`` on ``VAL_SCENES``
    scenes, one checkpoint), then one batch-8 step, kernels against plain
    versions, and the conv kernels at the batch-8 plan's shapes."""
    from gapro_tpu_torch.data.dataset import SyntheticDataset, build_dataloader
    from gapro_tpu_torch.tools import train as port_train

    cfg = backbone_config()
    ds = GPLabelled(SyntheticDataset(n_scenes=BACKBONE_SCENES, training=True,
                                     voxel_cfg=port_train.voxel_cfg(cfg), **FULL_SCENE))
    probe, crit = port_train.build_model(cfg, "cpu")
    mcfg = probe.cfg
    res = trainer_phase(dev, work_dir, cfg, ds, conv_need(mcfg),
                        label="backbone trainer (semantic_only)", val_ds=val_ds)
    for key in ("val_miou", "val_acc", "val_offset_mae"):
        if not math.isfinite(res["record"][key]):
            fail(f"backbone validation: {key} is not finite")
    loader = build_dataloader(ds, BACKBONE_BATCH, training=True, seed=0, epoch=1,
                              num_workers=DATA_WORKERS)
    lb = next(loader)
    loader.close()
    prepared = port_train.make_prepare(cfg, dev)(lb.points, lb.batch_size)
    plan = prepared.batch.plan
    print(f"backbone batch {BACKBONE_BATCH}: {int(prepared.batch.valid.sum())} voxels; level "
          f"capacities {[lp.subm_nbr.shape[0] for lp in plan.levels]}, plan voxels dropped "
          f"{sum(lp.dropped_next for lp in plan.levels)} (no ovf_plan_voxels rides along "
          f"with a semantic_only step's losses)", flush=True)
    train_plain_compare(lambda: port_train.build_model(cfg, dev, seed=0)[0], prepared, crit,
                        f"backbone step, batch {BACKBONE_BATCH}", admit_outliers=True)
    res["conv"] = path_conv_times(mcfg, plan, dev, f"backbone step, batch {BACKBONE_BATCH}")
    return res


# the modules ISBNet's backbone stage shares with the full model
BACKBONE_MODULES = ("backbone", "semantic_linear", "offset_vertices_linear", "box_conf_linear")


def check_pretrain_load(checkpoint: str, load: tuple) -> None:
    """Hold the trainer's ``pretrain`` load (the model's entries just
    before and just after it): every entry of ``BACKBONE_MODULES`` must
    equal the checkpoint's, every other entry its seed-0 initial value."""
    import torch

    from gapro_tpu_torch.train.checkpoint import load_checkpoint

    init, after = load
    ck = load_checkpoint(checkpoint)["model"]
    from_ck = {k for k, v in after.items() if k in ck and torch.equal(v, ck[k])}
    from_init = {k for k, v in after.items() if torch.equal(v, init[k])}
    shared = {k for k in after if k.split(".")[0] in BACKBONE_MODULES}
    moved = shared - from_init
    print(f"two stages: the batch-{BATCH} trainer's pretrain load from the backbone checkpoint "
          f"({os.path.basename(os.path.realpath(checkpoint))}): {len(from_ck)} of "
          f"{len(after)} entries equal the checkpoint's ({len(moved)} of them differ from "
          f"the seed-0 init; the backbone and the point-wise heads, BatchNorm statistics "
          f"included), {len(from_init - shared)} others still equal their seed-0 init",
          flush=True)
    if from_ck != shared or not moved or not (set(after) - shared) <= from_init:
        fail(f"the backbone checkpoint's load: {len(from_ck)} entries equal it, want the "
             f"{len(shared)} of {BACKBONE_MODULES}; {len(moved)} moved from the init; "
             f"{len(set(after) - shared - from_init)} other entries left their init")


# SPFormer at full width (configs/spformer_scannetv2.yaml): its U-Net has 5
# levels, shrunk by the config's (0.67, 0.3, 0.25, 0.25).
SPF_SHRINK = (0.67, 0.3, 0.25, 0.25)
SPF_TINY = dict(media=8, blocks=3, num_layer=2, num_query=16, d_model=32, nhead=4,
                hidden_dim=64, spp_cap=256)  # configs/tiny_spformer_synthetic.yaml's widths


def spformer_config(epochs: int = 1):
    """``SPFORMER_SCANNETV2`` as the trainer reads it."""
    from gapro_tpu_torch.train.config import AttrDict

    cfg = AttrDict.wrap(SPFORMER_SCANNETV2)
    cfg.train["epochs"] = epochs
    return cfg


def spformer_model(dev, cfg=None, seed: int = 0):
    """SPFormer with seeded weights; the score head's output bias raised by
    CONF_SHIFT, as ISBNet's conf head is, so that untrained scores are
    positive and the test CLI ranks instances."""
    import torch

    from gapro_tpu_torch.models.spformer import SPFormer, SPFormerConfig

    model = SPFormer(cfg or SPFormerConfig(), seed=seed, device=dev)
    with torch.no_grad():
        model.decoder.out_score_1.bias += CONF_SHIFT
    return model


def spformer_serve(model, s, pb, device):
    """One SPFormer request: prepare -> forward -> ``spformer_get_instances``,
    each stage's milliseconds (host clock, the card synchronised after
    each)."""
    import torch

    from gapro_tpu_torch.models import inference, prepare

    stamps = [time.perf_counter()]

    def stage():
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    prepared = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, device), N_CAP, 1,
                                           model.cfg.unet_levels, model.cfg.spp_cap, SPF_SHRINK)
    stage()
    model.eval()
    out = model(prepared.batch)
    stage()
    inst = inference.spformer_get_instances("scene_synthetic", out, prepared.batch, s.spp,
                                            prepared.point2voxel, len(s.xyz))
    stage()
    ms = {k: (stamps[i + 1] - stamps[i]) * 1e3
          for i, k in enumerate(("prepare", "forward", "instances"))}
    return prepared, out, inst, ms


def spformer_tiny_reference(dev) -> None:
    """SPFormer at the tiny configuration's widths on the card (kernels)
    against the CPU (plain versions), on the tiny scene: the forward's
    outputs, and one training step, the CPU run given the card's
    assignment."""
    from gapro_tpu_torch.losses.spformer_criterion import SPFormerCriterionConfig
    from gapro_tpu_torch.models import prepare
    from gapro_tpu_torch.models.spformer import SPFormer, SPFormerConfig

    _, tpb = scene_inputs(0, tiny=True)
    crit = SPFormerCriterionConfig(inst_cap=TINY_INST_CAP)
    outs, runs = {}, {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        tp = prepare.prepare_voxel_batch(prepare.upload_point_batch(tpb, d), 2048, 1, 3, 256, 0.7)
        model = SPFormer(SPFormerConfig(**SPF_TINY), seed=0, device=d)
        outs[name] = model(tp.batch)
        runs[name] = one_step_grads(model, tp, crit,
                                    assign=runs["card"][1].cpu() if runs else None)
    err = compare_outputs(outs["card"], outs["cpu"], 1e-4, "SPFormer tiny forward, card vs CPU")
    summary = compare_step(runs["card"][0], runs["cpu"][0], TINY_RTOLS,
                           "SPFormer tiny step, card vs CPU")
    print(f"SPFormer reference: the tiny configuration's forward on the card equals the CPU "
          f"run (discrete equal, floats within {err:.3g} of scale); one step ({summary}); "
          f"loss {runs['card'][0][0]['loss']:.6f}", flush=True)


def spformer_phase(dev, scenes, train_ds, work_dir: str) -> dict:
    """SPFormer at full width: the tiny reference; the conv kernels against
    their plain versions and fp64 at its U-Net's shapes; inference on the
    bench scenes (a cold request, then each timed, the counts zeroed just
    before and read just after); the trainer at batch 4 (the matching's
    host time apart); one batch-4 step, kernels against plain versions; the
    test CLI with AP and box AP."""
    import torch

    from gapro_tpu_torch.losses import spformer_criterion
    from gapro_tpu_torch.models import prepare
    from gapro_tpu_torch.sparse.plan import level_capacities
    from gapro_tpu_torch.tools import train as port_train

    spformer_tiny_reference(dev)
    cfg = spformer_config()
    model = spformer_model(dev)
    mcfg = model.cfg
    caps = level_capacities(N_CAP, mcfg.unet_levels, SPF_SHRINK)
    prep0 = prepare.prepare_voxel_batch(prepare.upload_point_batch(scenes[0][1], dev), N_CAP, 1,
                                        mcfg.unet_levels, model.cfg.spp_cap, SPF_SHRINK)
    print(f"SPFormer U-Net: {mcfg.unet_levels} levels, capacities {caps}", flush=True)
    res = dict(k1=k1_phase(mcfg, caps, prep0.batch.plan.levels, dev, row_orders=False))
    res["dfeats"], res["dw"] = backward_kernel_phase(mcfg, caps, prep0.batch.plan.levels, dev,
                                                     row_orders=False)
    del prep0

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    spformer_serve(model, *scenes[0], dev)
    print(f"SPFormer cold request, scene 0: {(time.perf_counter() - t0) * 1e3:.1f} ms",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times = []
    for seed, (s, pb) in enumerate(scenes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prepared, out, inst, stages = spformer_serve(model, s, pb, dev)
        times.append((time.perf_counter() - t0) * 1e3)
        for key, shape in (("masks", (7, 1, 400, 4096)), ("labels", (7, 1, 400, 19))):
            if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
                fail(f"SPFormer {key}: shape {tuple(out[key].shape)} (want {shape}) or not finite")
        if not inst:
            fail(f"SPFormer: scene {seed} gave no instance")
        print(f"SPFormer scene {seed}: {times[-1]:.1f} ms ("
              + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
              + f" ms), {len(inst)} instances, "
              + ", ".join(f"{k}={out[k]}" for k in sorted(out) if k.startswith("ovf_")),
              flush=True)
    res["infer_launches"] = read_counts()
    res["infer_ms"] = statistics.median(times)
    n_fwd = conv_need(mcfg)["subm_conv"]
    print(f"SPFormer inference launches over {len(scenes)} scenes: {res['infer_launches']}; per "
          f"scene median {res['infer_ms']:.1f} ms (all: {', '.join(f'{t:.1f}' for t in times)});"
          f" peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if res["infer_launches"]["subm_conv"] != n_fwd * len(scenes):
        fail(f"SPFormer inference did not run through K1 {n_fwd} times a scene: "
             f"{res['infer_launches']}")

    match_ms = []
    match = spformer_criterion.spformer_match_layers

    def timed_match(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = match(*args)
        match_ms.append((time.perf_counter() - t) * 1e3)
        return r

    spformer_criterion.spformer_match_layers = timed_match
    try:
        res["trainer"] = trainer_phase(dev, work_dir, cfg, train_ds, conv_need(mcfg),
                                       label="SPFormer trainer")
    finally:
        spformer_criterion.spformer_match_layers = match
    print(f"SPFormer trainer: the matching of all 7 heads x {cfg.train.batch_size} scenes "
          f"(costs on the card, one copy, scipy on the host) by step: "
          + ", ".join(f"{t:.1f}" for t in match_ms) + " ms, within the targets stage",
          flush=True)
    res["match_ms"] = match_ms

    from gapro_tpu_torch.data.dataset import build_dataloader

    loader = build_dataloader(train_ds, cfg.train.batch_size, training=True, seed=0, epoch=1,
                              num_workers=DATA_WORKERS)
    lb = next(loader)
    loader.close()
    prepared = port_train.make_prepare(cfg, dev)(lb.points, lb.batch_size)
    crit = port_train.build_model(cfg, "cpu")[1]
    train_plain_compare(lambda: spformer_model(dev), prepared, crit,
                        f"SPFormer step, batch {cfg.train.batch_size}")
    res["conv_b4"] = path_conv_times(mcfg, prepared.batch.plan, dev,
                                     f"SPFormer step, batch {cfg.train.batch_size}")
    del prepared
    res["test_cli"] = test_cli_phase(model, dev, cfg, {"subm_conv": n_fwd}, "SPFormer test CLI")
    return res


# configs/isbnet_s3dis.yaml as a dict (held equal to the YAML file by
# tests/test_torch_trainer.py): ISBNet on S3DIS, C = 32, 7 levels, 13
# classes, the ball query's radius 1.5 times ScanNet's, batch 4, crops of
# 300000 points, rooms served in 4 interleaved pieces (x4_split) with the
# ceiling and floor taken from the semantics (sem2ins_classes).
ISBNET_S3DIS = {
    "model": {"type": "isbnet", "channels": 32, "num_blocks": 7, "instance_classes": 13,
              "semantic_classes": 13, "semantic_only": False, "with_coords": True,
              "filter_bg_thresh": 0.1, "dec_dim": 128, "n_sample_pa1": 2048, "n_queries": 256,
              "radius_scale": 1.5, "neighbor": 32, "mask_dim_out": 32, "spp_cap": 4096},
    "criterion": {"instance_classes": 13, "voxel_scale": 50.0, "trainall": False,
                  "inst_cap": 192},
    "data": {"type": "s3dis", "data_root": "dataset/s3dis",
             "label_type": "gaussian_process_kl_pseudo_labels",
             "plan_shrink": [0.67, 0.3, 0.25, 0.25, 0.25, 0.25],
             "prefix_train": "Area_1,Area_2,Area_3,Area_4,Area_6", "prefix_val": "Area_5",
             "repeat": 1,
             "voxel": {"scale": 50, "spatial_shape": [128, 512], "max_npoint": 300000,
                       "min_npoint": 5000}},
    "train": {"batch_size": 4, "epochs": 60, "step_epoch": 50, "lr": 0.001,
              "weight_decay": 0.0001, "save_freq": 16, "eval_every": 16, "pretrain": None},
    "test": {"x4_split": True, "sem2ins_classes": [0, 1], "logit_thresh": 0.0,
             "score_thresh": 0.2, "npoint_thresh": 100, "type_nms": "matrix", "topk": 100,
             "label_offset": 3},
}
# Synthetic S3DIS rooms (the card's machine has no dataset): a room of
# about 1e6 points, the size of an S3DIS room, served whole; 16 training
# rooms under the training areas' prefixes, one of 1.6e6 points so that the
# 300000-point crop runs after the 25% subsample; 2 rooms of Area_5 for
# validation and the test CLI; 3 more for the timed requests.
S3DIS_ROOM_POINTS = 1_000_000
S3DIS_BIG_ROOM_POINTS = 1_600_000
S3DIS_TRAIN_AREAS = (1, 2, 3, 4, 6)
S3DIS_TRAIN_ROOMS = 16
S3DIS_REQUESTS = 3
# The objects of a room beside its ceiling (class 0), floor (1) and four
# walls (2): (class, count) for beam, column, window, door, chair, table,
# bookcase, sofa, board and clutter; each its own instance.
S3DIS_OBJECTS = ((3, 1), (4, 1), (5, 1), (6, 1), (7, 6), (8, 2), (9, 2), (10, 1), (11, 1),
                 (12, 5))
S3DIS_SPP_CELL = 0.5  # m: a superpoint is an instance's points in one such cell


def box_surface(rng, lo, hi, n: int):
    """``n`` points uniform on the surface of the box [lo, hi] (a face of no
    area gets none)."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    ext = hi - lo
    areas = np.repeat([ext[1] * ext[2], ext[0] * ext[2], ext[0] * ext[1]], 2)
    face = rng.choice(6, n, p=areas / areas.sum())
    p = lo + rng.random((n, 3)) * ext
    axis = face // 2
    p[np.arange(n), axis] = np.where(face % 2 == 1, hi[axis], lo[axis])
    return p


def s3dis_room(seed: int, n_points: int) -> dict:
    """One synthetic S3DIS room as ``tools/prepare_s3dis.py`` writes it:
    xyz (centred in x and y, the floor at z = 0), rgb in [-1, 1], the 13
    classes as training ids and an instance id per object (ceiling, floor
    and each wall included), and superpoint ids. Points are spread over the
    objects' surfaces by area, with 3 mm of noise."""
    rng = np.random.default_rng(seed)
    w, d, h = rng.uniform(5.0, 9.0), rng.uniform(4.0, 7.0), rng.uniform(2.8, 3.4)
    boxes = [(0, (0, 0, h), (w, d, h)), (1, (0, 0, 0), (w, d, 0)),
             (2, (0, 0, 0), (w, 0, h)), (2, (0, d, 0), (w, d, h)),
             (2, (0, 0, 0), (0, d, h)), (2, (w, 0, 0), (w, d, h))]
    at = lambda size, lim: rng.uniform(0.1, lim - size - 0.1)
    for cls, count in S3DIS_OBJECTS:
        for _ in range(count):
            if cls == 3:  # beam under the ceiling
                y = at(0.3, d)
                box = (0, y, h - 0.4), (w, y + 0.3, h)
            elif cls == 4:  # column by a wall
                x = at(0.4, w)
                box = (x, 0, 0), (x + 0.4, 0.4, h)
            elif cls in (5, 11):  # window, board: on a wall
                x = at(1.6, w)
                y0 = 0.0 if cls == 5 else d - 0.05
                box = (x, y0, 0.9), (x + 1.6, y0 + 0.05, 2.1)
            elif cls == 6:  # door
                y = at(0.9, d)
                box = (0, y, 0), (0.05, y + 0.9, 2.1)
            else:  # furniture and clutter on the floor
                sx, sy, sz = {7: (0.5, 0.5, 0.9), 8: (1.6, 0.8, 0.75), 9: (1.0, 0.35, 2.0),
                              10: (2.0, 0.9, 0.8)}.get(cls, tuple(rng.uniform(0.2, 0.5, 3)))
                x, y = at(sx, w), at(sy, d)
                box = (x, y, 0), (x + sx, y + sy, sz)
            boxes.append((cls, *box))
    area = np.array([np.prod(np.sort(np.subtract(hi, lo))[1:]) + 1e-3 for _, lo, hi in boxes])
    counts = rng.multinomial(n_points, area / area.sum())
    xyz = np.concatenate([box_surface(rng, lo, hi, k) for (_, lo, hi), k in zip(boxes, counts)])
    xyz += rng.normal(0.0, 0.003, xyz.shape)
    inst = np.repeat(np.arange(len(boxes)), counts)
    sem = np.array([cls for cls, _, _ in boxes])[inst]
    rgb = np.clip(rng.uniform(-0.8, 0.8, (len(boxes), 3))[inst]
                  + rng.normal(0.0, 0.05, xyz.shape), -1.0, 1.0)
    cell = np.floor(xyz / S3DIS_SPP_CELL).astype(np.int64) + 1
    _, spp = np.unique(((inst * 64 + cell[:, 0]) * 64 + cell[:, 1]) * 64 + cell[:, 2],
                       return_inverse=True)
    xyz[:, :2] -= xyz[:, :2].mean(0)
    xyz[:, 2] -= xyz[:, 2].min()
    return dict(xyz=xyz.astype(np.float32), rgb=rgb.astype(np.float32),
                sem=sem.astype(np.int64), inst=inst.astype(np.int64), spp=spp.astype(np.int64))


def write_s3dis(root: str, label_type: str) -> dict:
    """Synthetic rooms in the layout ``S3DISDataset`` reads
    (``preprocess/<Area>_<room>_inst_nostuff.pth``, ``superpoints/``): the
    training rooms with seeded GP pseudo labels under ``label_type`` (the
    5-tuple of sem, inst, prob per point and mu, var per superpoint, drawn as
    ``gp_labels`` draws them), and the Area_5 rooms. Returns the points of
    each room."""
    import torch

    for sub in ("preprocess", "superpoints", label_type):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    names = [(f"Area_{S3DIS_TRAIN_AREAS[i % len(S3DIS_TRAIN_AREAS)]}_office_{i + 1}",
              S3DIS_BIG_ROOM_POINTS if i == 0 else S3DIS_ROOM_POINTS, True)
             for i in range(S3DIS_TRAIN_ROOMS)]
    names += [(f"Area_5_office_{i + 1}", S3DIS_ROOM_POINTS, False) for i in range(TEST_SCENES)]
    sizes = {}
    for seed, (name, n, train) in enumerate(names):
        r = s3dis_room(seed, n)
        torch.save((r["xyz"], r["rgb"], r["sem"], r["inst"]),
                   os.path.join(root, "preprocess", name + "_inst_nostuff.pth"))
        torch.save(r["spp"], os.path.join(root, "superpoints", name + ".pth"))
        if train:
            n_spp = int(r["spp"].max()) + 1
            lab = gp_labels(seed, n_spp)
            torch.save((r["sem"].astype(np.int32), r["inst"].astype(np.int32),
                        gp_labels(seed, n)["prob"], lab["mu"], lab["var"]),
                       os.path.join(root, label_type, name + ".pth"))
        sizes[name] = n
    return sizes


def s3dis_config(data_root: str, epochs: int = 1):
    """``ISBNET_S3DIS`` as the trainer and the test CLI read it, with the
    rooms under ``data_root``, ``epochs`` epochs and every voxel kept
    foreground (``filter_bg_thresh`` 0, as in the ScanNet phases: the
    untrained semantics put no class of 13 above 0.1, which would leave the
    aggregator, K4 and K5 no point)."""
    from gapro_tpu_torch.train.config import AttrDict

    cfg = AttrDict.wrap(ISBNET_S3DIS)
    cfg.data["data_root"] = data_root
    cfg.train["epochs"] = epochs
    cfg.model["filter_bg_thresh"] = 0.0
    return cfg


def s3dis_serve(model, cfg, room: dict, dev):
    """One S3DIS request as the test CLI serves it (``tools/test.py:serve_room``:
    the room split into its 4 interleaved pieces -> prepare ->
    ``forward_inference(x4_split=True)`` -> ``get_instances`` with the ceiling
    and floor from the semantics, the masks put back into the room's point
    order). Returns the prepared batch, the outputs, the instance records and
    each stage's milliseconds."""
    import torch

    from gapro_tpu_torch.tools import test as port_test
    from gapro_tpu_torch.tools import train as port_train

    stamps = [time.perf_counter()]
    ms = {}

    def stage(name):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ms[name] = (stamps[-1] - stamps[-2]) * 1e3

    prepared, out, inst = port_test.serve_room(model, cfg, room, port_train.make_prepare(cfg, dev),
                                               cfg.data.voxel.scale, "s3dis_room", stage)
    return prepared, out, inst, ms


def s3dis_phase(dev, root: str) -> dict:
    """ISBNet on S3DIS at full width (``ISBNET_S3DIS``) on synthetic rooms:
    the x4_split request (a cold one, then ``S3DIS_REQUESTS`` timed, the
    counts zeroed just before and read just after, peak memory), room 0
    through the plain versions, K4 at the merged room's stage 1 (past its
    on-chip capacity; and the points it would hold under the config's
    filter_bg_thresh), K5 at the request's three rounds and K1 (against
    fp64) at the merged plan's shapes; the grid
    ball query at the 1.5 times larger radius; the trainer at batch 4 (one
    cold and three timed steps, validation on the 2 Area_5 rooms, one
    checkpoint), one batch-4 step held against the plain versions with no
    admission, K1 and dfeats against fp64 on that step's own inputs, and
    the conv's backward kernels against their plain versions and timed at
    its shapes; the test CLI on the Area_5 rooms with x4_split, AP and
    mCov, mWCov, mPrec and mRec."""
    import torch

    from gapro_tpu_torch.data.augment import transform_test
    from gapro_tpu_torch.data.dataset import S3DISDataset, build_dataloader
    from gapro_tpu_torch.losses.criterion import CriterionConfig
    from gapro_tpu_torch.models import isbnet
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.tools import test as port_test
    from gapro_tpu_torch.tools import train as port_train

    t0 = time.perf_counter()
    cfg = s3dis_config(root)
    sizes = write_s3dis(root, cfg.data.label_type)
    scale = cfg.data.voxel.scale
    raw = [s3dis_room(1000 + i, S3DIS_ROOM_POINTS) for i in range(S3DIS_REQUESTS)]
    rooms = [transform_test(dict(xyz=r["xyz"], rgb=r["rgb"], spp=r["spp"]), scale) for r in raw]
    labels0 = raw[0]["sem"]
    del raw
    print(f"S3DIS: {len(sizes)} rooms written ({sum(sizes.values())} points; the training "
          f"rooms {S3DIS_ROOM_POINTS} points but one of {S3DIS_BIG_ROOM_POINTS}), "
          f"{S3DIS_REQUESTS} request rooms of {S3DIS_ROOM_POINTS} points, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mcfg = port_train.model_config(cfg)
    model = isbnet.ISBNet(mcfg, seed=0, device=dev)
    with torch.no_grad():
        model.inst_conf_head.dense2.bias += CONF_SHIFT

    # the x4_split request: one cold, then timed
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stages = s3dis_serve(model, cfg, rooms[0], dev)[3]
    print(f"S3DIS cold request, room 0: {(time.perf_counter() - t1) * 1e3:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()) + " ms)", flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    times, results = [], []
    for i, room in enumerate(rooms):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        prepared, out, inst, stages = s3dis_serve(model, cfg, room, dev)
        times.append((time.perf_counter() - t1) * 1e3)
        results.append((prepared, out, inst))
        b = prepared.batch
        # each piece numbers its own superpoints; those numbered past the
        # flat capacity are dropped before ovf_spp_slots counts anything
        n_ids = sum(len(np.unique(p["spp"])) for p in S3DISDataset.split_pieces(room))
        print(f"S3DIS request, room {i}: {len(room['xyz'])} points in 4 pieces, "
              f"{int(b.valid.sum())} voxels (capacity {b.valid.shape[0]}), {n_ids} superpoint "
              f"ids over the pieces against the flat capacity {b.n_spp} ("
              f"{max(0, n_ids - b.n_spp)} dropped, which no ovf_* counter counts), "
              f"{times[-1]:.1f} ms ("
              + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
              + f" ms), {len(inst)} instances (the first two the ceiling and floor), "
              + ", ".join(f"{k}={out[k]}" for k in sorted(out) if k.startswith("ovf_")),
              flush=True)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"S3DIS requests: launches over {S3DIS_REQUESTS} {launches}; median "
          f"{statistics.median(times):.1f} ms (all: {', '.join(f'{t:.1f}' for t in times)}); "
          f"peak device memory {peak:.2f} GiB", flush=True)
    n_conv = sum(k1_shape_counts(mcfg, range(mcfg.unet_levels)).values())
    if (launches["subm_conv"] != n_conv * S3DIS_REQUESTS or launches["fps"] != 4 * S3DIS_REQUESTS
            or launches["dyco"] != 3 * S3DIS_REQUESTS):
        fail(f"the S3DIS requests did not run through the kernels as expected: {launches}")
    for prepared, out, inst in results:
        q = sum(ROUNDS)
        for key, shape in (("mask_logits", (1, q, mcfg.spp_cap)), ("cls_logits", (1, q, 14)),
                           ("semantic_scores", (prepared.batch.valid.shape[0], 13))):
            if tuple(out[key].shape) != shape or not torch.isfinite(out[key]).all():
                fail(f"S3DIS {key}: shape {tuple(out[key].shape)} (want {shape}) or not finite")
        if [(x["label_id"], x["conf"]) for x in inst[:2]] != [(1, 1.0), (2, 1.0)] or len(inst) < 3:
            fail(f"S3DIS request: want the ceiling and floor first and NMS instances after, got "
                 f"{[(x['label_id'], x['conf']) for x in inst[:4]]} of {len(inst)}")

    # room 0 through the plain versions: every output within PATH_RTOL of
    # scale and every discrete output equal; the instance lists beside it
    with plain_kernels():
        _, out_plain, inst_plain, stages = s3dis_serve(model, cfg, rooms[0], dev)
    out0, inst0 = results[0][1], results[0][2]
    err = compare_outputs(out0, out_plain, PATH_RTOL, "S3DIS room 0 kernels vs plain")
    print(f"S3DIS plain versions, room 0: " + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + f" ms; agrees with the kernels (discrete equal, floats within {err:.3g} of scale); "
          + instance_diff(inst0, inst_plain, out0, out_plain), flush=True)
    del results, out_plain

    # K4 at the merged room's stage 1, K5 at the request's rounds
    fps_calls, dyco_calls = [], []
    with capture(fps_ops, "fps", fps_calls), capture(isbnet, "dyco_mlp", dyco_calls):
        prepared = s3dis_serve(model, cfg, rooms[0], dev)[0]
    xyz, valid, n_sample = fps_calls[0]
    count = int(valid.sum())
    on_chip = fps_ops.launch_shape(xyz.shape[1])["on_chip"]
    print(f"K4 at the merged S3DIS room's stage 1: {count} valid points of N={xyz.shape[1]}, "
          f"{on_chip} held on chip, {count - on_chip} spilled (read from L2, distances in "
          f"global memory)", flush=True)
    if count <= on_chip:
        fail(f"K4 at the merged S3DIS room did not spill: {count} valid, {on_chip} on chip")
    # The config's filter_bg_thresh (0.1) keeps a superpoint whose pooled
    # semantics reach it in any class but the last (clutter): with semantics
    # equal to the labels, every voxel that holds a point not of clutter.
    perm = port_test.split_room(rooms[0], scale)[1]
    kept = torch.from_numpy(labels0[perm] != ISBNET_S3DIS["model"]["semantic_classes"] - 1)
    p2v = prepared.point2voxel[:len(perm)].cpu()[kept]
    n_kept = int(torch.unique(p2v[p2v >= 0]).numel())
    print(f"K4 at the merged S3DIS room under the config's filter_bg_thresh "
          f"{ISBNET_S3DIS['model']['filter_bg_thresh']} with semantics equal to the labels: "
          f"{n_kept} valid points, {n_kept - on_chip} spilled", flush=True)
    k4 = k4_case(xyz, valid, n_sample, "S3DIS merged room, stage 1")
    k4.update(valid=count, spilled=count - on_chip, config_spilled=n_kept - on_chip)
    print("K5 at the S3DIS request's rounds:", flush=True)
    k5 = [k5_case(args, f"S3DIS round {i + 1}") for i, args in enumerate(dyco_calls)]
    plan = prepared.batch.plan
    caps = [lp.subm_nbr.shape[0] for lp in plan.levels]
    print(f"K1 at the merged S3DIS room's plan (4 pieces, levels {caps}):", flush=True)
    k1 = k1_phase(mcfg, caps, plan.levels, dev, row_orders=False)
    ball_query_phase(lambda: s3dis_serve(model, cfg, rooms[0], dev),
                     f"S3DIS room 0 (radius_scale {mcfg.radius_scale})")
    del model, prepared, plan, fps_calls, dyco_calls, xyz, valid
    torch.cuda.empty_cache()

    # the trainer at batch 4, one step against the plain versions
    work_dir = os.path.join(root, "work")
    train_ds = port_train.build_dataset(cfg, training=True)
    val_ds = port_train.build_dataset(cfg, training=False)
    trainer = trainer_phase(dev, work_dir, cfg, train_ds, dict(conv_need(mcfg), fps=1, dyco=1),
                            label="S3DIS trainer", val_ds=val_ds)
    step = s3dis_step_phase(dev, cfg, train_ds)
    torch.cuda.empty_cache()

    # the test CLI on the Area_5 rooms
    zero_counts()
    res = port_test.run_test(cfg, device=dev, dataset=val_ds, model=trainer["state"].model)
    cli_launches = read_counts()
    n_inst = [len(p) for p in res["preds"]]
    ap = {k: v for k, v in res["result"].items() if k in ("all_ap", "all_ap_50%", "all_ap_25%")}
    print(f"S3DIS test CLI (x4_split), {len(n_inst)} rooms: per room "
          + ", ".join(f"{t * 1e3:.1f}" for t in res["seconds"])
          + f" ms; instances {n_inst}; launches {cli_launches}; AP {json.dumps(ap)}; "
          + json.dumps(res["s3dis_result"]), flush=True)
    if (len(n_inst) != TEST_SCENES or not all(n_inst)
            or any(cli_launches[k] != n * TEST_SCENES
                   for k, n in (("fps", 4), ("dyco", 3), ("subm_conv", n_conv)))):
        fail(f"the S3DIS test CLI did not run as expected: {cli_launches}, instances {n_inst}")
    if not all(math.isfinite(v) for v in ap.values()):
        fail(f"S3DIS test CLI: AP {ap}")
    print(f"S3DIS phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(launches=launches, k1=k1, k4=k4, k5=k5, trainer=trainer, cli_launches=cli_launches,
                request_ms=times, **step)


def s3dis_step_phase(dev, cfg, train_ds) -> dict:
    """One S3DIS training step at batch 4 (the loader's first batch): held
    against its fp64 run (``fp64_hold``; the noise-run reading beside it),
    K1 and dfeats against fp64 on its own inputs, the conv's backward
    kernels against their plain versions and timed at its plan."""
    from gapro_tpu_torch.data.dataset import build_dataloader
    from gapro_tpu_torch.losses.criterion import CriterionConfig
    from gapro_tpu_torch.tools import train as port_train

    mcfg = port_train.model_config(cfg)
    loader = build_dataloader(train_ds, cfg.train.batch_size, training=True, seed=0, epoch=1,
                              num_workers=DATA_WORKERS)
    lb = next(loader)
    loader.close()
    prepared = port_train.make_prepare(cfg, dev)(lb.points, lb.batch_size)
    print(f"S3DIS batch {lb.batch_size}: {int(prepared.batch.valid.sum())} voxels from "
          f"{int(lb.points.valid.sum())} points (rooms {lb.scan_ids})", flush=True)
    what = f"S3DIS step, batch {lb.batch_size}"
    crit = CriterionConfig(**dict(cfg.criterion))
    hold = train_plain_compare(lambda: port_train.build_model(cfg, dev, seed=0)[0], prepared,
                               crit, what, fp64=True)
    step_drift = k1_step_drift(port_train.build_model(cfg, dev, seed=0)[0], prepared, crit, what)
    levels = prepared.batch.plan.levels
    print(f"conv backward at the {what}'s plan (levels "
          f"{[lp.subm_nbr.shape[0] for lp in levels]}):", flush=True)
    bwd_b4 = backward_kernel_phase(mcfg, [lp.subm_nbr.shape[0] for lp in levels], levels, dev,
                                   row_orders=False)
    conv_b4 = path_conv_times(mcfg, prepared.batch.plan, dev, what)
    return dict(conv_b4=conv_b4, bwd_b4=bwd_b4, step_drift=step_drift, fp64_hold=hold)


# ---- 16-18. the learning smoke, data-parallel training, self-training ----

LEARN_STEPS = 300  # tools/smoke_learn.py's default
LEARN_WINDOW = 20  # the loss falls: the last 20 steps' mean below the first 20's
# The two-rank step's reduction weights: both scenes real, then scene 0 with
# a filler (the train CLI's rule: rank 1 takes scene 0 again, weight 0).
DP_WEIGHTS = ((1.0, 1.0), (1.0, 0.0))
DP_SCENES = 8  # the --dp 2 epoch: four steps of one scene a rank
DP_VAL_SCENES = 1
SELFTRAIN_SCENES = 2


def learn_kernel_phase(dev) -> dict:
    """The kernels at the learning smoke's own shapes, each against its
    plain version: K1, dfeats and dW at every conv shape of the tool's
    ISBNet (C = 16, 4 levels, widths 16 to 64) and SPFormer (media 16) on
    scene 0's plan (``k1_phase``, ``backward_kernel_phase``; SPFormer's
    only where its shapes differ from ISBNet's); K4 and K5 (M = 16) on the
    very inputs that one ISBNet training step and one request of the tool
    give them, one case a shape (``k4_case``, ``k5_case``). Returns the
    sums of each model held and the K4 / K5 cases."""
    import torch

    from gapro_tpu_torch.models import dyco
    from gapro_tpu_torch.ops import fps as fps_ops
    from gapro_tpu_torch.tools import smoke_learn
    from gapro_tpu_torch.train.state import create_train_state

    scenes, preps = smoke_learn.make_preps(dev)
    pb, prepared = preps[0]
    levels = prepared.batch.plan.levels
    caps = [lp.subm_nbr.shape[0] for lp in levels]
    out, held = {}, []
    for name in ("isbnet", "spformer"):
        model, crit, make_step, serve = smoke_learn.build(name, dev)
        shapes = k1_shape_counts(model.cfg, caps)
        if shapes in held:
            print(f"learn, {name}: the same {len(shapes)} conv shapes as a model above, held "
                  f"there", flush=True)
            continue
        held.append(shapes)
        print(f"learn, {name}: the conv kernels at the tool's shapes (capacities {caps})",
              flush=True)
        out[name] = dict(k1=k1_phase(model.cfg, caps, levels, dev, row_orders=False))
        out[name]["dfeats"], out[name]["dw"] = backward_kernel_phase(model.cfg, caps, levels,
                                                                     dev, row_orders=False)
        if name != "isbnet":
            continue
        fps_calls, dyco_calls = [], []
        with capture(fps_ops, "fps_cuda", fps_calls), capture(dyco, "dyco_cuda", dyco_calls):
            st = create_train_state(model, lr=smoke_learn.LR[name])
            make_step(model, crit)(st, prepared, smoke_learn.LR[name])
            serve(scenes[0], pb, prepared)
        torch.cuda.synchronize()
        print(f"learn, {name}: K4 and K5 on one training step's and one request's own inputs:",
              flush=True)
        seen, out["k4"], out["k5"] = set(), [], []
        for xyz, valid, n_sample in fps_calls:
            key = ("fps", tuple(xyz.shape), n_sample)
            if key not in seen:
                seen.add(key)
                out["k4"].append(k4_case(xyz.detach().clone(), valid.clone(), n_sample,
                                         f"learning smoke, N={xyz.shape[1]} -> {n_sample}"))
        for args in dyco_calls:
            key = ("dyco", tuple(args[0].shape), tuple(args[-1].shape))
            if key not in seen:
                seen.add(key)
                out["k5"].append(k5_case(tuple(a.detach().clone() for a in args),
                                         "learning smoke"))
        if not out["k4"] or not out["k5"]:
            fail(f"learn, {name}: the step and the request launched K4 {len(fps_calls)} and "
                 f"K5 {len(dyco_calls)} times")
    return out


def learn_phase(dev) -> dict:
    """The learning smoke (``gapro_tpu_torch/tools/smoke_learn.py``) on the
    card, ISBNet and then SPFormer: first ``learn_kernel_phase``, the
    kernels at its shapes against their plain versions; then LEARN_STEPS
    steps over its two scenes, then both served and scored with
    ScanNetEval, the counts zeroed just before and read just after. Fails
    unless the loss falls (the last LEARN_WINDOW steps' mean below the
    first's), ``all_ap_25%`` passes the tool's floor (0.1) and every kernel
    of the model's path launched."""
    import torch

    from gapro_tpu_torch.tools import smoke_learn

    out = {"kernels": learn_kernel_phase(dev)}
    conv = ("subm_conv", "subm_conv_dfeats", "subm_conv_dw")
    for name, need in (("isbnet", conv + ("fps", "dyco")), ("spformer", conv)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res = smoke_learn.run(name, LEARN_STEPS, dev, log=None)
        torch.cuda.synchronize()
        launches = read_counts()
        losses, r = res["losses"], res["result"]
        first = statistics.mean(losses[:LEARN_WINDOW])
        last = statistics.mean(losses[-LEARN_WINDOW:])
        marks = list(range(0, LEARN_STEPS, 50)) + [LEARN_STEPS - 1]
        out[name] = dict(first=first, last=last, steps_per_s=LEARN_STEPS / res["seconds"],
                         ap=r["all_ap"], ap50=r["all_ap_50%"], ap25=r["all_ap_25%"],
                         peak_gib=torch.cuda.max_memory_allocated() / 2**30, launches=launches,
                         instances=res["instances"])
        print(f"learn, {name}: loss " + ", ".join(f"step {i} {losses[i]:.4f}" for i in marks)
              + f" (the first {LEARN_WINDOW} steps' mean {first:.4f}, the last {LEARN_WINDOW}'s "
              f"{last:.4f}); {LEARN_STEPS / res['seconds']:.2f} steps/s ({res['seconds']:.1f} s); "
              f"AP {r['all_ap']:.4f} AP50 {r['all_ap_50%']:.4f} AP25 {r['all_ap_25%']:.4f}; "
              f"instances {res['instances']}; peak device memory {out[name]['peak_gib']:.3f} "
              f"GiB; launches {launches}", flush=True)
        if not last < first:
            fail(f"learn, {name}: the loss did not fall ({first:.4f} -> {last:.4f})")
        if not r["all_ap_25%"] > smoke_learn.AP25_FLOOR:
            fail(f"learn, {name}: AP25 {r['all_ap_25%']:.4f} <= {smoke_learn.AP25_FLOOR}: the "
                 f"model failed to learn")
        if any(launches[k] == 0 for k in need):
            fail(f"learn, {name}: a kernel of the path never launched: {launches}")
    return out


def dp_model(cfg, device):
    """The model of ``cfg`` (an ``ISBNetConfig`` or an ``SPFormerConfig``),
    its weights from seed 0, and its step's loss function."""
    from gapro_tpu_torch.models import isbnet
    from gapro_tpu_torch.models.spformer import SPFormer, SPFormerConfig
    from gapro_tpu_torch.train import step

    if isinstance(cfg, SPFormerConfig):
        return SPFormer(cfg, seed=0, device=device), step._spformer_loss_fn
    return isbnet.ISBNet(cfg, seed=0, device=device), step._loss_fn


def dp_step_rank(rank, init_method, results, device_type, cfg, crit, bufs, shrink,
                 out_dir) -> None:
    """One of the two ranks of ``dp_step_phase``: a gloo group on one card;
    for each of DP_WEIGHTS, the model of ``cfg`` from seed 0 (``dp_model``:
    ISBNet or SPFormer, with its loss), replicated from rank 0, one
    ``make_dp_train_step`` step on this rank's buffer, timed by stage with
    the counts zeroed just before and read just after. Rank 0 saves the
    reduced gradients, statistics, losses and parameters; every rank
    reports its assignment, stage times, launches and state digest."""
    import torch
    import torch.distributed as dist

    from gapro_tpu_torch.models import prepare
    from gapro_tpu_torch.parallel.mesh import data_parallel_mesh, replicate
    from gapro_tpu_torch.tools.train import state_digest
    from gapro_tpu_torch.train import state, step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = data_parallel_mesh(2, rank, init_method, device_type)
    try:
        summary = []
        for i, w in enumerate(DP_WEIGHTS):
            model, model_loss = dp_model(cfg, group.device)
            replicate(model, group)
            st = state.create_train_state(model, lr=TRAIN_LR)
            assigns, stamps = [], []

            def loss_fn(m, prepared, crit, mark, model_loss=model_loss):
                res = model_loss(m, prepared, crit, mark=mark)
                assigns.append(res[1][1]["assign"].cpu())
                return res

            def mark(name):
                if group.device.type == "cuda":
                    torch.cuda.synchronize()
                stamps.append((name, time.perf_counter()))

            dp_step = step.make_dp_train_step(
                model, crit, group, loss_fn=loss_fn,
                prepare_fn=prepare.packed_prepare(cfg.unet_levels, cfg.spp_cap, shrink),
                on_stage=mark)
            buf = torch.from_numpy(bufs[i][rank]).to(group.device)
            zero_counts()
            mark("start")
            st, losses = dp_step(st, buf, TRAIN_LR, w[rank])
            launches = read_counts()
            ms = {name: (t - stamps[j][1]) * 1e3 for j, (name, t) in enumerate(stamps[1:])}
            if rank == 0:
                grads, stats = grads_and_stats(model)
                torch.save(dict(losses={k: float(v) for k, v in losses.items()},
                                grads={k: v.cpu() for k, v in grads.items()},
                                stats={k: v.cpu() for k, v in stats.items()},
                                params={k: p.detach().cpu() for k, p in model.named_parameters()}),
                           os.path.join(out_dir, f"weights{i}.pt"))
            # numpy, not tensors: a queue shares a tensor's memory with a
            # process that may have exited by the time it is read
            summary.append(dict(ms=ms, launches=launches, assign=assigns[0].numpy(),
                                digest=state_digest(st)))
        results.put((rank, dict(backend=group.backend, device=str(group.device),
                                steps=summary)))
    finally:
        dist.destroy_process_group()


def weighted_run(runs, w):
    """``sum(w * x) / max(sum(w), 1e-6)`` of the (losses, gradients,
    statistics) of one-scene runs, as the data-parallel step reduces them:
    a missing gradient counts as zeros where another run has one, the
    losses are reduced in fp32, and an integer buffer (a BatchNorm's step
    count) is not reduced."""
    import torch

    wsum = max(sum(w), 1e-6)
    mean = lambda xs: sum(wi * x for wi, x in zip(w, xs)) / wsum

    def grad(xs):
        have = [x for x in xs if x is not None]
        return mean([torch.zeros_like(have[0]) if x is None else x for x in xs]) if have else None

    losses = {k: float(mean([torch.tensor(r[0][k], dtype=torch.float32) for r in runs]))
              for k in runs[0][0]}
    grads = {k: grad([r[1][k] for r in runs]) for k in runs[0][1]}
    stats = {k: (mean([r[2][k] for r in runs]) if runs[0][2][k].is_floating_point()
                 else runs[0][2][k]) for k in runs[0][2]}
    return losses, grads, stats


def zero_fill(dp_grads: dict, others: list) -> None:
    """Zeros, in place, in each of ``others`` where a parameter has no
    gradient but the data-parallel step's has one: that step gives every
    trained parameter a gradient (zeros where the loss does not reach it,
    as ``jax.grad`` does), so the ranks sum tensors of one shape."""
    import torch

    for k, g in dp_grads.items():
        for grads in others:
            if grads.get(k) is None and g is not None:
                grads[k] = torch.zeros_like(g)


def equal_step(got: tuple, want: tuple, what: str, noise_fn) -> str:
    """The data-parallel step's (losses, reduced gradients, statistics)
    against its emulation's, which runs the same kernels on the same inputs
    and reduces by the same sum: every loss (in fp32), gradient leaf and
    BatchNorm statistic equal bit for bit. Where one differs, ``compare_step``
    prints how far, with ``noise_fn()``'s two one-ulp runs as its noise, as
    the diagnosis, and the phase fails."""
    import numpy as np
    import torch

    (lg, gg, sg), (lw, gw, sw) = got, want
    differ = [f"loss {k}" for k in lw if np.float32(lg[k]) != np.float32(lw[k])]
    for k, w in gw.items():
        a = gg[k]
        if (a is None) != (w is None) or (w is not None and not torch.equal(a.cpu(), w.cpu())):
            differ.append(f"gradient {k}")
    differ += [f"statistic {k}" for k, w in sw.items() if not torch.equal(sg[k].cpu(), w.cpu())]
    n_grads = sum(g is not None for g in gw.values())
    if differ:
        print(f"{what}: {len(differ)} of {len(lw)} losses, {n_grads} gradient leaves and "
              f"{len(sw)} statistics differ bit for bit: " + ", ".join(differ[:12])
              + "; the diagnosis:", flush=True)
        compare_step(got, want, PATH_RTOLS, what, noise=noise_fn())
        fail(f"{what}: {len(differ)} values differ bit for bit from the emulation: "
             + ", ".join(differ[:12]))
    return (f"the {len(lw)} losses, {n_grads} gradient leaves and {len(sw)} statistics equal "
            f"bit for bit")


def dp_step_phase(dev, cfg, pbs, what: str, shrink=FULL_SHRINK, crit=None) -> dict:
    """The data-parallel step (``train/step.py:make_dp_train_step``) of the
    model of ``cfg`` (ISBNet, or SPFormer with ``_spformer_loss_fn``;
    ``crit`` its criterion's config, ISBNet's at INST_CAP by default) on two
    gloo ranks on one card, against an emulation in this process: each
    scene's kernel-path step from the same initial weights (seed 0), with
    that rank's own assignment, reduced by the same formula, at each of
    DP_WEIGHTS. The emulation runs the same kernels on the same inputs and
    a sum of two terms is exact, so ``equal_step`` holds the losses, the
    reduced gradients and the BatchNorm statistics to it bit for bit
    (``compare_step``, with the emulation's one-ulp runs in both directions
    as its noise, only prints the diagnosis where they differ), and the
    parameters must equal AdamW's on the emulation's gradients bit for bit.
    Both ranks' states must agree bit for bit. Then a world-size-1 NCCL
    group in this process: the same step on scene 0, equal bit for bit to
    the single-device step's (``make_train_step``, or
    ``make_spformer_train_step``). ``pbs``: the two scenes' point batches.
    Returns the ranks' stage times and launches."""
    import torch
    import torch.distributed as dist

    from gapro_tpu_torch import cuda_build
    from gapro_tpu_torch.losses.criterion import CriterionConfig
    from gapro_tpu_torch.models import prepare
    from gapro_tpu_torch.models.spformer import SPFormerConfig
    from gapro_tpu_torch.parallel.mesh import (data_parallel_mesh, free_port, replicate,
                                               spawn_ranks)
    from gapro_tpu_torch.train import state, step

    if dev.type == "cuda":
        cuda_build.build_all()  # once, here: the ranks only load the libraries
    crit = crit or CriterionConfig(inst_cap=INST_CAP)
    spformer = isinstance(cfg, SPFormerConfig)
    packed = [prepare.pack_point_batch_np(pb) for pb in pbs]
    bufs = [[packed[0], packed[1]], [packed[0], packed[0]]]
    out_dir = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_ranks(dp_step_rank, 2, dev.type, cfg, crit, bufs, shrink, out_dir,
                        timeout_s=900.0)
    print(f"{what}: two ranks on {ranks[0]['device']} and {ranks[1]['device']}, backend "
          f"{ranks[0]['backend']}; spawn to exit {time.perf_counter() - t0:.1f} s", flush=True)

    prepare_fn = prepare.packed_prepare(cfg.unet_levels, cfg.spp_cap, shrink)
    prepared_of = lambda buf: prepare_fn(torch.from_numpy(buf).to(dev))

    runs = {}  # (scene, assignment) -> its run
    one = lambda p, assign: one_step_grads(dp_model(cfg, dev)[0], p, crit,
                                           assign=torch.from_numpy(assign).to(dev))[0]

    def scene_run(scene, assign):
        key = (scene, assign.tobytes())
        if key not in runs:
            runs[key] = one(prepared_of(packed[scene]), assign)
        return runs[key]

    def noise_runs(scenes, assigns, w, dp_grads):
        """The emulation's two one-ulp runs, for the diagnosis."""
        out = [weighted_run([one(nudged(prepared_of(packed[sc]), d), a)
                             for sc, a in zip(scenes, assigns)], w) for d in NUDGES]
        zero_fill(dp_grads, [n[1] for n in out])
        return out

    def adamw(grads):
        """The parameters after one AdamW step from seed 0 on ``grads``."""
        model = dp_model(cfg, dev)[0]
        st = state.create_train_state(model, lr=TRAIN_LR)
        for k, p in model.named_parameters():
            p.grad = None if grads[k] is None else grads[k].to(dev)
        st.apply_gradients(lr=TRAIN_LR)
        return {k: p.detach().cpu() for k, p in model.named_parameters()}

    def same_params(got, want, label):
        differ = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
        if differ:
            fail(f"{label}: {len(differ)} parameters after AdamW differ bit for bit: "
                 f"{differ[:8]}")

    out = dict(ranks=ranks)
    for i, w in enumerate(DP_WEIGHTS):
        label = f"{what}, weights {list(w)}"
        scenes = [0, 1] if i == 0 else [0, 0]
        for r in (0, 1):
            st = ranks[r]["steps"][i]
            print(f"{label}, rank {r} (scene {scenes[r]}): {stage_line(st['ms'])}"
                  + (" (the ranks' first step: cold)" if i == 0 else "")
                  + f"; launches {st['launches']}", flush=True)
        if ranks[0]["steps"][i]["digest"] != ranks[1]["steps"][i]["digest"]:
            fail(f"{label}: the two ranks' weights, statistics and optimizer states differ")
        real = [r for r in (0, 1) if w[r] > 0]
        assigns = [ranks[r]["steps"][i]["assign"] for r in real]
        ww = [w[r] for r in real]
        emu = weighted_run([scene_run(scenes[r], a) for r, a in zip(real, assigns)], ww)
        got = torch.load(os.path.join(out_dir, f"weights{i}.pt"), weights_only=False)
        dp = (got["losses"], got["grads"], got["stats"])
        zero_fill(dp[1], [emu[1]])
        summary = equal_step(dp, emu, f"{label}, two ranks vs the emulation",
                             lambda: noise_runs([scenes[r] for r in real], assigns, ww, dp[1]))
        same_params(got["params"], adamw(emu[1]), label)
        print(f"{label}: the two ranks against the emulation: {summary}; the parameters after "
              f"AdamW equal AdamW's on the emulation's gradients bit for bit; both ranks equal "
              f"bit for bit", flush=True)
        del got, dp, emu
    shutil.rmtree(out_dir)

    # a world-size-1 NCCL group: the backend a run with a card a rank takes
    group = data_parallel_mesh(1, 0, f"tcp://localhost:{free_port()}", dev.type)
    try:
        model, loss_fn = dp_model(cfg, dev)
        replicate(model, group)
        st = state.create_train_state(model, lr=TRAIN_LR)
        dp_step = step.make_dp_train_step(model, crit, group, loss_fn=loss_fn,
                                          prepare_fn=prepare_fn)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, losses = dp_step(st, torch.from_numpy(packed[0]).to(dev), TRAIN_LR, 1.0)
        torch.cuda.synchronize()
        nccl_ms = (time.perf_counter() - t0) * 1e3
        out["nccl_launches"] = read_counts()
        got = ({k: float(v) for k, v in losses.items()}, *grads_and_stats(model))
        got_params = {k: p.detach().clone() for k, p in model.named_parameters()}
    finally:
        dist.destroy_process_group()
    single = dp_model(cfg, dev)[0]
    sst = state.create_train_state(single, lr=TRAIN_LR)
    make_single = step.make_spformer_train_step if spformer else step.make_train_step
    sst, slosses = make_single(single, crit)(sst, prepared_of(packed[0]), TRAIN_LR)
    want = ({k: float(v) for k, v in slosses.items()}, *grads_and_stats(single))
    zero_fill(got[1], [want[1]])
    label = f"{what}, NCCL world size 1 vs {make_single.__name__}"
    summary = equal_step(got, want, label, lambda: noise_runs(
        [0], [ranks[0]["steps"][0]["assign"]], [1.0], got[1]))
    same_params(got_params, {k: p.detach().cpu() for k, p in single.named_parameters()}, label)
    print(f"{what}: a world-size-1 group, backend {group.backend}: the step {nccl_ms:.1f} ms, "
          f"launches {out['nccl_launches']}; against {make_single.__name__}: {summary}, and the "
          f"parameters after AdamW", flush=True)
    out["nccl_backend"], out["nccl_ms"] = group.backend, nccl_ms
    return out


def dp_trainer_phase(dev, work_dir: str, cfg=None, label: str = "--dp 2 trainer") -> dict:
    """``tools/train.py:train_dp`` on ``cfg`` (``full_config()`` unless
    given; ``spformer_config()`` trains SPFormer) with 2 ranks on one card
    (gloo) for one epoch of DP_SCENES bench scenes with seeded GP labels,
    validation on DP_VAL_SCENES scene by rank 0, then a resume from its
    checkpoint: every rank's weights, statistics, optimizer state and step
    equal bit for bit to rank 0's at the end of the epoch. Prints each
    rank's step times (host clock; the two ranks share one card, so they
    are no speedup)."""
    from gapro_tpu_torch.data.dataset import SyntheticDataset
    from gapro_tpu_torch.tools import train as port_train

    cfg = cfg or full_config()
    vc = port_train.voxel_cfg(cfg)
    train_ds = GPLabelled(SyntheticDataset(n_scenes=DP_SCENES, training=True, voxel_cfg=vc,
                                           **FULL_SCENE))
    val_ds = SyntheticDataset(n_scenes=DP_VAL_SCENES, training=False, voxel_cfg=vc, **FULL_SCENE)
    t0 = time.perf_counter()
    res = port_train.train_dp(cfg, work_dir, 2, device=dev, dataset=train_ds, val_dataset=val_ds,
                              val_scenes=DP_VAL_SCENES, num_workers=DATA_WORKERS)
    wall = time.perf_counter() - t0
    rec = res["records"][-1]
    for r in res["ranks"]:
        print(f"{label}, rank {r['rank']} on {r['device']} ({r['backend']}): "
              f"{len(r['step_s'])} steps of one scene, "
              + ", ".join(f"{1e3 * s:.1f}" for s in r["step_s"]) + " ms (the first cold)",
              flush=True)
    print(f"{label}: one epoch of {DP_SCENES} scenes in {wall:.1f} s (spawn to exit); "
          f"loss {rec['loss']:.4f}, lr {rec['lr']:.3g}; rank 0's validation on {DP_VAL_SCENES} "
          f"scene: " + " ".join(f"{k} {v:.4f}" for k, v in rec.items() if k.startswith("val_")),
          flush=True)
    steps = {r["steps"] for r in res["ranks"]}
    if steps != {DP_SCENES // 2} or len({r["digest"] for r in res["ranks"]}) != 1:
        fail(f"{label}: steps {steps}, or the ranks' states differ")
    if "val_ap" not in rec or not math.isfinite(rec["loss"]):
        fail(f"{label}: no validation or a loss not finite: {rec}")
    again = port_train.train_dp(cfg, work_dir, 2, device=dev, dataset=train_ds,
                                skip_validate=True, resume=os.path.join(work_dir, "latest"))
    digests = {r["digest"] for r in again["ranks"]}
    if digests != {res["ranks"][0]["digest"]} or again["records"]:
        fail(f"{label}: a resumed rank differs from the epoch's end")
    latest = os.path.basename(os.path.realpath(os.path.join(work_dir, "latest")))
    print(f"{label}: resumed from {latest} on both ranks, each equal bit for bit to "
          f"rank 0 at the epoch's end (weights, BatchNorm statistics, optimizer state, step "
          f"{DP_SCENES // 2})", flush=True)
    return dict(step_s=[r["step_s"] for r in res["ranks"]], wall_s=wall, record=rec)


def write_scannet(root: str, n: int) -> list:
    """``n`` bench scenes in the layout ``ScanNetDataset`` and ``gen_ps``
    read: ``train/<scan>_inst_nostuff.pth`` (xyz, rgb, raw semantics,
    instances) and ``superpoints/<scan>.pth``; scene 0 also under ``val/``.
    Returns the scan ids."""
    import torch

    from gapro_tpu_torch.data import make_synthetic_scene

    scans = []
    for sub in ("train", "val", "superpoints"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        s = make_synthetic_scene(seed=i, **FULL_SCENE)
        scan = f"scene{i:04d}_00"
        rec = (s.xyz, s.rgb, s.semantic_label.astype(np.int64),
               s.instance_label.astype(np.int64))
        for sub in ("train", "val") if i == 0 else ("train",):
            torch.save(rec, os.path.join(root, sub, scan + "_inst_nostuff.pth"))
        torch.save(np.asarray(s.spp, np.int64), os.path.join(root, "superpoints", scan + ".pth"))
        scans.append(scan)
    return scans


def selftrain_phase(dev, checkpoint: str, root: str) -> dict:
    """GaPro's self-training loop at full width on SELFTRAIN_SCENES bench
    scenes written in ScanNet's layout: ``export_features`` from the
    trainer phase's weights, ``gen_ps --use_deepfeat`` on those files, one
    epoch of the trainer on the labels it wrote (the config's batch 4 over
    the scenes' repeat 4), and the test CLI with ``--save_pointwise`` on
    one scene, its three directories checked for shape and dtype; each
    stage timed, counts zeroed just before and read just after."""
    import torch

    from gapro_tpu_torch.data.scannet_io import load_pseudo_labels
    from gapro_tpu_torch.tools import export_features, gen_ps
    from gapro_tpu_torch.tools import test as port_test
    from gapro_tpu_torch.tools import train as port_train

    scans = write_scannet(root, SELFTRAIN_SCENES)
    cfg = full_config()
    cfg.data.update(data_root=root, prefix_val="train", label_type="gp_deepfeat_ps")
    times, launches = {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        launches[name] = read_counts()
        return r

    feats = os.path.join(root, "maskfeats")
    written = stage("export_features", lambda: export_features.export_features(
        cfg, checkpoint, feats, device=dev))
    for scan, _, shape in written:
        f = np.asarray(torch.load(os.path.join(feats, scan + ".pth"), weights_only=False))
        if f.dtype != np.float32 or f.shape != shape or f.shape[1] != 32 or \
                not np.isfinite(f).all():
            fail(f"export_features {scan}: {f.dtype} {f.shape}, finite {np.isfinite(f).all()}")
    ps = os.path.join(root, "gp_deepfeat_ps")
    rc = stage("gen_ps --use_deepfeat", lambda: gen_ps.main([
        "--data_root", root, "--split", "train", "--save_folder", ps, "--use_deepfeat",
        "--deepfeat_folder", feats, "--device", str(dev)]))
    if rc != 0 or sorted(os.listdir(ps)) != sorted(s + ".pth" for s in scans):
        fail(f"gen_ps --use_deepfeat: rc {rc}, wrote {sorted(os.listdir(ps))}")
    for scan in scans:
        sem, inst, prob, mu, var = load_pseudo_labels(os.path.join(ps, scan + ".pth"))
        if not (np.isfinite(mu).all() and np.isfinite(var).all() and (inst >= 0).any()):
            fail(f"gen_ps --use_deepfeat {scan}: labels not finite or no instance")
    work = os.path.join(root, "run")
    res = stage("train, one epoch", lambda: port_train.train(
        cfg, work, device=dev, skip_validate=True))
    rec = res["records"][-1]
    if not math.isfinite(rec["loss"]) or res["state"].step != 2:
        fail(f"selftrain: training on the written labels: {rec}, step {res['state'].step}")
    del res
    test_cfg = full_config()
    test_cfg.data.update(data_root=root, prefix_val="val")
    pw = os.path.join(root, "pointwise")
    stage("test --save_pointwise", lambda: port_test.run_test(
        test_cfg, os.path.join(work, "latest"), device=dev, pointwise=pw))
    n = len(torch.load(os.path.join(root, "val", scans[0] + "_inst_nostuff.pth"),
                       weights_only=False)[0])
    for sub, dtype, shape in (("semantic_pred", np.int32, (n,)),
                              ("offset_pred", np.float32, (n, 3)),
                              ("offset_vertices_pred", np.float32, (n, 6))):
        a = np.load(os.path.join(pw, sub, scans[0] + ".npy"))
        if a.dtype != dtype or a.shape != shape or not np.isfinite(a).all():
            fail(f"--save_pointwise {sub}: {a.dtype} {a.shape} (want {dtype.__name__} {shape})")
    print(f"selftrain, {SELFTRAIN_SCENES} bench scenes: "
          + "; ".join(f"{k} {v:.1f} s, launches {launches[k]}" for k, v in times.items())
          + f"; the epoch on the written labels: loss {rec['loss']:.4f} (kl_loss "
          f"{rec['kl_loss']:.4f}); --save_pointwise: 3 dirs of {n} points", flush=True)
    need = {"export_features": ("subm_conv", "fps"),
            "train, one epoch": ("subm_conv", "subm_conv_dfeats", "subm_conv_dw", "fps", "dyco"),
            "test --save_pointwise": ("subm_conv", "fps", "dyco")}
    for name, kernels in need.items():
        if any(launches[name][k] == 0 for k in kernels):
            fail(f"selftrain, {name}: a kernel of the path never launched: {launches[name]}")
    return dict(seconds=times, launches=launches)


# ---- 19-22. the labeler across devices, offline data preparation, the
# reference-checkpoint loader and the library functions (PR 12) ---------


def labeler_multidev_phase(dev) -> dict:
    """bench.py's 16-scene sweep (LABELER_PRESETS) through
    ``generate_scene_labels_stream`` with three device lists: [cuda:0];
    every visible card, or [cuda:0, cuda:0] on one card (the round-robin
    and the threads run, on one card); and the second with
    ``batch_submit``. sem, inst and the superpoint map equal, prob, mu and
    var within ``labeler_gate``'s bound; scenes/s of each (one pass each,
    after a warm pass of the first)."""
    import torch

    from gapro_tpu_torch.data import make_synthetic_scene
    from gapro_tpu_torch.labeler import LabelerConfig, generate_scene_labels_stream
    from gapro_tpu_torch.labeler import pipeline as lp

    t0 = time.perf_counter()
    scenes = [make_synthetic_scene(seed=s, **LABELER_PRESETS["default"])
              for s in range(LABELER_SCENES)]
    n = torch.cuda.device_count()
    one = [torch.device("cuda", 0)]
    many = [torch.device("cuda", i) for i in range(n)] if n > 1 else one * 2
    named = "[" + ", ".join(str(d) for d in many) + "]"
    lists = (("[cuda:0]", dict(devices=one)),
             (f"{named} ({'every card' if n > 1 else 'one card, twice'})", dict(devices=many)),
             (f"{named}, batch_submit", dict(devices=many, batch_submit=True)))

    def sweep(kw):
        rec = {}
        with record_fits(lp, rec):
            t = time.perf_counter()
            rec["labels"] = [out for _, out in generate_scene_labels_stream(
                (labeler_inputs(s) for s in scenes), LabelerConfig(), window=LABELER_WINDOW,
                **kw)]
            sec = time.perf_counter() - t
        return rec, sec

    sweep(lists[0][1])  # warm
    runs, rates = [], {}
    for name, kw in lists:
        rec, sec = sweep(kw)
        rates[name] = LABELER_SCENES / sec
        runs.append(rec)
        print(f"labeler across devices, {name}: {sec:.3f} s = {rates[name]:.3f} scenes/s",
              flush=True)
    for (name, _), rec in zip(lists[1:], runs[1:]):
        for s, (a, b) in enumerate(zip(rec["labels"], runs[0]["labels"])):
            for k, what in ((0, "sem"), (1, "inst"), (5, "the superpoint map")):
                if not np.array_equal(a[k], b[k]):
                    fail(f"labeler across devices, {name}: scene {s}'s {what} differs from "
                         f"[cuda:0]'s")
        numbers, bad = labeler_gate(rec, runs[0], LABELER_WINDOW)
        if bad:
            fail(f"labeler across devices, {name} against [cuda:0]: " + "; ".join(bad))
        bitwise = same_labels(rec["labels"], runs[0]["labels"])
        print(f"labeler across devices, {name}: labels equal to [cuda:0]'s; fits within "
              f"{numbers['fit_ratio']:.3g} of the bound; {numbers['jobs']} jobs; every output "
              f"{'equal bit for bit' if bitwise else 'NOT bit-identical (within the bound)'}",
              flush=True)
    print(f"labeler across devices: {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(rates=rates, cards=n)


# The raw ScanNet scan prepare_phase writes: a room of triangulated grids
# (floor, four walls) and RAW_OBJECTS boxes on the floor, each face a grid
# of RAW_GRID x RAW_GRID vertices; about 150,000 vertices and 300,000 faces,
# the size of a ScanNet v2 mesh (*_vh_clean_2.ply).
RAW_ROOM = (8.0, 6.0, 2.5)  # m
RAW_FLOOR_GRID = (200, 150)
RAW_WALL_ROWS = 60
RAW_OBJECTS = 14
RAW_GRID = 30
RAW_PATCH = 10  # vertices a side of one over-segmentation patch (segs.json)
# (raw category, NYU40 id): the wall and floor groups, then the objects'
RAW_CLASSES = (("wall", 1), ("floor", 2), ("cabinet", 3), ("bed", 4), ("chair", 5),
               ("sofa", 6), ("table", 7))
S3DIS_RAW_POINTS = 250_000


def raw_scan_mesh(seed: int = 0) -> dict:
    """The synthetic room mesh: vertices [V, 3] float32, faces [F, 3],
    colours [V, 3] uint8, each vertex's NYU40 label, over-segment id and
    object group (-1 for the wall and floor), and the groups' raw names."""
    rng = np.random.default_rng(seed)
    w, d, h = RAW_ROOM
    planes = [((0, 0, 0), (w, 0, 0), (0, d, 0), RAW_FLOOR_GRID, 1, -1)]
    rows = RAW_WALL_ROWS
    for o, u, v, nu in (((0, 0, 0), (w, 0, 0), (0, 0, h), RAW_FLOOR_GRID[0]),
                        ((0, d, 0), (w, 0, 0), (0, 0, h), RAW_FLOOR_GRID[0]),
                        ((0, 0, 0), (0, d, 0), (0, 0, h), RAW_FLOOR_GRID[1]),
                        ((w, 0, 0), (0, d, 0), (0, 0, h), RAW_FLOOR_GRID[1])):
        planes.append((o, u, v, (nu, rows), 0, -1))
    names = []
    for k in range(RAW_OBJECTS):
        cls = 2 + k % (len(RAW_CLASSES) - 2)
        size = rng.uniform(0.4, 1.2, 3)
        lo = np.array([rng.uniform(0.2, w - size[0] - 0.2), rng.uniform(0.2, d - size[1] - 0.2),
                       0.0])
        hi = lo + size
        for axis in range(3):  # the two faces normal to ``axis``
            a, b = [i for i in range(3) if i != axis]
            for side in (lo, hi):
                o = lo.copy()
                o[axis] = side[axis]
                u, v = np.zeros(3), np.zeros(3)
                u[a], v[b] = size[a], size[b]
                planes.append((o, u, v, (RAW_GRID, RAW_GRID), cls, k))
        names.append(RAW_CLASSES[cls][0])
    verts, faces, cols, label, seg, group = [], [], [], [], [], []
    n_seg = 0
    for o, u, v, (nu, nv), cls, k in planes:
        i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
        p = (np.asarray(o, np.float64) + np.outer(i.ravel() / (nu - 1), u)
             + np.outer(j.ravel() / (nv - 1), v) + rng.normal(0.0, 0.001, (nu * nv, 3)))
        base = sum(len(x) for x in verts)
        a = (i[:-1, :-1] * nv + j[:-1, :-1]).ravel() + base
        faces.append(np.concatenate([np.stack([a, a + nv, a + 1], 1),
                                     np.stack([a + 1, a + nv, a + nv + 1], 1)]))
        verts.append(p)
        colour = rng.integers(40, 216, 3)
        cols.append(np.clip(colour + rng.integers(-12, 13, (nu * nv, 3)), 0, 255))
        label.append(np.full(nu * nv, RAW_CLASSES[cls][1]))
        patch = (i // RAW_PATCH * ((nv - 1) // RAW_PATCH + 1) + j // RAW_PATCH).ravel()
        seg.append(n_seg + patch)
        n_seg += int(patch.max()) + 1
        group.append(np.full(nu * nv, k))
    return dict(verts=np.concatenate(verts).astype(np.float32), faces=np.concatenate(faces),
                rgb=np.concatenate(cols).astype(np.uint8), label=np.concatenate(label),
                seg=np.concatenate(seg), group=np.concatenate(group), names=names)


def write_ply(path: str, vertex: np.ndarray, faces: np.ndarray) -> None:
    """A binary little-endian PLY: ``vertex`` a structured array (float x, y,
    z, uchar colours, [ushort label]), faces as ``list uchar int``."""
    ply_type = {"<f4": "float", "|u1": "uchar", "<u2": "ushort"}
    head = ["ply", "format binary_little_endian 1.0", f"element vertex {len(vertex)}"]
    head += [f"property {ply_type[vertex.dtype[n].str]} {n}" for n in vertex.dtype.names]
    head += [f"element face {len(faces)}", "property list uchar int vertex_indices",
             "end_header"]
    rec = np.empty(len(faces), [("n", "u1"), ("i", "<i4", (3,))])
    rec["n"], rec["i"] = 3, faces
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode("ascii"))
        f.write(vertex.tobytes())
        f.write(rec.tobytes())


def write_raw_scan(scans_dir: str, scan: str, mesh: dict) -> str:
    """``mesh`` as ScanNet's raw files: ``<scan>_vh_clean_2.ply``, its
    ``.labels.ply``, ``.0.010000.segs.json``, ``<scan>.aggregation.json``,
    and the label table. Returns the table's path."""
    os.makedirs(scans_dir, exist_ok=True)
    base = os.path.join(scans_dir, scan)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("red", "u1"), ("green", "u1"),
              ("blue", "u1"), ("alpha", "u1")]
    v = np.empty(len(mesh["verts"]), fields)
    for i, c in enumerate("xyz"):
        v[c] = mesh["verts"][:, i]
    for i, c in enumerate(("red", "green", "blue")):
        v[c] = mesh["rgb"][:, i]
    v["alpha"] = 255
    write_ply(base + "_vh_clean_2.ply", v, mesh["faces"])
    lab = np.empty(len(v), fields + [("label", "<u2")])
    for name in v.dtype.names:
        lab[name] = v[name]
    lab["label"] = mesh["label"]
    write_ply(base + "_vh_clean_2.labels.ply", lab, mesh["faces"])
    with open(base + "_vh_clean_2.0.010000.segs.json", "w") as f:
        json.dump({"segIndices": mesh["seg"].tolist()}, f)
    groups = [{"label": name, "segments": []} for name in ("wall", "floor")]
    groups += [{"label": name, "segments": np.unique(mesh["seg"][mesh["group"] == k]).tolist()}
               for k, name in enumerate(mesh["names"])]
    walls = np.unique(mesh["seg"][(mesh["group"] == -1) & (mesh["label"] == 1)])
    floor = np.unique(mesh["seg"][(mesh["group"] == -1) & (mesh["label"] == 2)])
    groups[0]["segments"], groups[1]["segments"] = walls.tolist(), floor.tolist()
    with open(base + ".aggregation.json", "w") as f:
        json.dump({"segGroups": [dict(id=i, objectId=i, **g) for i, g in enumerate(groups)]}, f)
    tsv = os.path.join(scans_dir, "scannetv2-labels.combined.tsv")
    with open(tsv, "w") as f:
        f.write("id\traw_category\tcategory\tcount\tnyu40id\teigen13id\tnyu40class\t"
                "nyu40class2\n")
        for name, nyu in RAW_CLASSES:
            f.write(f"{nyu}\t{name}\tx\t1\t{nyu}\tx\t{name}\t{name}\n")
    return tsv


S3DIS_CLASS_NAMES = ("ceiling", "floor", "wall", "beam", "column", "window", "door", "chair",
                     "table", "bookcase", "sofa", "board", "clutter")


def write_s3dis_raw(data_dir: str, room: dict) -> str:
    """``room`` (``s3dis_room``) as the Stanford aligned dataset's text
    files: ``Area_5/office_1/Annotations/<class>_<k>.txt``, one object a
    file, ``x y z r g b`` a line. Returns the room's directory."""
    ann = os.path.join(data_dir, "Area_5", "office_1", "Annotations")
    os.makedirs(ann, exist_ok=True)
    rgb = np.rint((room["rgb"] + 1.0) * 127.5).astype(np.int64)
    for k in np.unique(room["inst"]):
        m = room["inst"] == k
        cls = S3DIS_CLASS_NAMES[int(room["sem"][m][0])]
        np.savetxt(os.path.join(ann, f"{cls}_{k}.txt"),
                   np.concatenate([room["xyz"][m], rgb[m]], 1), fmt="%.4f %.4f %.4f %d %d %d")
    return os.path.dirname(ann)


def prepare_phase(dev, root: str) -> dict:
    """Raw data -> the port's preparation tools -> its datasets -> the card.
    A raw ScanNet scan at full size (``raw_scan_mesh``) through
    ``prepare_scannet``'s CLI (the segmentator built from its source at
    first use, ``segment_mesh`` timed alone), loaded by ``ScanNetDataset``
    and served as one full-width ISBNet request (seed-0 weights, as phase
    4's), held against the plain versions; then a synthetic S3DIS room of S3DIS_RAW_POINTS
    points written as text through ``prepare_s3dis``'s CLI and loaded by
    ``S3DISDataset``."""
    import types

    import torch

    from gapro_tpu_torch.data.dataset import S3DISDataset, ScanNetDataset, build_dataloader
    from gapro_tpu_torch.models import isbnet
    from gapro_tpu_torch.native import segmentator
    from gapro_tpu_torch.tools import prepare_s3dis, prepare_scannet

    t0 = time.perf_counter()
    mesh = raw_scan_mesh()
    scans = os.path.join(root, "scans")
    tsv = write_raw_scan(scans, "scene0000_00", mesh)
    t_write = time.perf_counter() - t0
    segmentator.LIB.unlink(missing_ok=True)
    t1 = time.perf_counter()
    segmentator.build()
    t_build = time.perf_counter() - t1
    xyz = mesh["verts"] - mesh["verts"].mean(0)
    t1 = time.perf_counter()
    spp = segmentator.segment_mesh(xyz, mesh["faces"])
    t_seg = time.perf_counter() - t1
    out = os.path.join(root, "scannetv2")
    t1 = time.perf_counter()
    if prepare_scannet.main(["--scans_dir", scans, "--out", out, "--split", "val",
                             "--labels_tsv", tsv]) != 0:
        fail("prepare_scannet's CLI failed")
    t_cli = time.perf_counter() - t1
    ds = ScanNetDataset(out, prefix="val", training=False)
    scene = ds.load(0)
    n_inst = len(np.unique(scene["instance"][scene["instance"] >= 0]))
    if (len(ds) != 1 or len(scene["xyz"]) != len(mesh["verts"]) or n_inst != RAW_OBJECTS
            or not np.array_equal(np.unique(scene["spp"], return_inverse=True)[1],
                                  np.unique(spp, return_inverse=True)[1])):
        fail(f"the prepared scan is not the raw one: {len(scene['xyz'])} points of "
             f"{len(mesh['verts'])}, {n_inst} instances of {RAW_OBJECTS}")
    print(f"prepare, ScanNet: a raw scan of {len(mesh['verts'])} vertices and "
          f"{len(mesh['faces'])} faces written in {t_write:.2f} s; the segmentator built in "
          f"{t_build:.2f} s (g++, into {segmentator.LIB.parent.name}/); segment_mesh "
          f"{t_seg:.3f} s ({int(spp.max()) + 1} superpoints); the prepare_scannet CLI "
          f"{t_cli:.2f} s; {n_inst} instances", flush=True)

    model = isbnet.ISBNet(isbnet.ISBNetConfig(filter_bg_thresh=0.0), seed=0, device=dev)
    with torch.no_grad():
        model.inst_conf_head.dense2.bias += CONF_SHIFT
    lb = next(iter(build_dataloader(ds, 1, training=False, drop_last=False)))
    s = types.SimpleNamespace(xyz=lb.scenes[0]["xyz"], spp=lb.scenes[0]["spp"])
    serve(model, s, lb.points, dev)  # cold
    zero_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prepared, got, inst, stages = serve(model, s, lb.points, dev)
    ms = (time.perf_counter() - t1) * 1e3
    launches = read_counts()
    if launches["subm_conv"] < 53 or launches["fps"] != 4 or launches["dyco"] != 3:
        fail(f"the prepared scan's request did not run through the kernels: {launches}")
    with plain_kernels():
        _, want, inst_plain, _ = serve(model, s, lb.points, dev)
    err = compare_outputs(got, want, PATH_RTOL, "the prepared scan's request, kernels vs plain")
    if not same_instances(inst, inst_plain):
        fail("the prepared scan's request: " + instance_diff(inst, inst_plain, got, want))
    print(f"prepare, ScanNet: the scan's request {ms:.1f} ms ("
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
          + f" ms), {int(prepared.batch.valid.sum())} voxels, launches {launches}; agrees with "
          f"the plain versions (discrete equal, floats within {err:.3g} of scale, "
          f"{len(inst)} identical instances)", flush=True)

    raw_dir = os.path.join(root, "s3dis_raw")
    t1 = time.perf_counter()
    room = s3dis_room(77, S3DIS_RAW_POINTS)
    write_s3dis_raw(raw_dir, room)
    t_s3_write = time.perf_counter() - t1
    s3_out = os.path.join(root, "s3dis")
    t1 = time.perf_counter()
    if prepare_s3dis.main(["--data_dir", raw_dir, "--out", s3_out, "--areas", "5"]) != 0:
        fail("prepare_s3dis's CLI failed")
    t_s3 = time.perf_counter() - t1
    r = S3DISDataset(s3_out, prefix="Area_5", training=False).load(0)
    n_obj = len(np.unique(room["inst"]))
    if (len(r["xyz"]) != S3DIS_RAW_POINTS or len(np.unique(r["instance"])) != n_obj
            or sorted(np.unique(r["semantic"])) != sorted(np.unique(room["sem"]))):
        fail(f"the prepared S3DIS room is not the raw one: {len(r['xyz'])} points, "
             f"{len(np.unique(r['instance']))} instances of {n_obj}")
    print(f"prepare, S3DIS: a room of {S3DIS_RAW_POINTS} points in {n_obj} object files "
          f"written in {t_s3_write:.2f} s; the prepare_s3dis CLI {t_s3:.2f} s "
          f"({int(r['spp'].max()) + 1} geometric superpoints); loaded by S3DISDataset",
          flush=True)
    return dict(write_s=t_write, build_s=t_build, segment_s=t_seg, cli_s=t_cli, request_ms=ms,
                launches=launches, s3dis_cli_s=t_s3, s3dis_write_s=t_s3_write)


def fake_reference(family: str, seed: int, **dims) -> dict:
    """A reference-shaped ``state_dict`` of random numpy weights: ISBNet's
    (ISBNet/isbnet/model/isbnet.py:89-209; dims C, NB, DD, M, n_cls) or
    SPFormer's (spformer.py:38-69, query_decoder.py:101-138; dims media,
    nb, d_model, nhead, num_layer, num_query, hidden, num_class), spconv 2.x
    KRSC kernels, as ``tests/test_convert_ckpt.py:_fake_state_dict`` writes
    them. A weight's entries have standard deviation 1/sqrt(fan-in), so
    that the activations keep their scale through the full-width U-Net; the
    BatchNorm statistics are near (0, 1)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def w(key, *shape, fan_in=None):
        fan = fan_in or (int(np.prod(shape[1:])) if len(shape) > 1 else 1)
        sd[key] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    def b(key, n):
        sd[key] = (rng.standard_normal(n) * 0.05).astype(np.float32)

    def norm(prefix, n, stats=True):
        sd[f"{prefix}.weight"] = (1.0 + rng.standard_normal(n) * 0.1).astype(np.float32)
        b(f"{prefix}.bias", n)
        if stats:
            b(f"{prefix}.running_mean", n)
            sd[f"{prefix}.running_var"] = (rng.random(n) * 0.5 + 0.75).astype(np.float32)
            sd[f"{prefix}.num_batches_tracked"] = np.asarray(10)

    def res_block(prefix, cin, cout):
        norm(f"{prefix}.conv_branch.0", cin)
        w(f"{prefix}.conv_branch.2.weight", cout, 3, 3, 3, cin)
        norm(f"{prefix}.conv_branch.3", cout)
        w(f"{prefix}.conv_branch.5.weight", cout, 3, 3, 3, cout)
        if cin != cout:
            w(f"{prefix}.i_branch.0.weight", cout, 1, 1, 1, cin)

    def unet(prefix, planes):
        p0 = planes[0]
        for i in range(2):
            res_block(f"{prefix}.blocks.block{i}", p0, p0)
        if len(planes) > 1:
            p1 = planes[1]
            norm(f"{prefix}.conv.0", p0)
            w(f"{prefix}.conv.2.weight", p1, 2, 2, 2, p0)
            unet(f"{prefix}.u", planes[1:])
            norm(f"{prefix}.deconv.0", p1)
            w(f"{prefix}.deconv.2.weight", p0, 2, 2, 2, p1)
            res_block(f"{prefix}.blocks_tail.block0", 2 * p0, p0)
            res_block(f"{prefix}.blocks_tail.block1", p0, p0)

    def linear(prefix, cout, cin, bias=True):
        w(f"{prefix}.weight", cout, cin)
        if bias:
            b(f"{prefix}.bias", cout)

    def mlp(prefix, cin, cout, num_layers):
        ti = 0
        for _ in range(num_layers - 1):
            linear(f"{prefix}.{ti}", cin, cin)
            norm(f"{prefix}.{ti + 1}", cin)
            ti += 3
        linear(f"{prefix}.{ti}", cout, cin)

    def backbone(c, nb):
        w("input_conv.0.weight", c, 3, 3, 3, 6)
        unet("unet", [c * (i + 1) for i in range(nb)])
        norm("output_layer.0", c)
        mlp("mu_linear", c, 1, 3)
        mlp("logvar_linear", c, 1, 3)

    if family == "spformer":
        media, d, hid = dims["media"], dims["d_model"], dims["hidden"]
        backbone(media, dims["nb"])
        linear("decoder.input_proj.0", d, media)
        norm("decoder.input_proj.1", d, stats=False)
        w("decoder.query.weight", dims["num_query"], d, fan_in=1)
        linear("decoder.x_mask.0", d, media)
        linear("decoder.x_mask.2", d, d)
        for i in range(dims["num_layer"]):
            for kind in ("cross_attn_layers", "self_attn_layers"):
                p = f"decoder.{kind}.{i}"
                w(f"{p}.attn.in_proj_weight", 3 * d, d)
                b(f"{p}.attn.in_proj_bias", 3 * d)
                linear(f"{p}.attn.out_proj", d, d)
                norm(f"{p}.norm", d, stats=False)
            linear(f"decoder.ffn_layers.{i}.net.0", hid, d)
            linear(f"decoder.ffn_layers.{i}.net.3", d, hid)
            norm(f"decoder.ffn_layers.{i}.norm", d, stats=False)
        norm("decoder.out_norm", d, stats=False)
        linear("decoder.out_cls.0", d, d)
        linear("decoder.out_cls.2", dims["num_class"] + 1, d)
        linear("decoder.out_score.0", d, d)
        linear("decoder.out_score.2", 1, d)
        return sd

    c, dd, m, n_cls = dims["C"], dims["DD"], dims["M"], dims["n_cls"]
    backbone(c, dims["NB"])
    mlp("semantic_linear", c, n_cls, 2)
    mlp("offset_vertices_linear", c, 6, 2)
    mlp("box_conf_linear", c, 1, 2)

    def shared_mlp(prefix, chans):
        for i in range(len(chans) - 1):
            w(f"{prefix}.layer{i}.conv.weight", chans[i + 1], chans[i], 1, 1)
            norm(f"{prefix}.layer{i}.bn.bn", chans[i + 1])

    def generic(prefix, cin, hidden, cout, out_norm=False):
        ti, prev = 0, cin
        for hdim in hidden:
            w(f"{prefix}.layers.{ti}.weight", hdim, prev, 1)
            norm(f"{prefix}.layers.{ti + 1}", hdim)
            prev, ti = hdim, ti + 3
        w(f"{prefix}.layers.{ti}.weight", cout, prev, 1)
        b(f"{prefix}.layers.{ti}.bias", cout)
        if out_norm:
            norm(f"{prefix}.layers.{ti + 1}", cout)

    for name, dim in (("point_aggregator1", c), ("point_aggregator2", 2 * c)):
        shared_mlp(f"{name}.mlp_module1", [dim + 6, dim, 2 * dim])
        shared_mlp(f"{name}.mlp_module2", [2 * dim + 6, 2 * dim])
        w(f"{name}.mlp_module3.0.conv.weight", 8 * dim, 2 * dim, 1)
        norm(f"{name}.mlp_module3.0.bn.bn", 8 * dim)
        w(f"{name}.mlp_module3.1.conv.weight", 2 * dim, 8 * dim, 1)
        norm(f"{name}.mlp_module3.1.bn.bn", 2 * dim)
    generic("inst_shared_mlp", 4 * c, [4 * c], dd, out_norm=True)
    generic("inst_sem_head", dd, [dd, dd], n_cls)
    generic("inst_conf_head", dd, [dd, dd], 1)
    generic("inst_box_head", dd, [dd, dd], 6)
    for i in range(3):
        w(f"mask_tower.{i}.0.conv.weight", c, c, 1)
        norm(f"mask_tower.{i}.1", c)
    w("mask_tower.3.weight", m, c, 1)
    b("mask_tower.3.bias", m)
    for i in range(2):
        w(f"inst_mask_head.{i}.0.conv.weight", dd, dd, 1)
        norm(f"inst_mask_head.{i}.1", dd)
    num_gen = (m + 6) * m + m * (m // 2) + (m // 2) + m + (m // 2) + 1
    w("inst_mask_head.2.weight", num_gen, dd, 1)
    b("inst_mask_head.2.bias", num_gen)
    return sd


# Full-width reference checkpoints: ISBNet at configs/isbnet_scannetv2.yaml's
# widths (C 32, 7 levels, dec_dim 128, mask dim 32, ScanNet's 18 classes and
# the background), SPFormer at configs/spformer_scannetv2.yaml's.
CKPT_ISBNET = dict(C=32, NB=7, DD=128, M=32, n_cls=19)
CKPT_SPFORMER = dict(media=32, nb=5, d_model=256, nhead=8, num_layer=6, num_query=400,
                     hidden=1024, num_class=18)


def ckpt_phase(dev, scene, root: str) -> dict:
    """The reference-checkpoint loader at full width: a fake reference
    ``.pth`` of each family (``fake_reference``, under ``net`` as the
    reference's trainer saves it) through ``convert_torch_ckpt``'s CLI; no
    key unused or missing; the result loaded by ``tools/test.py``'s loader
    (``load_model_weights``), every entry equal to the file's; one request
    of ``scene`` through the kernels (counted) and through the plain
    versions, which must agree."""
    import torch

    from gapro_tpu_torch.models import isbnet
    from gapro_tpu_torch.models.spformer import SPFormer, SPFormerConfig
    from gapro_tpu_torch.tools import convert_torch_ckpt as cc
    from gapro_tpu_torch.train.checkpoint import load_checkpoint, load_model_weights

    os.makedirs(root, exist_ok=True)
    s, pb = scene
    out = {}
    for family, dims, make, serve_fn in (
            ("isbnet", CKPT_ISBNET,
             lambda: isbnet.ISBNet(isbnet.ISBNetConfig(filter_bg_thresh=0.0), seed=1, device=dev),
             serve),
            ("spformer", CKPT_SPFORMER,
             lambda: SPFormer(SPFormerConfig(), seed=1, device=dev), spformer_serve)):
        ref = os.path.join(root, f"{family}_reference.pth")
        torch.save({"net": {k: torch.from_numpy(np.asarray(v))
                            for k, v in fake_reference(family, 0, **dims).items()}}, ref)
        converted = os.path.join(root, f"{family}_converted.pth")
        t0 = time.perf_counter()
        if cc.main([ref, converted]) != 0:
            fail(f"convert_torch_ckpt failed on the {family} reference")
        t_cli = time.perf_counter() - t0
        sd = cc.read_reference(ref)
        report = (cc.convert_spformer_state_dict(sd)[1] if family == "spformer"
                  else cc.convert_state_dict(sd)[1])
        if report["unused_torch_keys"] or report["missing_torch_keys"]:
            fail(f"the {family} reference: unused {report['unused_torch_keys'][:4]}, missing "
                 f"{report['missing_torch_keys'][:4]}")
        model = make()
        saved = load_checkpoint(converted)["model"]
        want = model.state_dict()
        if set(saved) != set(want) or any(saved[k].shape != want[k].shape for k in want):
            fail(f"the converted {family} checkpoint does not match the model's state_dict: "
                 f"{sorted(set(saved) ^ set(want))[:6]}")
        load_model_weights(converted, model)
        bad = [k for k, v in model.state_dict().items() if not torch.equal(v.cpu(), saved[k])]
        if bad:
            fail(f"load_model_weights left {len(bad)} {family} entries unloaded: {bad[:4]}")
        with torch.no_grad():  # untrained scores rank nothing (see CONF_SHIFT)
            head = (model.decoder.out_score_1 if family == "spformer"
                    else model.inst_conf_head.dense2)
            head.bias += CONF_SHIFT
        serve_fn(model, s, pb, dev)  # cold
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, got, inst, stages = serve_fn(model, s, pb, dev)
        ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts()
        need = (("subm_conv", 1),) + ((("fps", 4), ("dyco", 3)) if family == "isbnet" else ())
        if any(launches[k] < n for k, n in need):
            fail(f"the converted {family} request did not run through the kernels: {launches}")
        with plain_kernels():
            _, plain, inst_plain, _ = serve_fn(model, s, pb, dev)
        err = compare_outputs(got, plain, PATH_RTOL, f"the converted {family} request")
        if not same_instances(inst, inst_plain):
            fail(f"the converted {family} request: {len(inst)} against {len(inst_plain)} "
                 f"instances, or their records differ")
        print(f"checkpoint loader, {family}: {len(sd)} reference keys -> {len(saved)} entries "
              f"in {t_cli:.2f} s (the CLI), 0 unused, 0 missing, loaded by load_model_weights; "
              f"a request {ms:.1f} ms (" + ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
              + f" ms), {len(inst)} instances, launches {launches}; agrees with the plain "
              f"versions (floats within {err:.3g} of scale)", flush=True)
        out[family] = dict(cli_s=t_cli, request_ms=ms, launches=launches, keys=len(sd))
        del model
        torch.cuda.empty_cache()
    return out


# The library functions that only tests call, on the card at a ScanNet
# scene's size: 240,000 valid points of a capacity of 262,144, 4,096
# superpoints, 19 classes; FPS variants sample 2,048 (n_sample_pa1);
# the distance-matrix FPS and the k-NN at their own sizes (4,096 candidates;
# 16,384 queries against 2,048 samples, whose [Q, N, 3] differences take
# 400 MB); the mask IoU of 256 proposals against 192 instances.
LIB_N, LIB_CAP, LIB_SPP, LIB_SAMPLE, LIB_QUERIES = 240_000, 262_144, 4096, 2048, 16384


def library_phase(dev) -> dict:
    """Each library function on the card against its CPU run on the same
    inputs: integer outputs and the FPS variants' indices equal, floats
    within 1e-5 of scale (sums in another order). Times each on the card
    (CUDA events, after a warm call) and on the host."""
    import torch

    from gapro_tpu_torch.core import batching, segment
    from gapro_tpu_torch.ops import components, fps, interpolate, maskiou, nms, voxelize
    from gapro_tpu_torch.utils import rle

    rng = np.random.default_rng(0)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    valid = np.zeros((1, LIB_CAP), bool)
    valid[0, :LIB_N] = True
    xyz = np.zeros((1, LIB_CAP, 3), np.float32)
    xyz[0, :LIB_N] = rng.random((LIB_N, 3)) * [8.0, 6.0, 2.5]
    spp = np.where(valid[0], rng.integers(0, LIB_SPP, LIB_CAP), -1)
    sem = rng.integers(-1, 19, LIB_CAP)
    data = rng.integers(0, 1000, LIB_CAP).astype(np.float32)
    vox = rng.standard_normal((LIB_CAP, 32)).astype(np.float32)
    p2v = np.where(valid[0], rng.integers(0, LIB_CAP, LIB_CAP), -1).astype(np.int32)
    weights = (rng.random((1, LIB_CAP)) + 0.5).astype(np.float32)
    offset = (xyz + rng.normal(0, 0.3, xyz.shape)).astype(np.float32)
    cand = xyz[:, :4096]
    dist2 = ((cand[:, :, None] - cand[:, None]) ** 2).sum(-1).astype(np.float32)
    knn_d = rng.random((1, LIB_QUERIES, 3)).astype(np.float32)
    knn_i = rng.integers(0, LIB_SAMPLE, (1, LIB_QUERIES, 3)).astype(np.int32)
    feats = rng.standard_normal((1, LIB_SAMPLE, 32)).astype(np.float32)
    group_idx = rng.integers(0, LIB_CAP, (1, LIB_SAMPLE, 32)).astype(np.int32)
    inst = np.where(valid[0], rng.integers(-1, 192, LIB_CAP), -100)
    props = (rng.random((256, LIB_CAP)) < 0.05).astype(np.float32)
    n_q = LIB_QUERIES
    cases = {  # name: (function, its arguments; arrays go to the device)
        "segment_argmin": (segment.segment_argmin, (data, spp, LIB_SPP)),
        "segment_prod_mask": (segment.segment_prod_mask, (data > 10, spp, LIB_SPP)),
        "superpoint_major_voting": (segment.superpoint_major_voting, (sem, spp, 19, LIB_SPP)),
        "devoxelize": (voxelize.devoxelize, (vox, p2v)),
        "fps_weights_masked": (fps.fps_weights_masked, (xyz, weights, valid, LIB_SAMPLE)),
        "fps_with_dist_masked": (fps.fps_with_dist_masked,
                                 (dist2, valid[:, :4096], np.zeros(1, np.int64), 256)),
        "fps_ia_masked": (fps.fps_ia_masked, (xyz, valid, LIB_SAMPLE)),
        "fps_hybrid_masked": (fps.fps_hybrid_masked, (xyz, offset, valid, LIB_SAMPLE)),
        "connected_components": (components.connected_components,
                                 (group_idx[0] % LIB_SAMPLE, valid[0, :LIB_SAMPLE])),
        "cluster_points": (components.cluster_points, (xyz[0], valid[0], np.abs(sem) % 3, 0.1)),
        "knn": (interpolate.knn, (xyz[:, :n_q], xyz[:, :LIB_SAMPLE], valid[:, :n_q],
                                  valid[:, :LIB_SAMPLE], 3)),
        "three_interpolate": (interpolate.three_interpolate,
                              (feats, knn_i, knn_d, valid[:, :n_q])),
        "gather_points": (interpolate.gather_points, (vox[None], group_idx[:, :, 0])),
        "group_points": (interpolate.group_points, (vox[None], group_idx)),
        "mask_iou_on_cluster": (maskiou.mask_iou_on_cluster, (props, inst, 192)),
        "mask_label": (maskiou.mask_label, (props, inst, 0.25, 192)),
    }
    out = {}
    for name, (fn, args) in cases.items():
        host = [t(a) if isinstance(a, np.ndarray) else a for a in args]
        card = [a.to(dev) if torch.is_tensor(a) else a for a in host]
        fn(*card)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*card)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        want = fn(*host)
        cpu_ms = (time.perf_counter() - t0) * 1e3
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        worst = 0.0
        for g, w in zip(got, want):
            g = g.cpu()
            if g.dtype.is_floating_point:
                worst = max(worst, float((g - w).abs().max()) / max(1.0, float(w.abs().max())))
                if worst > 1e-5:
                    fail(f"library, {name}: the card's floats differ by {worst:.3g} of scale")
            elif not torch.equal(g, w):
                fail(f"library, {name}: the card's {g.dtype} output differs from the CPU's "
                     f"at {int((g != w).sum())} entries")
        out[name] = dict(card_ms=card_ms, cpu_ms=cpu_ms, err=worst)
        print(f"library, {name}: card {card_ms:.3f} ms, host CPU {cpu_ms:.3f} ms, equal"
              + (f" (floats within {worst:.3g} of scale)" if worst else ""), flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx, ok = batching.random_downsample(gen, t(valid[0]).to(dev), LIB_SAMPLE)
    again = batching.random_downsample(torch.Generator(device=dev).manual_seed(0),
                                       t(valid[0]).to(dev), LIB_SAMPLE)[0]
    if (not bool(ok.all()) or not bool(t(valid[0]).to(dev)[idx.long()].all())
            or len(torch.unique(idx)) != LIB_SAMPLE or not torch.equal(idx, again)):
        fail("library, random_downsample: not a repeatable subset of the valid points")
    masks = props[:64] > 0
    t0 = time.perf_counter()
    keep = nms.standard_nms_host(props[:64], rng.integers(0, 3, 64), rng.random(64),
                                 np.ones(LIB_CAP, np.float32))
    nms_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    runs = rle.rle_encode_batch(masks)
    rle_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.array_equal(rle.rle_decode(r), m) for r, m in zip(runs, masks)) or not len(keep):
        fail("library: rle_encode_batch does not round-trip, or standard_nms_host kept nothing")
    print(f"library, random_downsample on the card: {LIB_SAMPLE} of {LIB_N} valid points, "
          f"repeatable; host functions: standard_nms_host (64 proposals) {nms_ms:.3f} ms, "
          f"rle_encode_batch (64 masks) {rle_ms:.3f} ms", flush=True)
    return out


# ---- 17 (SPFormer), 23-24. SPFormer under data parallelism, the dry run
# at four ranks and the visualization CLI ---------------------------------

DRYRUN_RANKS = 4
VIS_SCENES = 2
VIS_BOX_POINTS = 12 * 24  # tools/visualization.py:_box_edge_points, an instance's box


def dp_spformer_phase(dev, pbs, work_dir: str) -> dict:
    """Phase 17 for SPFormer at full width (``SPFORMER_SCANNETV2``, its
    U-Net shrunk by SPF_SHRINK): ``dp_step_phase`` on the batch-1 scenes 0
    and 1 (``pbs``) with ``_spformer_loss_fn``: two gloo ranks against the
    emulation bit for bit at DP_WEIGHTS, then the world-size-1 NCCL step
    against ``make_spformer_train_step`` bit for bit; then
    ``dp_trainer_phase`` on its config (``train_dp`` with 2 ranks for an
    epoch of DP_SCENES, rank 0's validation, the resume)."""
    from gapro_tpu_torch.tools import train as port_train

    cfg = spformer_config()
    out = dp_step_phase(dev, port_train.model_config(cfg), pbs, "SPFormer DP step, full width",
                        shrink=SPF_SHRINK, crit=port_train.criterion_config(cfg))
    out["trainer"] = dp_trainer_phase(dev, work_dir, cfg, label="SPFormer --dp 2 trainer")
    return out


def dryrun_phase(dev, root: str) -> dict:
    """The multi-device dry run (``tools/dryrun_dp.py:dryrun_multichip``)
    at DRYRUN_RANKS gloo ranks sharing the card: ISBNet and SPFormer at the
    tiny widths, then the scaled C = 32 stage, the last rank a filler of
    weight 0. It raises where a loss is not finite, where the ranks'
    weights, statistics and optimizer states differ bit for bit after a
    step, or where any rank counts an ``ovf_*``. Then each stage's reduced
    gradients, statistics and losses (rank 0's, saved under ``root``)
    against an emulation in this process: the real shards' steps alone,
    each with its rank's own assignment, reduced by the same formula
    (``weighted_run``). With three terms the sum depends on the order in
    which gloo adds them, which the emulation does not follow, so the two
    are not held bit for bit: ``compare_step`` holds each gradient leaf
    within NOISE_FACTOR of the kernel path's one-ulp spread (the
    emulation's runs on inputs nudged both ways), the losses and
    statistics within PATH_RTOLS. Fails unless every rank launched its
    model's kernels in each stage. Returns rank 0's launches by stage."""
    import torch

    from gapro_tpu_torch.tools import dryrun_dp

    os.makedirs(root)
    t0 = time.perf_counter()
    res = dryrun_dp.dryrun_multichip(DRYRUN_RANKS, dev, save_dir=root, timeout_s=900.0)
    wall = time.perf_counter() - t0
    print(f"dry run: {DRYRUN_RANKS} ranks on {sorted(set(res['devices']))}, backend "
          f"{res['backend']}; spawn to exit {wall:.1f} s", flush=True)
    w = [dryrun_dp.shard_weight(r, DRYRUN_RANKS) for r in range(DRYRUN_RANKS)]
    real = [r for r in range(DRYRUN_RANKS) if w[r] > 0]
    out = dict(wall_s=wall, launches={}, ms={})
    for stage in dryrun_dp.stages():
        reports = res[stage.name]["ranks"]
        label = f"dry run, {stage.name}"
        print(f"{label}: loss {res[stage.name]['losses']['loss']:.6f}; "
              + "; ".join(f"rank {r} (weight {w[r]:g}) {rep['ms']:.1f} ms, launches "
                          f"{rep['launches']}" for r, rep in enumerate(reports)), flush=True)
        need = ("subm_conv", "subm_conv_dfeats", "subm_conv_dw")
        need += () if stage.spformer else ("fps", "dyco")
        if any(rep["launches"][k] == 0 for rep in reports for k in need):
            fail(f"{label}: a rank never launched a kernel of the path: "
                 f"{[rep['launches'] for rep in reports]}")
        prepare_fn = stage.prepare_fn()

        def one(r, direction=None, stage=stage, reports=reports, prepare_fn=prepare_fn):
            prepared = prepare_fn(torch.from_numpy(stage.shard(r)).to(dev))
            if direction is not None:
                prepared = nudged(prepared, direction)
            return one_step_grads(stage.build(dev), prepared, stage.crit_cfg,
                                  assign=torch.from_numpy(reports[r]["assign"]).to(dev))[0]

        ww = [w[r] for r in real]
        emu = weighted_run([one(r) for r in real], ww)
        noise = [weighted_run([one(r, d) for r in real], ww) for d in NUDGES]
        got = torch.load(os.path.join(root, f"{stage.name}.pt"), weights_only=False)
        dp = (got["losses"], got["grads"], got["stats"])
        zero_fill(dp[1], [emu[1]] + [n[1] for n in noise])
        summary = compare_step(dp, emu, PATH_RTOLS,
                               f"{label}, {len(real)} shards vs the emulation", noise=noise)
        print(f"{label}: rank 0's reduction against the emulation of the {len(real)} real "
              f"shards: {summary}; the {DRYRUN_RANKS} ranks' states equal bit for bit",
              flush=True)
        out["launches"][stage.name] = reports[0]["launches"]
        out["ms"][stage.name] = [rep["ms"] for rep in reports]
    return out


def ply_per_point(path: str, xyz, rgb) -> None:
    """The JAX tool's PLY writer (``tools/visualization.py:write_ply``):
    one formatted line a point."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(xyz)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")


def visualization_phase(dev, root: str) -> dict:
    """The visualization CLI (``tools/visualization.py``) on VIS_SCENES
    full-width bench scenes written in ScanNet's layout, all under
    ``val/``: first the test CLI's exports of them (``run_test`` with
    ``out``, the benchmark format, and ``pointwise``, the point-wise heads)
    from the full-width ISBNet of seed 0, its conf head's bias raised by
    CONF_SHIFT so that instances are kept, the counts zeroed just before and
    read just after; then all eight tasks in PLY and in HTML on each scene.
    Fails unless every file holds the scene's points
    (``offset_vertices_pred`` VIS_BOX_POINTS more for each ground-truth
    instance), the HTML page states the same count, and ``instance_pred``'s
    colours mark exactly the exported masks at or above ``--conf_thresh``
    (the median of the exported confidences, so that masks lie on both
    sides of it), the k-th kept mask in the palette's k-th colour, a later
    mask winning a shared point. Times the PLY writer on a 240,000-point
    scene against the JAX tool's per-point loop (host clock), whose bytes
    it must equal."""
    import torch

    from gapro_tpu_torch.data import scannet_io
    from gapro_tpu_torch.tools import test as port_test
    from gapro_tpu_torch.tools import train as port_train
    from gapro_tpu_torch.tools import visualization

    scans = write_scannet(root, VIS_SCENES)
    for scan in scans[1:]:
        shutil.copy(os.path.join(root, "train", scan + "_inst_nostuff.pth"),
                    os.path.join(root, "val", scan + "_inst_nostuff.pth"))
    cfg = full_config()
    cfg.data.update(data_root=root, prefix_val="val")
    model, _ = port_train.build_model(cfg, dev)
    with torch.no_grad():
        model.inst_conf_head.dense2.bias += CONF_SHIFT
    preds = os.path.join(root, "preds")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    port_test.run_test(cfg, device=dev, model=model, out=preds, pointwise=preds, evaluate=False)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    launches = read_counts()
    if any(launches[k] == 0 for k in ("subm_conv", "fps", "dyco")):
        fail(f"visualization: the test CLI's export never launched a kernel: {launches}")
    out = dict(launches=launches, export_s=export_s, task_s={})
    vis = os.path.join(root, "vis")
    for scan in scans:
        xyz, _, _, inst = scannet_io.load_scene(
            os.path.join(root, "val", scan + "_inst_nostuff.pth"))
        n, n_inst = len(xyz), len(np.unique(inst[inst >= 0]))
        lines = [ln.split() for ln in open(os.path.join(preds, scan + ".txt")).read().splitlines()
                 if ln]
        confs = sorted(float(c) for _, _, c in lines)
        thresh = (confs[len(confs) // 2 - 1] + confs[len(confs) // 2]) / 2 if len(confs) > 1 \
            else 0.0
        kept = [rel for rel, _, c in lines if float(c) >= thresh]
        if not 0 < len(kept) < len(lines):
            fail(f"visualization, {scan}: {len(kept)} of {len(lines)} exported masks at or above "
                 f"--conf_thresh {thresh}: want masks on both sides")
        for task in visualization.TASKS:
            want_n = n + (VIS_BOX_POINTS * n_inst if task == "offset_vertices_pred" else 0)
            for fmt in ("ply", "html"):
                t0 = time.perf_counter()
                path = visualization.main(["--data_root", root, "--scene", scan, "--task", task,
                                           "--format", fmt, "--prediction_path", preds,
                                           "--conf_thresh", repr(thresh), "--out", vis])
                out["task_s"][f"{scan} {task} {fmt}"] = time.perf_counter() - t0
                head = open(path, "rb").read(4096).decode("utf-8", "replace")
                said = (f"element vertex {want_n}\n" in head if fmt == "ply"
                        else f" {want_n} pts " in head)
                if not said:
                    fail(f"visualization, {scan} {task} {fmt}: the file does not hold "
                         f"{want_n} points")
        ids = np.full(n, -1, np.int64)
        for k, rel in enumerate(kept):
            ids[np.loadtxt(os.path.join(preds, rel)).astype(bool)] = k
        want = np.full((n, 3), 128, np.uint8)
        want[ids >= 0] = visualization.PALETTE[ids[ids >= 0] % len(visualization.PALETTE)]
        got = np.loadtxt(os.path.join(vis, f"{scan}_instance_pred.ply"), skiprows=10,
                         usecols=(3, 4, 5)).astype(np.uint8)
        if not np.array_equal(got, want):
            fail(f"visualization, {scan}: instance_pred's colours differ from the exported "
                 f"masks' at {int((got != want).any(1).sum())} points")
        print(f"visualization, {scan}: {n} points, {n_inst} instances; {len(kept)} of "
              f"{len(lines)} exported masks at or above --conf_thresh {thresh:.4f}, their "
              f"points exactly the coloured ones; 8 tasks x (ply, html), each with its points "
              f"(offset_vertices_pred +{VIS_BOX_POINTS * n_inst})", flush=True)
    xyz, rgb = scannet_io.load_scene(os.path.join(root, "val", scans[0] + "_inst_nostuff.pth"))[:2]
    colors = np.clip((rgb + 1) * 127.5, 0, 255).astype(np.uint8)
    times = {}
    for name, write in (("vectorised", visualization.write_ply), ("per-point loop", ply_per_point),
                        ("vectorised again", visualization.write_ply)):
        t0 = time.perf_counter()
        write(os.path.join(root, f"{name}.ply"), xyz, colors)
        times[name] = (time.perf_counter() - t0) * 1e3
    if open(os.path.join(root, "vectorised.ply"), "rb").read() != \
            open(os.path.join(root, "per-point loop.ply"), "rb").read():
        fail("visualization: write_ply's bytes differ from the per-point loop's")
    out["ply_ms"], out["ply_loop_ms"] = min(times["vectorised"], times["vectorised again"]), \
        times["per-point loop"]
    print(f"visualization: the test CLI's exports of {VIS_SCENES} scenes {export_s:.1f} s "
          f"(launches {launches}); the 32 files "
          f"{sum(out['task_s'].values()):.1f} s; write_ply on {len(xyz)} points (host clock): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in times.items())
          + ", the bytes equal", flush=True)
    return out


# ---- the bf16 conv mode (GAPRO_CONV_DTYPE=bf16) -----------------------------

# One bf16 rounding step of a value, relative to it (bf16 keeps 8 bits).
BF16_STEP = 2.0 ** -8
# K1-bf16 against its plain version: within K1_RTOL of the output's scale
# (the same exact products summed in another order). On a window level each
# tap's sum is rounded to bf16 (sparse/conv.py:subm_conv_bf16), a step
# function: a tap whose sum lies within fp32 rounding of a bf16 rounding
# boundary may round either way in two fp32 sums, and its entry moves by one
# bf16 step of the tap, at most BF16_STEP of the scale. Such entries are
# found from fp64 (``unstable_taps``: a tap within TAP_MARGIN of the sum of
# its products' magnitudes of a boundary) and held apart; every other entry
# is held as K1 is, within K1_RTOL of the plain version and against fp64.
TAP_MARGIN = 2.0 ** -18
BF16_TRAIN_SCENES = 8  # the bf16 trainer's epoch: two steps of batch 4, one cold


@contextlib.contextmanager
def conv_dtype(value):
    """``GAPRO_CONV_DTYPE`` set to ``value`` (unset for None) inside, as
    before after."""
    saved = os.environ.get("GAPRO_CONV_DTYPE")
    if value is None:
        os.environ.pop("GAPRO_CONV_DTYPE", None)
    else:
        os.environ["GAPRO_CONV_DTYPE"] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("GAPRO_CONV_DTYPE", None)
        else:
            os.environ["GAPRO_CONV_DTYPE"] = saved


def bf16_counts(cfg, caps, levels) -> dict:
    """The conv kernels' launches a bf16 training step of a U-Net: K1-bf16 on
    every subm conv; dfeats (the fp32 K1) and dW only on the levels with
    window tables on the TPU (``LevelPlan.window``), dfeats not on the
    stem's; the other levels' backward is plain; the fp32 K1 forward never."""
    shapes = k1_shape_counts(cfg, caps)
    window = sum(n for (v, _, _), n in shapes.items() if levels[caps.index(v)].window)
    return {"subm_conv_bf16": sum(shapes.values()), "subm_conv": 0,
            "subm_conv_dfeats": window - int(levels[0].window), "subm_conv_dw": window}


def rms_ratio(rms: float, plain_rms: float) -> float:
    """A kernel's rms error against fp64 over its plain version's; 1 where
    both are exact (a window level's held entries sum bf16 taps, often
    exactly)."""
    return rms / plain_rms if plain_rms else (math.inf if rms else 1.0)


def unstable_taps(feats, nbr, w, valid):
    """[V, Cout] bool: the valid entries with a tap whose sum over the
    channels (fp64, of the bf16 operands) lies within TAP_MARGIN times the
    sum of its products' magnitudes of a bf16 rounding boundary, where an
    fp32 sum of the same products may round the other way."""
    import torch

    from gapro_tpu_torch.sparse import conv

    fb, wb = feats.to(torch.bfloat16).double(), w.to(torch.bfloat16).double()
    out = torch.zeros((feats.shape[0], w.shape[2]), dtype=torch.bool, device=feats.device)
    for k in range(nbr.shape[1]):  # one offset at a time: a [V, Cin] gather
        rows = conv.gather_rows(fb, nbr[:, k:k + 1])[:, 0]
        t, m = rows @ wb[k], TAP_MARGIN * (rows.abs() @ wb[k].abs())
        out |= (t - m).to(torch.bfloat16) != (t + m).to(torch.bfloat16)
    return out & valid[:, None]


def k1_bf16_phase(cfg, caps, levels, dev) -> dict:
    """K1-bf16 at the forward conv shapes of a full-width U-Net, each in the
    function of its level (``LevelPlan.window``: each tap rounded to bf16):
    against its plain version (TF32 off); against the same function in fp64
    of the bf16-rounded operands (rms at most NOISE_FACTOR times the plain
    version's, the mean along the sign within K1_DRIFT_ULP), on a window
    level over the entries no tap of which lies at a rounding boundary
    (``unstable_taps``), the others within BF16_STEP of the scale; timed
    beside the plain version and the fp32 K1 at the same shape, with its
    bound (bf16 bytes, operations at the bf16 rate). Returns the per-scene
    sums."""
    import torch

    from gapro_tpu_torch.sparse import conv

    g = torch.Generator().manual_seed(3)
    acc = dict(conv_acc(), fp32_ms=0.0, over=0.0, yard_ms=0.0, kernels_a_conv=None)
    print("K1-bf16 subm_conv_bf16_cuda vs plain (per launch; V, Cin, Cout, launches/scene; "
          "round: the level's taps rounded to bf16, as its TPU window kernel does; tile: "
          "sparse/conv.py:k1_bf16_schedule; yardstick: a bf16 gather and one cuBLAS product, "
          "round 0's function in another order, timed and used nowhere else):", flush=True)
    for (v, cin, cout), count in sorted(k1_shape_counts(cfg, caps).items()):
        lp = levels[caps.index(v)]
        valid, nbr, window = lp.grid.valid, lp.subm_nbr, lp.window
        feats = torch.randn(v, cin, generator=g).to(dev) * valid[:, None]
        b = math.sqrt(3.0 / (27 * cin))
        w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * b).to(dev)
        run = lambda: conv.subm_conv_bf16_cuda(feats, nbr, w, valid, tables=lp.conv,
                                               window=window)
        got = run()
        want = conv.subm_conv_bf16(feats, nbr, w, valid, window)
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        diff = (got - want).abs()
        held = (valid[:, None] & ~unstable_taps(feats, nbr, w, valid) if window
                else valid[:, None].expand(-1, cout))
        err, held_err = float(diff.max()), float(diff[held].max())
        flips = int((diff > K1_RTOL * scale).sum())
        if held_err > K1_RTOL * scale or err > BF16_STEP * scale:
            fail(f"K1-bf16 at V={v} Cin={cin} Cout={cout} (round {int(window)}): max |err| "
                 f"{held_err:.3g} over the held entries, {err:.3g} over all, of scale {scale:.3g}")
        if not bool((got[~valid] == 0).all()):
            fail(f"K1-bf16 at V={v}: invalid rows are not exactly 0")
        ref = conv.subm_conv_bf16(feats.double(), nbr, w.double(), valid, window)
        rms, plain_rms, drift, along = fp64_drift(got, want, ref, held, "K1-bf16")
        if rms > NOISE_FACTOR * plain_rms:
            fail(f"K1-bf16 at V={v} Cin={cin} Cout={cout} is further from fp64 than its plain "
                 f"version is: {drift}")
        if abs(along) > K1_DRIFT_ULP:
            fail(f"K1-bf16 at V={v} Cin={cin} Cout={cout} drifts along the output's sign by more "
                 f"than {K1_DRIFT_ULP} ulp against fp64: {drift}")
        ms = cuda_ms(run, 10)
        pms = cuda_ms(lambda: conv.subm_conv_bf16(feats, nbr, w, valid, window), 5)
        fms = cuda_ms(lambda: conv.subm_conv_cuda(feats, nbr, w, valid, tables=lp.conv), 10)
        yms, y_out = cuda_ms(bf16_yardstick(feats, nbr, w), 10), bf16_yardstick.out
        names = kernels_a_call(run)
        sched = conv.k1_bf16_schedule(v, -(-cin // 8) * 8, cout,
                                      torch.cuda.get_device_properties(dev).multi_processor_count,
                                      bool(window))
        nnz = int((nbr >= 0).sum())
        nbytes = v * 27 * 4 + v * cin * 2 + 27 * cin * cout * 2 + v + v * cout * 4
        flops = 2.0 * nnz * cin * cout
        bms, by = bound_ms(nbytes, flops, BF16_FLOPS)
        for key, val in (("ms", ms), ("plain_ms", pms), ("fp32_ms", fms), ("bound", bms),
                         ("bytes_ms", nbytes / HBM_BYTES_PER_S * 1e3),
                         ("ops_ms", flops / BF16_FLOPS * 1e3), ("flops", flops),
                         ("yard_ms", yms)):
            acc[key] += count * val
        if names is not None:  # None: no trace recorded a kernel
            acc["kernels_a_conv"] = max(acc["kernels_a_conv"] or 0, len(names))
        acc["err"] = max(acc["err"], err)
        acc["over"] = max(acc["over"], flips / int(valid.sum()) / cout)
        acc["fp64"] = max(acc["fp64"], rms_ratio(rms, plain_rms))
        acc["drift"] = max(acc["drift"], abs(along))
        print(f"  V={v:6d} Cin={cin:3d} Cout={cout:3d} x{count} round {int(window)}: kernel "
              f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s; tile {sched.rows}x{sched.cols}"
              f"{' paired' if sched.paired else ''}, "
              f"{sched.splits} split(s), kernels a conv: "
              f"{'not measured' if names is None else f'{len(names)}, ' + ', '.join(names)}), "
              f"fp32 K1 {fms:.4f} ms, yardstick {yms:.4f} ms ({y_out}), plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by}, bf16), max|err| {err:.3g} ({flips} entries "
              f"past {K1_RTOL} of the scale, a tap's rounding flipped; "
              f"{int(held.sum())} of {int(valid.sum()) * cout} held); against fp64: {drift}",
              flush=True)
    n = sum(k1_shape_counts(cfg, caps).values())
    kac = acc["kernels_a_conv"]
    print(f"K1-bf16 per scene ({n} launches, "
          f"{'kernels a conv not measured' if kac is None else f'at most {kac} kernels a conv'}): "
          f"kernel {acc['ms']:.3f} ms ({acc['flops'] / acc['ms'] / 1e9:.2f} TFLOP/s), fp32 K1 "
          f"{acc['fp32_ms']:.3f} ms, yardstick {acc['yard_ms']:.3f} ms, plain "
          f"{acc['plain_ms']:.3f} ms, bound "
          f"{acc['bound']:.3f} ms ({acc['bound'] / acc['ms']:.1%} of it reached); against fp64 "
          f"the mean along the sign at most {acc['drift']:.3g} ulp (gate {K1_DRIFT_ULP}), rms "
          f"at most {acc['fp64']:.3g} times the plain version's", flush=True)
    return acc


def bf16_yardstick(feats, nbr, w):
    """K1-bf16's yardstick, a call of two library calls: the rows of the
    bf16 table gathered (``gather_rows``), then one cuBLAS product with the
    bf16 weights and an fp32 result (a bf16 one where this PyTorch has no
    ``out_dtype``; ``bf16_yardstick.out`` says which). Round 0's function,
    the XLA gather-GEMM, with its sums in another order."""
    import torch

    from gapro_tpu_torch.sparse import conv

    v, cin = feats.shape
    table, wt = feats.to(torch.bfloat16), w.reshape(-1, w.shape[2]).to(torch.bfloat16)
    mm = lambda rows: torch.mm(rows, wt, out_dtype=torch.float32)  # noqa: E731
    try:
        mm(table[:8].new_zeros((8, 27 * cin)))
    except (TypeError, RuntimeError):
        mm = lambda rows: torch.mm(rows, wt)  # noqa: E731
    run = lambda: mm(conv.gather_rows(table, nbr).reshape(v, 27 * cin))  # noqa: E731
    bf16_yardstick.out = str(run().dtype).replace("torch.", "") + " result"
    return run


def k1_bf16_step_drift(model, prepared, crit, what: str) -> float:
    """K1-bf16 against fp64 of the bf16 operands at every launch of one bf16
    training step's forward (the step's own activations and weights), each
    in its level's function (on a window level over the entries
    ``unstable_taps`` leaves), beside the plain version; fails past
    K1_DRIFT_ULP. Returns the largest mean along the sign."""
    import torch

    from gapro_tpu_torch.sparse import conv

    rows, k1 = [], conv.subm_conv_bf16_cuda

    def held(a, nbr, w, valid, tables, window):
        got = k1(a, nbr, w, valid, tables=tables, window=window)
        with torch.no_grad():
            ref = conv.subm_conv_bf16(a.double(), nbr, w.double(), valid, window)
            if bool(ref.abs().max() > 0):
                pick = valid[:, None] & ~unstable_taps(a, nbr, w, valid) if window else valid
                rms, plain_rms, drift, along = fp64_drift(
                    got, conv.subm_conv_bf16(a, nbr, w, valid, window), ref, pick, "K1-bf16")
                rows.append((tuple(got.shape), rms_ratio(rms, plain_rms), along, drift))
        return got
    held.launches = 0  # the kernel counts its launch here: a check's launch, not the path's

    conv.subm_conv_bf16_cuda = held
    try:
        with conv_dtype("bf16"):
            one_step_grads(model, prepared, crit)
    finally:
        conv.subm_conv_bf16_cuda = k1
    torch.cuda.synchronize()
    worst = max(rows, key=lambda r: abs(r[2]))
    print(f"{what}, K1-bf16 on the step's own inputs against fp64 of the bf16 operands "
          f"({len(rows)} launches): the mean along the sign from {min(r[2] for r in rows):+.3g} "
          f"to {max(r[2] for r in rows):+.3g} ulp (gate {K1_DRIFT_ULP}), rms "
          f"{min(r[1] for r in rows):.3g} to {max(r[1] for r in rows):.3g} times the plain "
          f"version's; the furthest at {worst[0]}: {worst[3]}", flush=True)
    for shape, _, along, drift in rows:
        if abs(along) > K1_DRIFT_ULP:
            fail(f"{what}: K1-bf16 at {shape} drifts along the output's sign by more than "
                 f"{K1_DRIFT_ULP} ulp against fp64: {drift}")
    return abs(worst[2])


def fp64_request(model, prepared) -> dict:
    """``forward_inference`` through the plain versions with a copy of the
    model and the inputs in float64, in fp32 mode (no bf16 rounding)."""
    import copy

    with conv_dtype(None), plain_kernels():
        return copy.deepcopy(model).double().forward_inference(to_fp64(prepared).batch, ROUNDS)


def hold_request(kern: dict, plain: dict, ref: dict, what: str) -> dict:
    """A request's float outputs, ``fp64_hold``'s way: each output's rms error
    against ``ref`` (the fp64 run) for the kernel path over the plain
    path's. Where a discrete output (a sampled index, a validity mask)
    differs from the fp64 run's, the outputs computed after the sampling
    differ by the choice, not by rounding: only the per-voxel outputs are
    held then."""
    import torch

    discrete = [k for k, v in ref.items() if isinstance(v, torch.Tensor)
                and not v.is_floating_point() and not torch.equal(kern[k].cpu(), v.cpu())]
    keys = [k for k, v in ref.items() if isinstance(v, torch.Tensor) and v.is_floating_point()
            and (not discrete or v.shape[0] == N_CAP)]
    pick = lambda out: {k: torch.where(ref[k] == MASK_FILL, 0.0, out[k].double()) for k in keys}
    print(f"{what}: discrete outputs " + (f"differ from the fp64 run's in {discrete}; held: "
                                           f"the per-voxel outputs {keys}" if discrete else
                                           f"equal to the fp64 run's; held: {keys}"), flush=True)
    return fp64_hold(({}, {}, pick(kern)), ({}, {}, pick(plain)), ({}, {}, pick(ref)), what)


def timed_steps(make_train_step, model, prepared, crit, lr: float, n: int = 2) -> tuple:
    """One cold and ``n`` timed steps of ``make_train_step`` on ``prepared``
    (host clock, synchronised): the median ms, the last step's losses and
    those not finite."""
    import torch

    from gapro_tpu_torch.train.state import create_train_state

    st = create_train_state(model, lr=lr)
    fn = make_train_step(model, crit)
    ms = []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, losses = fn(st, prepared, lr)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    losses = {k: float(v) for k, v in losses.items()}
    bad = [k for k, v in losses.items() if not math.isfinite(v)]
    return statistics.median(ms[1:]), losses, bad


def bf16_phase(dev, fp32, root: str) -> dict:
    """The bf16 conv mode on the card (phase 25): K1-bf16 at the full-width
    ISBNet's shapes (``k1_bf16_phase``); the request on the 3 bench scenes
    in bf16 (a cold one, then each timed, the counts zeroed just before and
    read just after), scene 0 held against its fp64 run with the plain bf16
    path as the yardstick (``hold_request``); the batch-1 step likewise
    (``fp64_hold``; the plain path's error the larger of its runs on the
    inputs and on them nudged one ulp away from zero: a bf16 step's losses
    move between the two by about as much as between the paths), K1-bf16's
    drift on its activations, both modes' step timed, one bf16 step
    profiled; the trainer at batch 4 for an epoch of BF16_TRAIN_SCENES
    scenes; SPFormer's batch-4 step in both modes; the learning smoke's
    ISBNet, 300 steps. ``fp32`` holds the fp32 paths' numbers of the same
    run (request, trainer and smoke), printed beside; None where the phase
    runs alone."""
    import torch

    from gapro_tpu_torch.data.dataset import SyntheticDataset, build_dataloader
    from gapro_tpu_torch.losses.criterion import CriterionConfig
    from gapro_tpu_torch.models import isbnet, prepare
    from gapro_tpu_torch.models.spformer import SPFormerConfig
    from gapro_tpu_torch.sparse.plan import level_capacities
    from gapro_tpu_torch.tools import smoke_learn
    from gapro_tpu_torch.tools import train as port_train
    from gapro_tpu_torch.train import step as train_step
    from gapro_tpu_torch.train.state import create_train_state

    fp32 = fp32 or {}
    side = lambda key, fmt=".1f", unit=" ms": (f"{fp32[key]:{fmt}}{unit}" if key in fp32
                                               else "not measured in this run")
    t_phase = time.perf_counter()
    cfg = isbnet.ISBNetConfig(filter_bg_thresh=0.0)
    caps = level_capacities(N_CAP, cfg.num_blocks, FULL_SHRINK)
    scenes = [scene_inputs(seed) for seed in range(3)]
    prep0 = prepare.prepare_voxel_batch(prepare.upload_point_batch(scenes[0][1], dev), N_CAP, 1,
                                        cfg.num_blocks, cfg.spp_cap, FULL_SHRINK)
    levels = prep0.batch.plan.levels
    print(f"bf16: window tables on the TPU at levels "
          f"{[i for i, lp in enumerate(levels) if lp.window]} of capacities {caps}", flush=True)
    out = dict(k1=k1_bf16_phase(cfg, caps, levels, dev))
    need = bf16_counts(cfg, caps, levels)

    # the request: 3 scenes after a cold one, the counts zeroed around them
    model = isbnet.ISBNet(cfg, seed=0, device=dev)
    with torch.no_grad():
        model.inst_conf_head.dense2.bias += CONF_SHIFT
    with conv_dtype("bf16"):
        serve(model, *scenes[0], dev)
        zero_counts()
        times, results = [], []
        for s, pb in scenes:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(serve(model, s, pb, dev))
            times.append((time.perf_counter() - t0) * 1e3)
        out["request_launches"] = read_counts()
        with plain_kernels():
            plain_out = serve(model, *scenes[0], dev)[1]
    launches = out["request_launches"]
    out["request_ms"] = statistics.median(times)
    print(f"bf16 request, 3 scenes: median {out['request_ms']:.1f} ms (all: "
          + ", ".join(f"{t:.1f}" for t in times) + f"; fp32 {side('request_ms')}), "
          f"{[len(r[2]) for r in results]} instances; launches {launches}", flush=True)
    if launches["subm_conv_bf16"] != need["subm_conv_bf16"] * 3 or launches["subm_conv"]:
        fail(f"the bf16 request did not run its forward convs through K1-bf16: {launches}")
    for _, o, inst, _ in results:
        if not inst or not all(bool(torch.isfinite(v).all()) for v in o.values()
                               if isinstance(v, torch.Tensor) and v.is_floating_point()):
            fail("a bf16 request gave no instance or an output not finite")
    out["request_hold"] = hold_request(results[0][1], plain_out, fp64_request(model, results[0][0]),
                                       "bf16 request, scene 0")
    del results, plain_out

    # the batch-1 step: held against its fp64 run, K1-bf16's drift, timed
    crit = CriterionConfig(inst_cap=INST_CAP)
    make = lambda: isbnet.ISBNet(cfg, seed=0, device=dev)
    with conv_dtype("bf16"):
        zero_counts()
        kern, assign, _ = one_step_grads(make(), prep0, crit)
        out["step_launches"] = read_counts()
        with plain_kernels():
            plain = one_step_grads(make(), prep0, crit, assign=assign)[0]
            nudged_plain = one_step_grads(make(), nudged(prep0, NUDGES[0]), crit,
                                          assign=assign)[0]
    if any(out["step_launches"][k] != n for k, n in need.items()):
        fail(f"the bf16 step's conv launches {out['step_launches']}, want {need}")
    out["step_hold"] = fp64_hold(kern, plain, fp64_step(make, prep0, crit, assign),
                                 "bf16 training step, scene 0", spread=(nudged_plain,))
    del kern, plain, nudged_plain
    out["step_drift"] = k1_bf16_step_drift(make(), prep0, crit, "bf16 training step, scene 0")
    for mode in (None, "bf16"):
        with conv_dtype(mode):
            ms, losses, bad = timed_steps(train_step.make_train_step, make(), prep0, crit,
                                          TRAIN_LR, n=4)
        out[f"step_ms_{mode or 'fp32'}"] = ms
        if bad:
            fail(f"the batch-1 step in {mode or 'fp32'} mode: not finite: {bad}")
        print(f"batch-1 step, scene 0, {mode or 'fp32'} mode: median {ms:.1f} ms of 4 after a "
              f"cold one; loss {losses['loss']:.6g}", flush=True)
    with conv_dtype("bf16"):
        m = make()
        st, fn = create_train_state(m, lr=TRAIN_LR), train_step.make_train_step(m, crit)
        profile_request(lambda: fn(st, prep0, TRAIN_LR), "bf16 training step, scene 0")
    del prep0

    # the trainer at batch 4, one epoch
    vc = port_train.voxel_cfg(full_config())
    ds = GPLabelled(SyntheticDataset(n_scenes=BF16_TRAIN_SCENES, training=True, voxel_cfg=vc,
                                     **FULL_SCENE))
    with conv_dtype("bf16"):
        tr = trainer_phase(dev, os.path.join(root, "train"), full_config(), ds,
                           dict(need, fps=1, dyco=1), label="bf16 trainer")
    out["trainer_launches"], out["trainer_ms"] = tr["launches"], statistics.median(tr["step_ms"])
    if tr["launches"]["subm_conv"]:
        fail(f"the bf16 trainer launched the fp32 K1 forward: {tr['launches']}")
    print(f"bf16 trainer, batch {BATCH}: a step {out['trainer_ms']:.1f} ms (fp32 trainer in this "
          f"run: {side('trainer_ms')})", flush=True)
    del tr
    torch.cuda.empty_cache()

    # SPFormer's batch-4 step in both modes
    spf_cfg = spformer_config()
    loader = build_dataloader(ds, spf_cfg.train.batch_size, training=True, seed=0, epoch=1,
                              num_workers=DATA_WORKERS)
    lb = next(loader)
    loader.close()
    prepared = port_train.make_prepare(spf_cfg, dev)(lb.points, lb.batch_size)
    spf_crit = port_train.build_model(spf_cfg, "cpu")[1]
    spf_caps = [lp.grid.capacity for lp in prepared.batch.plan.levels]
    spf_need = bf16_counts(SPFormerConfig(), spf_caps, prepared.batch.plan.levels)
    for mode in (None, "bf16"):
        with conv_dtype(mode):
            zero_counts()
            ms, losses, bad = timed_steps(train_step.make_spformer_train_step, spformer_model(dev),
                                          prepared, spf_crit, spf_cfg.train.lr, n=1)
            launches = read_counts()
        out[f"spformer_ms_{mode or 'fp32'}"] = ms
        if bad:
            fail(f"SPFormer's batch-4 step in {mode or 'fp32'} mode: not finite: {bad}")
        print(f"SPFormer step, batch {spf_cfg.train.batch_size}, {mode or 'fp32'} mode: {ms:.1f} "
              f"ms after a cold one; loss {losses['loss']:.6g}; launches over both {launches}",
              flush=True)
    if launches["subm_conv_bf16"] != 2 * spf_need["subm_conv_bf16"] or launches["subm_conv"]:
        fail(f"SPFormer's bf16 steps did not run their forward convs through K1-bf16: {launches}")
    out["spformer_launches"] = launches
    del prepared
    torch.cuda.empty_cache()

    # the learning smoke's ISBNet in bf16
    with conv_dtype("bf16"):
        zero_counts()
        res = smoke_learn.run("isbnet", LEARN_STEPS, dev, log=None)
        torch.cuda.synchronize()
        out["learn_launches"] = read_counts()
    losses, r = res["losses"], res["result"]
    first, last = statistics.mean(losses[:LEARN_WINDOW]), statistics.mean(losses[-LEARN_WINDOW:])
    out.update(learn_first=first, learn_last=last, learn_ap25=r["all_ap_25%"],
               learn_steps_per_s=LEARN_STEPS / res["seconds"])
    print(f"bf16 learn, isbnet: loss {losses[0]:.4f} -> {losses[-1]:.4f} (the first "
          f"{LEARN_WINDOW} steps' mean {first:.4f}, the last's {last:.4f}); "
          f"{out['learn_steps_per_s']:.2f} steps/s (fp32 in this run: "
          f"{side('learn_steps_per_s', '.2f', '')}); AP {r['all_ap']:.4f} AP50 {r['all_ap_50%']:.4f} "
          f"AP25 {r['all_ap_25%']:.4f} (fp32 in this run: {side('learn_ap25', '.4f', '')}); launches "
          f"{out['learn_launches']}", flush=True)
    if not last < first:
        fail(f"bf16 learn: the loss did not fall ({first:.4f} -> {last:.4f})")
    if not r["all_ap_25%"] > smoke_learn.AP25_FLOOR:
        fail(f"bf16 learn: AP25 {r['all_ap_25%']:.4f} <= {smoke_learn.AP25_FLOOR}")
    if not out["learn_launches"]["subm_conv_bf16"] or out["learn_launches"]["subm_conv"]:
        fail(f"bf16 learn: the forward convs did not run through K1-bf16: {out['learn_launches']}")
    print(f"bf16 phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def s3dis_step_alone(dev) -> None:
    """``s3dis_step_phase`` on the written training rooms, alone."""
    from gapro_tpu_torch import cuda_build
    from gapro_tpu_torch.tools import train as port_train

    root = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_s3dis")
    shutil.rmtree(root, ignore_errors=True)
    cfg = s3dis_config(root)
    write_s3dis(root, cfg.data.label_type)
    s3dis_step_phase(dev, cfg, port_train.build_dataset(cfg, training=True))
    shutil.rmtree(root)


def in_build_dir(phase, name: str):
    """``phase(dev, root)`` in a fresh directory ``name`` under the build
    directory, removed after."""
    def run(dev, *args):
        from gapro_tpu_torch import cuda_build

        root = os.path.join(str(cuda_build.BUILD_DIR), name)
        shutil.rmtree(root, ignore_errors=True)
        try:
            return phase(dev, *args, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return run


# phases a development run can take alone: python3 chip_smoke.py --phase NAME[,NAME]
SINGLE_PHASES = {
    "s3dis_step": s3dis_step_alone,
    "labeler_multidev": labeler_multidev_phase,
    "prepare": in_build_dir(prepare_phase, "chip_smoke_prepare"),
    "ckpt": lambda dev: in_build_dir(ckpt_phase, "chip_smoke_ckpt")(dev, scene_inputs(0)),
    "library": library_phase,
    "dp_spformer": lambda dev: in_build_dir(dp_spformer_phase, "chip_smoke_dp_spformer")(
        dev, [scene_inputs(0)[1], scene_inputs(1)[1]]),
    "dryrun": in_build_dir(dryrun_phase, "chip_smoke_dryrun"),
    "visualization": in_build_dir(visualization_phase, "chip_smoke_vis"),
    "bf16": lambda dev: in_build_dir(bf16_phase, "chip_smoke_bf16")(dev, None),
}


def main() -> None:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gapro_tpu_torch import cuda_build
    from gapro_tpu_torch.losses.criterion import CriterionConfig
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
    if len(sys.argv) > 2 and sys.argv[1] == "--phase":
        # a development aid: only the named phases, no result lines
        for name in sys.argv[2].split(","):
            SINGLE_PHASES[name](dev)
        print(f"chip_smoke: phases {sys.argv[2]} passed, {time.perf_counter() - t_start:.1f} s",
              flush=True)
        return
    for name, log in cuda_build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    sass = sass_counts()
    print("tensor-core and cluster-barrier instructions in the SASS (cuobjdump -sass): "
          + (json.dumps(sass) if sass else "cuobjdump not found, not counted"), flush=True)
    if sass and (sass["subm_conv"]["HGMMA"] == 0 or sass["subm_conv_bf16"]["HGMMA"] == 0
                 or sass["subm_conv_dw"]["HMMA"] == 0 or sass["dyco"]["HGMMA"] == 0):
        fail(f"a conv kernel or K5 was built without its tensor-core instructions: {sass}")
    if sass and (sass["fps"]["CGABAR"] == 0 or sass["fps"]["STAS"] == 0):
        fail(f"K4 was built without its cluster barriers or st.async: {sass['fps']}")

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
    k1 = k1_phase(cfg, caps, levels, dev)

    k4 = k4_phase(prep0, cfg, dev)
    k5 = dyco_kernel_phase(dev)

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
    c32 = c32_gate_phase(dev)

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
    if launches["subm_conv"] < 53 * 3 or launches["fps"] != 4 * 3 or launches["dyco"] != 3 * 3:
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
    ball_query_phase(lambda: serve(model, *scenes[0], dev), "scene 0")

    # ---- 6. training path: full width, 3 steps, then one profiled ----------
    train = train_path(cfg, scenes, dev)
    train_launches = train["launches"]
    profile_request(train["again"], "training step, scene 1")

    # ---- 7. plain training comparison: scene 0 -------------------------------
    prep_s0 = prepare.prepare_voxel_batch(prepare.upload_point_batch(scenes[0][1], dev), N_CAP, 1,
                                          cfg.num_blocks, cfg.spp_cap, FULL_SHRINK)
    train_plain_compare(lambda: isbnet.ISBNet(cfg, seed=0, device=dev), prep_s0,
                        CriterionConfig(inst_cap=INST_CAP))
    step_drift = k1_step_drift(isbnet.ISBNet(cfg, seed=0, device=dev), prep_s0,
                               CriterionConfig(inst_cap=INST_CAP), "training step, scene 0")
    del prep_s0

    # ---- 8. where the time goes: layer times, then profiles -----------------
    stages = {}
    layers = layer_times(lambda: stages.update(serve(model, *scenes[2], dev)[3]))
    print("layers, scene 2 (host clock, synchronised around each call): "
          + ", ".join(f"{k} {v:.1f}" for k, v in stages.items()) + " ms; "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(layers.items(), key=lambda kv: -kv[1]))
          + " ms", flush=True)
    print(f"ball_query layer, request (scene 2, both stages): {layers[BALL_QUERY_LAYER]:.3f} ms",
          flush=True)
    profile_request(lambda: serve(model, *scenes[1], dev), "request, scene 1")
    del train

    # ---- 9. the backbone stage at batch 8, then the trainer at batch 4 from
    # its checkpoint (docs/TRAIN.md's two stages), validation, resume -------
    from gapro_tpu_torch.data.dataset import SyntheticDataset
    from gapro_tpu_torch.tools import train as port_train

    vc = port_train.voxel_cfg(full_config())
    val_ds = SyntheticDataset(n_scenes=VAL_SCENES, training=False, voxel_cfg=vc, **FULL_SCENE)
    bb_dir = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_backbone")
    shutil.rmtree(bb_dir, ignore_errors=True)
    backbone = backbone_phase(dev, bb_dir, val_ds)
    torch.cuda.empty_cache()
    pretrain = os.path.join(bb_dir, "best")
    work_dir = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_train")
    shutil.rmtree(work_dir, ignore_errors=True)
    train_ds = GPLabelled(SyntheticDataset(n_scenes=TRAIN_SCENES, training=True, voxel_cfg=vc,
                                           **FULL_SCENE))
    trainer = trainer_phase(dev, work_dir, full_config(), train_ds,
                            dict(conv_need(cfg), fps=1, dyco=1), val_ds=val_ds,
                            pretrain=pretrain, resume=True)
    check_pretrain_load(pretrain, trainer["pretrain_load"])
    # the trained weights that phase 18's self-training loop starts from
    selftrain_ck = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_selftrain_ck")
    torch.save(dict(model=trainer["state"].model.state_dict()), selftrain_ck)
    shutil.rmtree(work_dir)
    shutil.rmtree(bb_dir)

    # ---- 10. plain comparison at batch 4: one step's losses -----------------
    lb4, prepare4, fps_in4 = trainer_plain_compare(trainer["cfg"], trainer["train_ds"], dev)
    print(f"K4 at the batch-{BATCH} step's input:", flush=True)
    k4_b4 = k4_case(*fps_in4, f"batch-{BATCH} step, stage 1")
    print(f"K4 in the batch-{BATCH} step (1 launch): wrapper {k4_b4['ms']:.3f} ms (before the "
          f"cluster design: {K4_BEFORE_B4_MS} ms in the profiled step), compaction "
          f"{k4_b4['compact_ms']:.3f} ms, the kernel alone {k4_b4['kernel_ms']:.3f} ms, plain "
          f"{k4_b4['plain_ms']:.3f} ms, bound {k4_b4['bound']:.4f} ms", flush=True)
    profile_request(lambda: fps_ops.fps_cuda(*fps_in4), f"K4's wrapper at the batch-{BATCH} input",
                    top=8)
    del fps_in4

    # ---- 11. the test CLI on full-size scenes --------------------------------
    test_cli = test_cli_phase(model, dev)

    # ---- 12. one batch-4 step under the profiler ----------------------------
    from gapro_tpu_torch.train import step as train_step

    cfg4, st4 = trainer["cfg"], trainer["state"]
    step4 = train_step.make_train_step(st4.model, CriterionConfig(**dict(cfg4.criterion)))
    run4 = lambda: step4(st4, prepare4(lb4.points, lb4.batch_size), cfg4.train.lr * BATCH / 16)
    layers = layer_times(run4)
    print(f"layers, training step, batch {BATCH} (host clock, synchronised around each forward "
          "call): " + ", ".join(f"{k} {v:.3f}" for k, v in sorted(layers.items(),
                                                                   key=lambda kv: -kv[1]))
          + " ms", flush=True)
    print(f"ball_query layer, batch-{BATCH} forward: {layers[BALL_QUERY_LAYER]:.3f} ms (the tiled "
          f"form before: {BALL_QUERY_TILED_B4_MS} ms)", flush=True)
    profile_request(run4, f"training step, batch {BATCH}")
    batch4_row_orders(prepare4(lb4.points, lb4.batch_size).batch.plan, cfg, dev)
    del trainer["state"], st4, step4, run4, model
    torch.cuda.empty_cache()

    # ---- 13. SPFormer at full width: kernels, inference, trainer, test CLI --
    spf_dir = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_spformer")
    shutil.rmtree(spf_dir, ignore_errors=True)
    spf = spformer_phase(dev, scenes, train_ds, spf_dir)
    shutil.rmtree(spf_dir)
    torch.cuda.empty_cache()

    # ---- 14. the GP labeler: bench.py's sweep, its gates and profile --------
    labeler_phase(dev)
    torch.cuda.empty_cache()

    # ---- 15. ISBNet on S3DIS: x4_split requests, K4 past its on-chip
    # capacity, the trainer, a step against the plain versions, the test CLI
    s3_root = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_s3dis")
    shutil.rmtree(s3_root, ignore_errors=True)
    s3 = s3dis_phase(dev, s3_root)
    shutil.rmtree(s3_root)
    torch.cuda.empty_cache()

    # ---- 16. the learning smoke: both models learn on the card -------------
    learn = learn_phase(dev)
    torch.cuda.empty_cache()

    # ---- 17. data-parallel training: two gloo ranks on the card against the
    # emulation, a world-size-1 NCCL group, then --dp 2 for an epoch --------
    dp = dp_step_phase(dev, cfg, [scenes[0][1], scenes[1][1]], "DP step, full width")
    dp_dir = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_dp_train")
    shutil.rmtree(dp_dir, ignore_errors=True)
    dp_trainer_phase(dev, dp_dir)
    shutil.rmtree(dp_dir)
    torch.cuda.empty_cache()
    # SPFormer's data-parallel step and --dp 2 epoch at full width
    dp_spf = in_build_dir(dp_spformer_phase, "chip_smoke_dp_spformer")(
        dev, [scenes[0][1], scenes[1][1]])
    torch.cuda.empty_cache()

    # ---- 18. self-training: export -> gen_ps --use_deepfeat -> train -> test
    st_root = os.path.join(str(cuda_build.BUILD_DIR), "chip_smoke_selftrain")
    shutil.rmtree(st_root, ignore_errors=True)
    selftrain = selftrain_phase(dev, selftrain_ck, st_root)
    shutil.rmtree(st_root)
    os.unlink(selftrain_ck)
    torch.cuda.empty_cache()

    # ---- 19. the GP labeler across devices and batch_submit ----------------
    labeler_multidev_phase(dev)
    torch.cuda.empty_cache()

    # ---- 20. raw scan -> prepare_scannet -> ScanNetDataset -> a request;
    # a raw S3DIS room -> prepare_s3dis -> S3DISDataset ---------------------
    prep = in_build_dir(prepare_phase, "chip_smoke_prepare")(dev)

    # ---- 21. reference checkpoints -> convert_torch_ckpt -> requests -------
    ckpt = in_build_dir(ckpt_phase, "chip_smoke_ckpt")(dev, scenes[0])

    # ---- 22. the library functions, card against CPU -----------------------
    library_phase(dev)
    torch.cuda.empty_cache()

    # ---- 23. the multi-device dry run at four gloo ranks on the card ---------
    dryrun = in_build_dir(dryrun_phase, "chip_smoke_dryrun")(dev)
    torch.cuda.empty_cache()

    # ---- 24. the visualization CLI on the test CLI's exports -----------------
    vis = in_build_dir(visualization_phase, "chip_smoke_vis")(dev)
    torch.cuda.empty_cache()

    # ---- 25. the bf16 conv mode: K1-bf16, the request, the step, the trainer,
    # SPFormer's step and the learning smoke, beside this run's fp32 paths ---
    bf = in_build_dir(bf16_phase, "chip_smoke_bf16")(dev, dict(
        request_ms=statistics.median(times), trainer_ms=statistics.median(trainer["step_ms"]),
        learn_steps_per_s=learn["isbnet"]["steps_per_s"], learn_ap25=learn["isbnet"]["ap25"]))

    tl, t4 = train_launches, trainer["launches"]
    s3t = s3["trainer"]["launches"]

    def s3dis_conv(key, count, bwd=None):
        """A conv kernel's keys at the S3DIS paths: its launches on the
        requests, a trainer step and a test-CLI room; its ms and bound at the
        batch-4 step's shapes; for K1 also at the merged room's shapes, its
        plain ms, and its drift along the sign against fp64 there."""
        out = dict(s3dis_request_launches=s3["launches"][count],
                   s3dis_b4_launches=s3t[count], s3dis_test_cli_launches=s3["cli_launches"][count],
                   s3dis_b4_ms=s3["conv_b4"][key][0], s3dis_b4_bound_ms=s3["conv_b4"][key][1])
        if key == "K1":
            out.update(s3dis_ms=s3["k1"]["ms"], s3dis_plain_ms=s3["k1"]["plain_ms"],
                       s3dis_bound_ms=s3["k1"]["bound"], s3dis_fp64_rms_ratio=s3["k1"]["fp64"],
                       s3dis_fp64_drift_ulp=s3["k1"]["drift"],
                       fp64_drift_ulp=max(k1["drift"], spf["k1"]["drift"], s3["k1"]["drift"]),
                       step_fp64_drift_ulp=max(step_drift["K1"], step_drift["dfeats"],
                                               s3["step_drift"]["K1"], s3["step_drift"]["dfeats"]))
        if bwd:
            out.update(s3dis_b4_bwd_launches=s3t[bwd], s3dis_b4_bwd_ms=s3["conv_b4"]["dfeats"][0],
                       s3dis_b4_bwd_bound_ms=s3["conv_b4"]["dfeats"][1],
                       s3dis_b4_bwd_max_abs_err=s3["bwd_b4"][0]["err"])
        else:
            out.update(s3dis_b4_max_abs_err=s3["bwd_b4"][1]["err"],
                       s3dis_b4_fp64_rms_ratio=s3["bwd_b4"][1]["fp64"],
                       fp64_drift_ulp=max(dw_acc["drift"], spf["dw"]["drift"],
                                          s3["bwd_b4"][1]["drift"]),
                       step_fp64_drift_ulp=max(step_drift["dW"], s3["step_drift"]["dW"]))
        return out
    s3k4, s3k5 = s3["k4"], s3["k5"]

    def new_paths(key, count, spf_key, bwd_count=None):
        """A conv kernel's keys on the new paths: the C=32 gate's, the
        backbone step's at batch 8 and SPFormer's launches; its ms and
        bound at the batch-8 backbone step's and the batch-4 SPFormer
        step's shapes; at SPFormer's batch-1 shapes, its ms, plain ms,
        bound and rms against fp64 over the plain version's."""
        out = dict(c32_launches=c32["launches"][count],
                   backbone_b8_launches=backbone["launches"][count],
                   backbone_b8_ms=backbone["conv"][key][0],
                   backbone_b8_bound_ms=backbone["conv"][key][1],
                   spformer_request_launches=spf["infer_launches"][count],
                   spformer_b4_launches=spf["trainer"]["launches"][count],
                   spformer_b4_ms=spf["conv_b4"][key][0],
                   spformer_b4_bound_ms=spf["conv_b4"][key][1],
                   spformer_ms=spf[spf_key]["ms"], spformer_plain_ms=spf[spf_key]["plain_ms"],
                   spformer_bound_ms=spf[spf_key]["bound"],
                   spformer_fp64_rms_ratio=spf[spf_key]["fp64"])
        if bwd_count:
            out.update(backbone_b8_bwd_launches=backbone["launches"][bwd_count],
                       backbone_b8_bwd_ms=backbone["conv"]["dfeats"][0],
                       backbone_b8_bwd_bound_ms=backbone["conv"]["dfeats"][1],
                       spformer_b4_bwd_launches=spf["trainer"]["launches"][bwd_count],
                       spformer_b4_bwd_ms=spf["conv_b4"]["dfeats"][0],
                       spformer_b4_bwd_bound_ms=spf["conv_b4"]["dfeats"][1],
                       spformer_bwd_ms=spf["dfeats"]["ms"],
                       spformer_bwd_bound_ms=spf["dfeats"]["bound"])
        return out
    dp_rank0 = dp["ranks"][0]["steps"][0]["launches"]
    st_launches = selftrain["launches"]

    def loop_paths(count):
        """A kernel's launches on the paths of phases 16-18: the learning
        smoke of each model (training and scoring), the DP step's rank 0
        (weights [1, 1]) and the world-size-1 NCCL step, and the
        self-training loop's export, epoch and test CLI."""
        return dict(learn_isbnet_launches=learn["isbnet"]["launches"][count],
                    learn_spformer_launches=learn["spformer"]["launches"][count],
                    dp_rank0_launches=dp_rank0[count], dp_nccl_launches=dp["nccl_launches"][count],
                    selftrain_export_launches=st_launches["export_features"][count],
                    selftrain_train_launches=st_launches["train, one epoch"][count],
                    selftrain_test_launches=st_launches["test --save_pointwise"][count])
    lk = learn["kernels"]

    def slice12(count):
        """A kernel's launches on PR 12's requests: the prepared raw scan's
        and the converted ISBNet and SPFormer checkpoints'."""
        return dict(prepared_scan_launches=prep["launches"][count],
                    converted_isbnet_launches=ckpt["isbnet"]["launches"][count],
                    converted_spformer_launches=ckpt["spformer"]["launches"][count])

    def dp_dryrun_vis(count):
        """A kernel's launches on the paths of phases 17 (SPFormer), 23 and
        24: SPFormer's DP step (rank 0, weights [1, 1]) and its world-size-1
        NCCL step, each dry-run stage's rank 0, and the test CLI's exports
        for the visualization."""
        return dict(dp_spformer_rank0_launches=dp_spf["ranks"][0]["steps"][0]["launches"][count],
                    dp_spformer_nccl_launches=dp_spf["nccl_launches"][count],
                    **{f"dryrun_{re.sub('[^a-z0-9]+', '_', k.lower())}_rank0_launches": v[count]
                       for k, v in dryrun["launches"].items()},
                    visualization_export_launches=vis["launches"][count])

    def learn_shapes(kind):
        """A kernel's numbers at the learning smoke's shapes
        (``learn_kernel_phase``): the conv kernels summed over a forward
        (K1) or a backward of each U-Net held there, K4 and K5 over the
        cases of one step and one request."""
        if kind in ("k1", "dfeats", "dw"):
            keys = (("ms", "ms"), ("plain_ms", "plain_ms"), ("bound_ms", "bound"),
                    ("max_abs_err", "err"))
            return {f"learn_{m}_{key}": lk[m][kind][src]
                    for m in ("isbnet", "spformer") if m in lk for key, src in keys}
        cases = lk[kind]
        return dict(learn_ms=sum(c["ms"] for c in cases),
                    learn_plain_ms=sum(c["plain_ms"] for c in cases),
                    learn_bound_ms=sum(c.get("bound", c.get("bound_ms")) for c in cases),
                    learn_max_abs_err=max(c.get("err", 0.0) for c in cases))
    req = [k5["shapes"][f"request round {i}"] for i in (1, 2, 3)]
    k5_req = dict(err=k5["err"], **{key: sum(r[key] for r in req)
                                    for key in ("ms", "device_ms", "plain_ms", "bytes_ms",
                                                "ops_ms", "fp32", "x3")},
                  bound=sum(r["bound_ms"] for r in req))
    k5_train, k5_val = k5["shapes"]["training step, batch 4"], k5["shapes"]["validation scene"]
    kernels = []
    for name, src, rep, k, n, extra in (
            ("subm_conv", "gapro_tpu_torch/csrc/subm_conv.cu",
             "gapro_tpu/sparse/window_conv.py:263, gapro_tpu/sparse/pallas_conv.py:41", k1,
             launches["subm_conv"],
             dict(train_launches=tl["subm_conv"], bwd_launches=tl["subm_conv_dfeats"],
                  bwd_ms=dfeats_acc["ms"], bwd_plain_ms=dfeats_acc["plain_ms"],
                  bwd_bound_ms=dfeats_acc["bound"], bwd_max_abs_err=dfeats_acc["err"],
                  bwd_bound_fp32_ms=dfeats_acc["fp32"], bwd_bound_3xtf32_ms=dfeats_acc["x3"],
                  bwd_tflops=dfeats_acc["flops"] / dfeats_acc["ms"] / 1e9,
                  train_b4_launches=t4["subm_conv"], train_b4_bwd_launches=t4["subm_conv_dfeats"],
                  **new_paths("K1", "subm_conv", "k1", "subm_conv_dfeats"),
                  **s3dis_conv("K1", "subm_conv", "subm_conv_dfeats"), **loop_paths("subm_conv"),
                  **{f"{k}_bwd": v for k, v in loop_paths("subm_conv_dfeats").items()},
                  **learn_shapes("k1"), **slice12("subm_conv"), **dp_dryrun_vis("subm_conv"),
                  **{f"{k}_bwd": v for k, v in dp_dryrun_vis("subm_conv_dfeats").items()},
                  **{f"{k}_bwd": v for k, v in learn_shapes("dfeats").items()},
                  **conv_extra(k1, sass.get("subm_conv")))),
            ("subm_conv_dw", "gapro_tpu_torch/csrc/subm_conv_dw.cu",
             "gapro_tpu/sparse/window_conv.py:404, gapro_tpu/sparse/window_conv.py:366", dw_acc,
             tl["subm_conv_dw"], dict(train_b4_launches=t4["subm_conv_dw"],
                                      **new_paths("dW", "subm_conv_dw", "dw"),
                                      **s3dis_conv("dW", "subm_conv_dw"),
                                      **loop_paths("subm_conv_dw"), **learn_shapes("dw"),
                                      **slice12("subm_conv_dw"),
                                      **dp_dryrun_vis("subm_conv_dw"),
                                      **conv_extra(dw_acc, sass.get("subm_conv_dw")))),
            ("fps", "gapro_tpu_torch/csrc/fps.cu", "gapro_tpu/ops/fps_pallas.py:42", k4,
             launches["fps"], dict(train_launches=tl["fps"], train_b4_launches=t4["fps"],
                                   test_cli_launches=test_cli["launches"]["fps"],
                                   kernel_alone_ms=k4["kernel_ms"], clusters=k4["clusters"],
                                   train_b4_cluster=k4_b4["cluster"], train_b4_ms=k4_b4["ms"],
                                   train_b4_kernel_alone_ms=k4_b4["kernel_ms"],
                                   train_b4_plain_ms=k4_b4["plain_ms"],
                                   train_b4_bound_ms=k4_b4["bound"],
                                   past_on_chip_ms=k4["spill"]["ms"],
                                   past_on_chip_plain_ms=k4["spill"]["plain_ms"],
                                   past_on_chip_bound_ms=k4["spill"]["bound"],
                                   s3dis_request_launches=s3["launches"]["fps"],
                                   s3dis_b4_launches=s3t["fps"],
                                   s3dis_merged_valid=s3k4["valid"],
                                   s3dis_merged_spilled=s3k4["spilled"],
                                   s3dis_merged_config_spilled=s3k4["config_spilled"],
                                   s3dis_merged_ms=s3k4["ms"],
                                   s3dis_merged_kernel_alone_ms=s3k4["kernel_ms"],
                                   s3dis_merged_plain_ms=s3k4["plain_ms"],
                                   s3dis_merged_bound_ms=s3k4["bound"], **loop_paths("fps"),
                                   **learn_shapes("k4"), **slice12("fps"), **dp_dryrun_vis("fps"),
                                   sass=sass.get("fps"))),
            ("dyco", "gapro_tpu_torch/csrc/dyco.cu", "gapro_tpu/models/dyco.py:100", k5_req,
             launches["dyco"],
             dict(train_launches=tl["dyco"], train_b4_launches=t4["dyco"],
                  test_cli_launches=test_cli["launches"]["dyco"],
                  device_ms=k5_req["device_ms"], train_b4_device_ms=k5_train["device_ms"],
                  train_b4_ms=k5_train["ms"], train_b4_plain_ms=k5_train["plain_ms"],
                  train_b4_bound_ms=k5_train["bound_ms"], val_ms=k5_val["ms"],
                  val_plain_ms=k5_val["plain_ms"], val_bound_ms=k5_val["bound_ms"],
                  bound_fp32_ms=k5_req["fp32"], bound_3xtf32_ms=k5_req["x3"],
                  train_b4_bound_fp32_ms=k5_train["fp32"],
                  train_b4_bound_3xtf32_ms=k5_train["x3"], fp64_rms_ratio=k5["fp64"],
                  s3dis_request_launches=s3["launches"]["dyco"], s3dis_b4_launches=s3t["dyco"],
                  s3dis_request_ms=sum(r["ms"] for r in s3k5),
                  s3dis_request_device_ms=sum(r["device_ms"] for r in s3k5),
                  s3dis_request_plain_ms=sum(r["plain_ms"] for r in s3k5),
                  s3dis_request_bound_ms=sum(r["bound_ms"] for r in s3k5), **loop_paths("dyco"),
                  **learn_shapes("k5"), **slice12("dyco"), **dp_dryrun_vis("dyco"),
                  sass=sass.get("dyco")))):
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep, launches=n,
            max_abs_err=k["err"], ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound"],
            bound_by="bytes" if k["bytes_ms"] >= k["ops_ms"] else "operations",
            library_ms=None, **extra))
    k1b = bf["k1"]
    kernels.insert(1, dict(
        name="subm_conv_bf16", route="cuda", source="gapro_tpu_torch/csrc/subm_conv_bf16.cu",
        replaces="gapro_tpu/sparse/window_conv.py:263",
        launches=bf["request_launches"]["subm_conv_bf16"], max_abs_err=k1b["err"], ms=k1b["ms"],
        plain_ms=k1b["plain_ms"], bound_ms=k1b["bound"],
        bound_by="bytes" if k1b["bytes_ms"] >= k1b["ops_ms"] else "operations", library_ms=None,
        fp32_k1_ms=k1b["fp32_ms"], yardstick_ms=k1b["yard_ms"],
        kernels_a_conv=k1b["kernels_a_conv"], tflops=k1b["flops"] / k1b["ms"] / 1e9,
        past_rtol_share=k1b["over"], fp64_rms_ratio=k1b["fp64"], fp64_drift_ulp=k1b["drift"],
        step_fp64_drift_ulp=bf["step_drift"],
        train_launches=bf["step_launches"]["subm_conv_bf16"],
        train_b4_launches=bf["trainer_launches"]["subm_conv_bf16"],
        spformer_b4_launches=bf["spformer_launches"]["subm_conv_bf16"] // 2,
        learn_isbnet_launches=bf["learn_launches"]["subm_conv_bf16"],
        request_ms=bf["request_ms"], step_ms=bf["step_ms_bf16"], fp32_step_ms=bf["step_ms_fp32"],
        train_b4_ms=bf["trainer_ms"], spformer_b4_ms=bf["spformer_ms_bf16"],
        fp32_spformer_b4_ms=bf["spformer_ms_fp32"], learn_ap25=bf["learn_ap25"],
        sass=sass.get("subm_conv_bf16")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
