"""The learning smoke: overfit a small model on two synthetic scenes and
check that AP rises above zero (the port of ``tools/smoke_learn.py``).

    python -m gapro_tpu_torch.tools.smoke_learn                  # ISBNet
    python -m gapro_tpu_torch.tools.smoke_learn --model spformer
    python -m gapro_tpu_torch.tools.smoke_learn --steps 20 --device cpu

The same two scenes (``make_synthetic_scene(seed=i, n_objects=5,
points_per_object=800, n_floor=1500, n_wall=1000)``, voxel scale 30,
capacity 8192, a flat superpoint capacity of 1024, 4 U-Net levels, plan
shrink 0.6) and the same models as the JAX tool: ISBNet at C = 16 with 256
stage-1 samples, 64 queries and a mask head of width 16 at lr 2e-3;
SPFormer at media 16, 3 decoder layers and 64 queries at lr 1e-3. The
steps alternate the two scenes through the port's ``make_train_step`` or
``make_spformer_train_step``; then each scene is served (ISBNet's rounds
(48, 32, 16) and ``get_instances``, or ``spformer_get_instances``) and
scored with ``ScanNetEval``. The tool fails unless ``all_ap_25%`` passes
0.1, as the JAX tool's assertion does.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..data import make_synthetic_scene, remap_semantic_for_training
from ..device import resolve_device
from ..eval import ScanNetEval
from ..models.prepare import points_to_batch_np, prepare_voxel_batch, upload_point_batch
from ..train.state import create_train_state

N_CAP, SPP_CAP, LEVELS = 8192, 1024, 4
VOXEL_SCALE, SHRINK = 30, 0.6
ROUNDS = (48, 32, 16)
AP25_FLOOR = 0.1
LR = {"isbnet": 2e-3, "spformer": 1e-3}


def make_preps(device):
    """The two scenes, and each one's (host PointBatch, prepared batch)."""
    scenes = [make_synthetic_scene(seed=i, n_objects=5, points_per_object=800, n_floor=1500,
                                   n_wall=1000) for i in range(2)]
    preps = []
    for s in scenes:
        pb = points_to_batch_np([dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
                                      semantic=remap_semantic_for_training(s.semantic_label),
                                      instance=s.instance_label)],
                                voxel_scale=VOXEL_SCALE, n_cap=N_CAP)
        preps.append((pb, prepare_voxel_batch(upload_point_batch(pb, device), N_CAP, 1, LEVELS,
                                              SPP_CAP, SHRINK)))
    return scenes, preps


def build(model_name: str, device):
    """The model (weights from seed 0), its criterion's config, its step
    maker and its per-scene serving function ``serve(scene, pb, prepared)
    -> instance records``."""
    if model_name == "isbnet":
        from ..losses.criterion import CriterionConfig
        from ..models.inference import TestConfig, get_instances
        from ..models.isbnet import ISBNet, ISBNetConfig
        from ..train.step import make_train_step

        model = ISBNet(ISBNetConfig(channels=16, num_blocks=LEVELS, n_sample_pa1=256,
                                    n_queries=64, neighbor=16, dec_dim=64, mask_dim_out=16,
                                    spp_cap=SPP_CAP, filter_bg_thresh=0.0), device=device)
        tc = TestConfig(topk=32, topk_insts=64, npoint_thresh=50, score_thresh=0.0)

        def serve(s, pb, prepared):
            model.eval()
            out = model.forward_inference(prepared.batch, ROUNDS)
            return get_instances("s", out, prepared.batch, np.asarray(pb.spp),
                                 prepared.point2voxel, len(s.xyz), tc)

        return model, CriterionConfig(inst_cap=32), make_train_step, serve
    if model_name == "spformer":
        from ..losses.spformer_criterion import SPFormerCriterionConfig
        from ..models.inference import spformer_get_instances
        from ..models.spformer import SPFormer, SPFormerConfig
        from ..train.step import make_spformer_train_step

        model = SPFormer(SPFormerConfig(media=16, blocks=LEVELS, num_layer=3, num_query=64,
                                        d_model=64, nhead=4, hidden_dim=128, spp_cap=SPP_CAP),
                         device=device)

        def serve(s, pb, prepared):
            model.eval()
            with torch.no_grad():
                out = model(prepared.batch)
            return spformer_get_instances("s", out, prepared.batch, np.asarray(pb.spp),
                                          prepared.point2voxel, len(s.xyz), topk_insts=64,
                                          score_thr=0.0, npoint_thr=50)

        return (model, SPFormerCriterionConfig(inst_cap=32), make_spformer_train_step, serve)
    raise ValueError(f"model {model_name!r}")


def run(model_name: str = "isbnet", steps: int = 300, device=None, evaluate: bool = True,
        log: Optional[Callable[[str], None]] = print) -> dict:
    """Train ``steps`` steps (the scenes in turn) on ``device`` (``cuda``
    unless named), then serve and score both scenes. Returns every step's
    loss, the training seconds, the instance counts and, with ``evaluate``,
    ScanNetEval's result."""
    dev = resolve_device(device)
    log = log or (lambda msg: None)
    scenes, preps = make_preps(dev)
    model, crit, make_step, serve = build(model_name, dev)
    lr = LR[model_name]
    state = create_train_state(model, lr=lr)
    step = make_step(model, crit)
    losses = []
    t0 = time.perf_counter()
    for it in range(steps):
        state, out = step(state, preps[it % 2][1], lr)
        losses.append(float(out["loss"]))
        if it % 50 == 0 or it == steps - 1:
            log(f"step {it}: loss {losses[-1]:.3f}")
    seconds = time.perf_counter() - t0
    log(f"{steps} steps in {seconds:.1f}s")
    res = dict(losses=losses, seconds=seconds, instances=[], result=None)
    if not evaluate:
        return res
    preds, sems, insts = [], [], []
    for s, (pb, prepared) in zip(scenes, preps):
        preds.append(serve(s, pb, prepared))
        sems.append(remap_semantic_for_training(s.semantic_label))
        insts.append(s.instance_label)
        res["instances"].append(len(preds[-1]))
        log(f"instances: {len(preds[-1])}")
    res["result"] = ScanNetEval().evaluate(preds, sems, insts)
    r = res["result"]
    log(f"AP {r['all_ap']:.3f} AP50 {r['all_ap_50%']:.3f} AP25 {r['all_ap_25%']:.3f}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("gapro_tpu_torch smoke_learn")
    ap.add_argument("--model", default="isbnet", choices=["isbnet", "spformer"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    res = run(args.model, args.steps, args.device)
    if not res["result"]["all_ap_25%"] > AP25_FLOOR:
        print(f"model failed to learn: AP25 {res['result']['all_ap_25%']:.3f} <= {AP25_FLOOR}",
              file=sys.stderr)
        return 1
    print("smoke_learn OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
