"""The full-width batch-1 step in bf16: the losses and forward outputs of
the kernel path, the plain path and both on inputs nudged one ulp either
way, each against the fp64 run of the same step (the kernel path's
assignment shared), and the fp32 kernel path beside them: how far one
draw of the bf16 rounding moves each loss. On the card, from the
repository's root:

    python3 dev/bf16_step_spread.py
"""

import contextlib
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gapro_tpu_torch import cuda_build  # noqa: E402
from gapro_tpu_torch.losses.criterion import CriterionConfig  # noqa: E402
from gapro_tpu_torch.models import isbnet, prepare  # noqa: E402
from gapro_tpu_torch.train import step  # noqa: E402


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    dev = torch.device("cuda")
    cfg = isbnet.ISBNetConfig(filter_bg_thresh=0.0)
    prep0 = prepare.prepare_voxel_batch(prepare.upload_point_batch(cs.scene_inputs(0)[1], dev),
                                        cs.N_CAP, 1, cfg.num_blocks, cfg.spp_cap, cs.FULL_SHRINK)
    crit = CriterionConfig(inst_cap=cs.INST_CAP)

    def forward(prepared, assign=None, plain=False, mode="bf16", double=False):
        """Forward, targets and criterion of one step: (losses, outputs,
        assignment)."""
        model = isbnet.ISBNet(cfg, seed=0, device=dev)
        if double:
            model, prepared = model.double(), cs.to_fp64(prepared)
        model.train()
        with cs.conv_dtype(mode), cs.plain_kernels() if plain else contextlib.nullcontext():
            _, (losses, aux) = step._loss_fn(model, prepared, crit, assign=assign)
        return {k: float(v) for k, v in losses.items()}, aux["outputs"], aux["assign"]

    losses, outputs, assign = forward(prep0)
    runs = {"kernel": (losses, outputs), "plain": forward(prep0, assign, plain=True)[:2],
            "fp64": forward(prep0, assign, plain=True, mode=None, double=True)[:2],
            "fp32 kernel": forward(prep0, assign, mode=None)[:2]}
    for d in cs.NUDGES:
        runs[f"plain nudged {d}"] = forward(cs.nudged(prep0, d), assign, plain=True)[:2]
        runs[f"kernel nudged {d}"] = forward(cs.nudged(prep0, d), assign)[:2]
    ref_l, ref_o = runs["fp64"]
    tensors = {k: v for k, v in ref_o.items() if isinstance(v, torch.Tensor)}
    for name, (lo, out) in runs.items():
        discrete = [k for k, v in tensors.items()
                    if not v.is_floating_point() and not torch.equal(out[k].cpu(), v.cpu())]
        rel = {k: float((out[k].double() - v).abs().max() / max(1.0, float(v.abs().max())))
               for k, v in tensors.items() if v.is_floating_point()}
        worst = sorted(rel.items(), key=lambda kv: -kv[1])[:6]
        print(f"{name}: losses - fp64: "
              + ", ".join(f"{k} {lo[k] - ref_l[k]:+.3g}" for k in ref_l if not k.startswith("ovf"))
              + f"; discrete differing {discrete}; float max rel "
              + ", ".join(f"{k} {v:.2g}" for k, v in worst), flush=True)


if __name__ == "__main__":
    main()
