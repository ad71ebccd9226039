"""K1-bf16 (csrc/subm_conv_bf16.cu) as built and with each k-step's sum
given back half an ulp (untruncate, as K1 and the dW kernel do): the mean
error along the output's sign against fp64 of the bf16 operands, the rms
over the plain version's, the entries where a tap's rounding flipped and
the time, at the full-width ISBNet's forward conv shapes, in both of the
kernel's functions. On the card, from the repository's root:

    python3 dev/k1_bf16_untruncate.py
"""

import ctypes
import math
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gapro_tpu_torch import cuda_build  # noqa: E402
from gapro_tpu_torch.models import isbnet, prepare  # noqa: E402
from gapro_tpu_torch.sparse import conv  # noqa: E402
from gapro_tpu_torch.sparse.plan import level_capacities  # noqa: E402


def untruncated_library():
    """csrc/subm_conv_bf16.cu with untruncate on every k-step's sum, built
    beside the other libraries."""
    out = os.path.join(str(cuda_build.BUILD_DIR), "untruncate")
    os.makedirs(out, exist_ok=True)
    for name in ("subm_conv_bf16.cu", "conv_common.cuh"):
        shutil.copy(os.path.join(cuda_build.CSRC, name), out)
    path = os.path.join(out, "subm_conv_bf16.cu")
    src = open(path).read()
    assert src.count("], acc[i]);") == 2
    open(path, "w").write(src.replace("], acc[i]);", "], untruncate(acc[i]));"))
    so = os.path.join(out, "lib.so")
    subprocess.run([cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, path], check=True)
    return ctypes.CDLL(so)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_build.build_all()
    libs = {"as built": cuda_build.load("subm_conv_bf16"), "untruncate": untruncated_library()}
    dev = torch.device("cuda")
    cfg = isbnet.ISBNetConfig(filter_bg_thresh=0.0)
    caps = level_capacities(cs.N_CAP, cfg.num_blocks, cs.FULL_SHRINK)
    prep = prepare.prepare_voxel_batch(prepare.upload_point_batch(cs.scene_inputs(0)[1], dev),
                                       cs.N_CAP, 1, cfg.num_blocks, cfg.spp_cap, cs.FULL_SHRINK)
    levels = prep.batch.plan.levels
    g = torch.Generator().manual_seed(3)
    try:
        for (v, cin, cout), count in sorted(cs.k1_shape_counts(cfg, caps).items()):
            lp = levels[caps.index(v)]
            valid, nbr = lp.grid.valid, lp.subm_nbr
            feats = torch.randn(v, cin, generator=g).to(dev) * valid[:, None]
            b = math.sqrt(3.0 / (27 * cin))
            w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * b).to(dev)
            line = f"V={v} Cin={cin} Cout={cout} x{count} window {int(lp.window)}:"
            for window in (False, True):
                want = conv.subm_conv_bf16(feats, nbr, w, valid, window)
                ref = conv.subm_conv_bf16(feats.double(), nbr, w.double(), valid, window)
                held = (valid[:, None] & ~cs.unstable_taps(feats, nbr, w, valid) if window
                        else valid[:, None].expand(-1, cout))
                scale = max(1.0, float(want.abs().max()))
                for name, lib in libs.items():
                    cuda_build._loaded["subm_conv_bf16"] = lib
                    run = lambda: conv.subm_conv_bf16_cuda(feats, nbr, w, valid,  # noqa: E731
                                                           tables=lp.conv, window=window)
                    got = run()
                    rms, plain_rms, _, along = cs.fp64_drift(got, want, ref, held, "K1-bf16")
                    flips = int(((got - want).abs() > cs.K1_RTOL * scale).sum())
                    line += (f" | round {int(window)} {name}: along {along:+.4f} rms "
                             f"{rms:.3g} (plain {plain_rms:.3g}), {cs.cuda_ms(run, 10):.4f} ms, "
                             f"{flips} flips")
            print(line, flush=True)
    finally:
        cuda_build._loaded["subm_conv_bf16"] = libs["as built"]


if __name__ == "__main__":
    main()
