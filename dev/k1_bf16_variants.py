"""K1-bf16's schedule against the forms it passes over, at the full-width
ISBNet's forward conv shapes, each in its level's function: the main
kernel's device ms (torch.profiler, mean over its launches) of the tile
`sparse/conv.py:k1_bf16_schedule` picks, of the other form (paired or
unpaired) on the same tile, at Cout 64 of one 64-row tile by the Cout
paired (two warpgroups side by side), and of a paired pick on a single
stage. The forms
the schedule never takes are instantiated in a variant build of
csrc/subm_conv_bf16.cu beside the other libraries; every output is checked
equal bit for bit to the pick's. On the card, from the repository's root:

    python3 dev/k1_bf16_variants.py
"""

import ctypes
import math
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.join(os.getcwd(), "dev"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gapro_tpu_torch import cuda_build  # noqa: E402
from gapro_tpu_torch.models import isbnet, prepare  # noqa: E402
from gapro_tpu_torch.sparse import conv  # noqa: E402
from gapro_tpu_torch.sparse.plan import level_capacities  # noqa: E402
from k1_bf16_redesign import device_ms  # noqa: E402

# the tiles the variant build adds to the launcher: (wgn, bn, round_taps, paired)
EXTRA = [(1, 32, True, True), (1, 32, False, True), (1, 64, True, True), (2, 32, True, True),
         (2, 32, False, True), (1, 64, False, False)]


def variant_library(name, stages=None):
    """csrc/subm_conv_bf16.cu with the EXTRA tiles instantiated and, given
    ``stages``, every paired tile on that many stages."""
    src = open(os.path.join(cuda_build.CSRC, "subm_conv_bf16.cu")).read()
    head = "Launcher launcher(int wgn, int bn, int round_taps, int paired) {\n"
    assert src.count(head) == 1
    adds = "".join(
        f"  if (wgn == {w} && bn == {b} && round_taps == {int(r)} && paired == {int(p)})\n"
        f"    return launch<{b}, {w}, {'true' if r else 'false'}, {'true' if p else 'false'}>;\n"
        for w, b, r, p in EXTRA)
    src = src.replace(head, head + adds)
    if stages:
        old = "constexpr int MAX_STAGES = 3;"
        assert old in src
        src = src.replace(old, f"constexpr int MAX_STAGES = {stages};")
    out = os.path.join(str(cuda_build.BUILD_DIR), "k1_bf16_" + name)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "subm_conv_bf16.cu")
    with open(path, "w") as f:
        f.write(src)
    with open(os.path.join(out, "conv_common.cuh"), "w") as f:
        f.write(open(os.path.join(cuda_build.CSRC, "conv_common.cuh")).read())
    so = os.path.join(out, "lib.so")
    subprocess.run([cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so, path],
                   check=True)
    return ctypes.CDLL(so)


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip(),
          flush=True)
    cuda_build.build_all()
    libs = {"all tiles": variant_library("all_tiles"),
            "one stage": variant_library("one_stage", stages=1)}
    built = cuda_build.load("subm_conv_bf16")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = isbnet.ISBNetConfig(filter_bg_thresh=0.0)
    caps = level_capacities(cs.N_CAP, cfg.num_blocks, cs.FULL_SHRINK)
    prep = prepare.prepare_voxel_batch(prepare.upload_point_batch(cs.scene_inputs(0)[1], dev),
                                       cs.N_CAP, 1, cfg.num_blocks, cfg.spp_cap, cs.FULL_SHRINK)
    levels = prep.batch.plan.levels
    g = torch.Generator().manual_seed(3)
    pick = conv.k1_bf16_schedule
    total, failures = {}, []
    try:
        for (v, cin, cout), count in sorted(cs.k1_shape_counts(cfg, caps).items()):
            lp = levels[caps.index(v)]
            valid, nbr, window = lp.grid.valid, lp.subm_nbr, lp.window
            feats = torch.randn(v, cin, generator=g).to(dev) * valid[:, None]
            w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1)
                 * math.sqrt(3.0 / (27 * cin))).to(dev)
            s = pick(v, -(-cin // 8) * 8, cout, sms, window)
            forms = {"pick": (built, s),
                     "other form": (libs["all tiles"], conv.K1Bf16Schedule(
                         s.bn, s.wgn, not s.paired, s.splits, s.chunks_per_split, s.n_chunks,
                         window)),
                     "one stage": (libs["one stage"], s)}
            if s.wgn == 1 and s.bn == 64:
                forms["64 rows, paired"] = (libs["all tiles"], conv.K1Bf16Schedule(
                    32, 2, True, s.splits, s.chunks_per_split, s.n_chunks, window))
            line, ref = f"V={v:6d} {cin:3d}->{cout:3d} x{count} round {int(window)}:", None
            for name, (lib, sched) in forms.items():
                if (sched.wgn, sched.bn, window, sched.paired) not in conv.K1_BF16_TILES | set(
                        EXTRA) or (name == "one stage" and not s.paired):
                    continue
                cuda_build._loaded["subm_conv_bf16"] = lib
                conv.k1_bf16_schedule = lambda *a, _s=sched: _s
                run = lambda: conv.subm_conv_bf16_cuda(feats, nbr, w, valid,  # noqa: E731
                                                       tables=lp.conv, window=window)
                got = run()
                if ref is None:
                    ref = got
                elif not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                    failures.append(f"{name} at V={v} {cin}->{cout}")
                ms = device_ms(run)[1]
                total[name] = total.get(name, 0.0) + count * ms
                line += (f" | {name} ({sched.rows}x{sched.cols}"
                         f"{', paired' if sched.paired else ''}) {ms:.4f}")
                conv.k1_bf16_schedule = pick
                cuda_build._loaded["subm_conv_bf16"] = built
            print(line, flush=True)
    finally:
        conv.k1_bf16_schedule = pick
        cuda_build._loaded["subm_conv_bf16"] = built
    print("main kernel per scene, each form where it runs: "
          + ", ".join(f"{k} {t:.3f} ms" for k, t in total.items()), flush=True)
    if failures:
        print("FAIL: not bit-equal to the pick: " + "; ".join(failures), flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
