"""K1-bf16 as it stands (csrc/subm_conv_bf16.cu and its wrapper) beside the
design before it (commit f7b40fc: one stage, a wait a k-step, BN of 32 or
64, split sums through HBM), at the full-width ISBNet's forward conv shapes
in both of the kernel's functions, on the same inputs in one run: each
design's ms a launch (CUDA events around 10 calls, the wrapper's host work
included; the two taken in turns, earlier, new, new, earlier), its device
ms (torch.profiler, every kernel of the call), the kernels a conv launches,
the split count, the max |difference| and whether the outputs are equal bit
for bit; the new one against its plain version too. Exits 1 where the
split counts agree and the outputs differ. Per-scene sums take each level's
own function. On the card, from the repository's root:

    python3 dev/k1_bf16_redesign.py [--old DIR]

DIR holds the earlier subm_conv_bf16.cu and conv_common.cuh; without it
they are read from git (`git show f7b40fc:gapro_tpu_torch/csrc/...`).
"""

import argparse
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

EARLIER = "f7b40fc"
SOURCES = ("subm_conv_bf16.cu", "conv_common.cuh")


def earlier_library(src_dir):
    """The earlier design's library, built beside the others."""
    out = os.path.join(str(cuda_build.BUILD_DIR), "k1_bf16_earlier")
    os.makedirs(out, exist_ok=True)
    for name in SOURCES:
        dst = os.path.join(out, name)
        if src_dir:
            shutil.copy(os.path.join(src_dir, name), dst)
        else:
            with open(dst, "w") as f:
                f.write(subprocess.run(["git", "show", f"{EARLIER}:gapro_tpu_torch/csrc/{name}"],
                                       check=True, capture_output=True, text=True).stdout)
    so = os.path.join(out, "lib.so")
    subprocess.run([cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
                    os.path.join(out, SOURCES[0])], check=True)
    return ctypes.CDLL(so)


def earlier_conv(lib, feats, nbr, w, valid, tables, window):
    """The earlier wrapper (sparse/conv.py:_launch_k1_bf16 at f7b40fc) as it
    was: the bf16 cast and pad, the splits asked of the library, the
    signatures set, a split scratch buffer."""
    order, masks = tables.rows()
    b = w.transpose(1, 2)
    v, n, k_real = feats.shape[0], b.shape[1], b.shape[2]
    a = conv._pad8(feats.to(torch.bfloat16), 1).contiguous()
    k = a.shape[1]
    lib.gapro_subm_conv_bf16_splits.argtypes = [ctypes.c_int] * 3
    lib.gapro_subm_conv_bf16_splits.restype = ctypes.c_int
    lib.gapro_subm_conv_bf16_b_elems.argtypes = [ctypes.c_int] * 2
    lib.gapro_subm_conv_bf16_b_elems.restype = ctypes.c_longlong
    fn = lib.gapro_subm_conv_bf16_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        splits = lib.gapro_subm_conv_bf16_splits(v, k, n)
        out = torch.empty((v, n), dtype=torch.float32, device=a.device)
        partial = (torch.empty((splits, v, n), dtype=torch.float32, device=a.device)
                   if splits > 1 else None)
        bt = torch.empty(lib.gapro_subm_conv_bf16_b_elems(k, n), dtype=torch.bfloat16,
                         device=a.device)
        err = fn(a.data_ptr(), nbr.data_ptr(), b.data_ptr(), *b.stride(), k_real,
                 valid.data_ptr(), order.data_ptr(), masks.data_ptr(), out.data_ptr(),
                 0 if partial is None else partial.data_ptr(), bt.data_ptr(), v, k, n, splits,
                 int(window), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "the earlier K1-bf16")
    earlier_conv.splits = splits
    return out


def device_ms(fn, iters=10):
    """The device ms of one call of ``fn`` and of its main kernel alone:
    each kernel's mean over the launches torch.profiler recorded in
    ``iters`` calls (robust to a lost event), summed over the kernels a
    call launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
    total = sum(sum(t) / len(t) for t in spans.values()) / 1e3
    main = [sum(t) / len(t) for n, t in spans.items() if "subm_conv_bf16_kernel" in n]
    return total, (main[0] / 1e3 if main else float("nan"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", help="a directory holding the earlier " + " and ".join(SOURCES))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip(),
          flush=True)
    cuda_build.build_all()
    for line in cuda_build.build_logs.get("subm_conv_bf16", "").splitlines():
        if "registers" in line or "spill" in line or "arning" in line:
            print("  ptxas subm_conv_bf16:", line.strip(), flush=True)
    old = earlier_library(args.old)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    for what, so in (("earlier", old._name),
                     ("new", str(cuda_build.BUILD_DIR / "libsubm_conv_bf16.so"))):
        lines = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                               check=True).stdout.splitlines()
        print(f"SASS, {what}: " + ", ".join(
            f"{op} {sum(op in line for line in lines)}"
            for op in ("HGMMA", "HMMA", "LDGSTS", "UTMALDG", "CGABAR", "BAR.SYNC")), flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cfg = isbnet.ISBNetConfig(filter_bg_thresh=0.0)
    caps = level_capacities(cs.N_CAP, cfg.num_blocks, cs.FULL_SHRINK)
    prep = prepare.prepare_voxel_batch(prepare.upload_point_batch(cs.scene_inputs(0)[1], dev),
                                       cs.N_CAP, 1, cfg.num_blocks, cfg.spp_cap, cs.FULL_SHRINK)
    levels = prep.batch.plan.levels
    g = torch.Generator().manual_seed(3)
    total = {"earlier": 0.0, "new": 0.0, "earlier device": 0.0, "new device": 0.0}
    by_level, failures = {}, []
    for (v, cin, cout), count in sorted(cs.k1_shape_counts(cfg, caps).items()):
        lvl = caps.index(v)
        lp = levels[lvl]
        valid, nbr = lp.grid.valid, lp.subm_nbr
        feats = torch.randn(v, cin, generator=g).to(dev) * valid[:, None]
        b = math.sqrt(3.0 / (27 * cin))
        w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * b).to(dev)
        for window in (False, True):
            new_run = lambda: conv.subm_conv_bf16_cuda(feats, nbr, w, valid,  # noqa: E731
                                                       tables=lp.conv, window=window)
            old_run = lambda: earlier_conv(old, feats, nbr, w, valid, lp.conv,  # noqa: E731
                                           window)
            got, ref = new_run(), old_run()
            torch.cuda.synchronize()
            sched = conv.k1_bf16_schedule(v, -(-cin // 8) * 8, cout, sms, window)
            equal = torch.equal(got.view(torch.int32), ref.view(torch.int32))  # bit for bit
            diff = float((got - ref).abs().max())
            want = conv.subm_conv_bf16(feats, nbr, w, valid, window)
            scale = max(1.0, float(want.abs().max()))
            plain = float((got - want).abs().max()) / scale
            same_split = sched.splits == earlier_conv.splits
            if same_split and not equal:
                failures.append(f"V={v} Cin={cin} Cout={cout} round {int(window)}")
            t_old = cs.cuda_ms(old_run, 10)
            t_new = (cs.cuda_ms(new_run, 10) + cs.cuda_ms(new_run, 10)) / 2
            t_old = (t_old + cs.cuda_ms(old_run, 10)) / 2
            (d_old, m_old), (d_new, m_new) = device_ms(old_run), device_ms(new_run)
            k_old, k_new = len(cs.kernels_a_call(old_run)), len(cs.kernels_a_call(new_run))
            own = window == lp.window
            if own:
                for key, val in (("earlier", t_old), ("new", t_new), ("earlier device", d_old),
                                 ("new device", d_new)):
                    total[key] += count * val
                lv = by_level.setdefault(lvl, [0.0, 0.0])
                lv[0] += count * t_old
                lv[1] += count * t_new
            print(f"V={v:6d} Cin={cin:3d} Cout={cout:3d} x{count} round {int(window)}"
                  f"{' (its level)' if own else ''}: earlier {t_old:.4f} ms (device {d_old:.4f}, "
                  f"main kernel {m_old:.4f}, {k_old} kernels, {earlier_conv.splits} splits), new "
                  f"{t_new:.4f} ms (device {d_new:.4f}, main kernel {m_new:.4f}, {k_new} kernels, "
                  f"{sched.splits} splits, tile "
                  f"{sched.rows}x{sched.cols}, {'paired, ' if sched.paired else ''}{sched.stages} "
                  f"stage(s)); max |new - earlier| "
                  f"{diff:.3g}, {'bit-equal' if equal else 'not bit-equal'}"
                  f"{'' if same_split else ' (splits differ)'}; new vs plain {plain:.3g} of "
                  f"the scale", flush=True)
    print("per scene (53 launches, each level's own function): earlier "
          f"{total['earlier']:.3f} ms (device {total['earlier device']:.3f}), new "
          f"{total['new']:.3f} ms (device {total['new device']:.3f}); by level (earlier -> new): "
          + ", ".join(f"{lvl}: {a:.3f} -> {b:.3f}" for lvl, (a, b) in sorted(by_level.items())),
          flush=True)
    if failures:
        print("FAIL: not bit-equal where the splits agree: " + "; ".join(failures), flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
