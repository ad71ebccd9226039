#!/usr/bin/env python3
"""Readings behind the limits of ``correct``: the port, its bf16 conv mode
and the reference's controls, each against the plain float32 reference,
on many seeds in one process.

    python3 benchmark/control.py --workload isbnet_scannet.train --seeds 1,2,3 \\
        --sides program,bf16,tf32,half

Sides: ``program`` (the port as it runs the cell: the sound runs that set
the lower reading), ``bf16`` (the port with ``GAPRO_CONV_DTYPE=bf16``, its
own lower-precision path), ``tf32`` (the reference with its products in
TF32, put in the port's place), and for training ``half`` (the reference
leaving out half of each batch, a fault). A training side's readings need
no window: set-up builds the training object and drives its first steps,
as a run does. An inference side serves ``check_requests`` requests of the
seed's sequence. One JSON line a seed and side.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from benchmark import run as runner

    runner._environment()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sides", default="program,bf16,tf32")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import harness, traffic

    man = runner.manifest()
    cell = runner.find(man["workloads"], args.workload, "workload")
    entry = runner.find(man["configs"], cell["config"], "config")
    with open(os.path.join(ROOT, entry["file"])) as f:
        config = json.load(f)
    mix = traffic.load_json("traffic", cell["traffic"])
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card:", harness.card_line(), flush=True)
    for line in readings(config, mix, (int(x) for x in args.seeds.split(",")),
                         args.sides.split(","), device):
        print(json.dumps(line), flush=True)
    return 0


def readings(config: dict, mix: dict, seeds, sides, device):
    """Yield one dict a seed and side."""
    from benchmark.drivers import infer, train
    from benchmark.lib import compare, harness

    for seed in seeds:
        spans = harness.Spans(device, sync=False)
        if mix["kind"] == "train":
            p = train.plan(config, mix, seed)
            got = {}
            for side in sides:
                if side in ("program", "bf16"):
                    os.environ["GAPRO_CONV_DTYPE"] = "bf16" if side == "bf16" else "fp32"
                    prog = train.Program(config, mix, p, seed, device, spans)
                    got[side] = prog.checked()
                    prog.close()
                    prog = None
                    train.free()
                    os.environ.pop("GAPRO_CONV_DTYPE")
                elif side in ("tf32", "half"):
                    got[side] = train.reference_readings(config, p, seed, device,
                                                         tf32=side == "tf32",
                                                         half=side == "half")
                    train.free()
            want = train.reference_readings(config, p, seed, device)
            train.free()
            for side, g in got.items():
                nums = compare.train_numbers(g, want)
                yield dict(seed=seed, side=side, **nums, losses=g["losses"],
                           ref_losses=want["losses"], terms=g["terms"],
                           ref_terms=want["terms"], worst=compare.worst_leaves(g, want))
        else:
            p = infer.plan(config, mix, seed)
            n = mix["check_requests"]
            positions = list(range(len(p["warm"]), len(p["warm"]) + n))
            got = {}
            for side in sides:
                if side in ("program", "bf16"):
                    os.environ["GAPRO_CONV_DTYPE"] = "bf16" if side == "bf16" else "fp32"
                    prog = infer.Program(config, mix, p, seed, device, spans)
                    prog.record = True
                    for _ in range(len(p["warm"]) + n):
                        prog.step()
                    served = dict(prog.served)
                    got[side] = [served[q] for q in positions]
                    prog.close()
                    prog = None
                    train.free()
                    os.environ.pop("GAPRO_CONV_DTYPE")
                elif side == "tf32":
                    got[side] = infer.reference_records(config, p, positions, seed, device,
                                                        tf32=True)
            want = infer.reference_records(config, p, positions, seed, device)
            train.free()
            for side, g in got.items():
                yield dict(seed=seed, side=side, **compare.infer_numbers(g, want))


if __name__ == "__main__":
    sys.exit(main())
