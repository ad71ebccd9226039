#!/usr/bin/env python3
"""Readings behind the limits of ``correct`` in the ``infer_x4`` cells: the
port, its bf16 conv mode, the reference's TF32 control and two faults of
the merge, each against the plain float32 reference, on many seeds in one
process.

    python3 benchmark/control_x4.py --workload isbnet_s3dis.infer_x4 --seeds 1,2,3 \\
        --sides program,bf16,tf32,unmerged,piece_dropped

Sides: ``program`` (the port as it runs the cell: the sound runs that set
the lower reading), ``bf16`` (the port with ``GAPRO_CONV_DTYPE=bf16``),
``tf32`` (the reference with its products in TF32, put in the port's
place), ``unmerged`` (the port with the merge's permutation left out: the
points stay in the pieces' order) and ``piece_dropped`` (the port with
the first piece's points given no voxel, so that every mask leaves them
out). Each side serves
the first ``check_requests`` requests of the seed's order. One JSON line a
seed and side.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def fault(name: str):
    """The port's merge (``tools/test.py:room_point2voxel``) broken as the
    side ``name`` says, for the block."""
    import torch

    from gapro_tpu_torch.tools import test as cli

    orig = cli.room_point2voxel

    def unmerged(point2voxel, perm):
        return point2voxel[:len(perm)]

    def piece_dropped(point2voxel, perm):
        out = orig(point2voxel, perm).clone()
        first = -(-len(perm) // cli.X4_PIECES)  # the batch's rows of piece 0
        out[torch.as_tensor(perm[:first], device=out.device)] = -1
        return out

    cli.room_point2voxel = dict(unmerged=unmerged, piece_dropped=piece_dropped)[name]
    try:
        yield
    finally:
        cli.room_point2voxel = orig


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
    from benchmark.drivers import infer_x4, train
    from benchmark.lib import harness

    for seed in seeds:
        spans = harness.Spans(device, sync=False)
        p = dict(infer_x4.plan(config, mix, seed), warm=[])
        positions = list(range(mix["check_requests"]))
        got = {}
        for side in sides:
            if side == "tf32":
                got[side] = infer_x4.reference_records(config, p, positions, seed, device,
                                                       tf32=True)
                continue
            os.environ["GAPRO_CONV_DTYPE"] = "bf16" if side == "bf16" else "fp32"
            broken = fault(side) if side not in ("program", "bf16") else contextlib.nullcontext()
            try:
                with broken:
                    prog = infer_x4.Program(config, mix, p, seed, device, spans)
                    prog.record = True
                    for _ in positions:
                        prog.step()
                    got[side] = [insts for _, insts in prog.served]
                    prog.close()
            finally:
                prog = None
                train.free()
                os.environ.pop("GAPRO_CONV_DTYPE")
        want = infer_x4.reference_records(config, p, positions, seed, device)
        train.free()
        for side, g in got.items():
            yield dict(seed=seed, side=side, **infer_x4.numbers(g, want))


if __name__ == "__main__":
    sys.exit(main())
