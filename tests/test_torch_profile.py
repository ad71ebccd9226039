"""The trainer's ``profile``: torch.profiler over the first steps, the trace
written under the work directory (``gapro_tpu_torch/tools/train.py``), with
the port's spans as ranges, side by side, and a track of each loader
worker's scenes, and the spans and counters logged a step."""

import json
import logging
import os
import re

import torch

from gapro_tpu_torch.data.dataset import SyntheticDataset
from gapro_tpu_torch.tools import train as port_train
from gapro_tpu_torch.utils import profiling

from tests.test_torch_trainer import SMALL, _tiny_cfg


def test_profile_writes_a_trace(tmp_path, caplog):
    cfg = _tiny_cfg(1)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with caplog.at_level(logging.INFO, logger="train"):
            port_train.train(cfg, str(tmp_path), device="cpu", skip_validate=True, profile=1,
                             num_workers=2,
                             dataset=SyntheticDataset(n_scenes=2, training=True,
                                                      voxel_cfg=port_train.voxel_cfg(cfg),
                                                      **SMALL))
    finally:
        torch.set_num_threads(n)
    assert not profiling.enabled()  # on for the profiled steps only
    assert profiling.drain() == dict(spans=[], counts={})
    events = json.load(open(tmp_path / "trace" / "trace.json"))["traceEvents"]
    names = {e.get("name") for e in events}
    # the step's stages as ranges of the main process
    assert {"gapro.loader.wait", "gapro.loader.collate", "gapro.prepare.voxelize",
            "gapro.model.backbone", "gapro.model.aggregator", "gapro.model.mask_head",
            "gapro.step.targets", "gapro.step.match", "gapro.step.loss", "gapro.step.backward",
            "gapro.step.optimizer"} <= names
    # and a track a loader worker, with its scenes
    workers = {e["pid"]: e["args"]["name"] for e in events
               if e.get("ph") == "M" and e.get("name") == "process_name"
               and str(e.get("args", {}).get("name", "")).startswith("loader worker")}
    assert 1 <= len(workers) <= 2 and os.getpid() not in workers
    scenes = [e for e in events if e.get("name") == "gapro.loader.scene"]
    assert len(scenes) == 2 and {e["pid"] for e in scenes} <= set(workers)
    # the main process's ranges of a thread lie side by side
    tracks = {}
    for e in events:
        if (e.get("ph") == "X" and e.get("pid") not in workers
                and str(e.get("name", "")).startswith("gapro.")
                and e["name"] != profiling.ANCHOR):
            tracks.setdefault(e["tid"], []).append((float(e["ts"]), float(e["dur"])))
    for ranges in tracks.values():
        ranges.sort()
        assert all(t + d <= u + 1e-3 for (t, d), (u, _) in zip(ranges, ranges[1:]))
    # and the profiled step logged: its stages, the workers' scenes, the
    # host's reads of the card and the bytes (none on the CPU), the loader
    logged = [r.getMessage() for r in caplog.records if r.name == "train"]
    stages = next(m for m in logged if m.startswith("port spans, ms a step over 1 profiled: "))
    assert "loader.collate" in stages and "step.backward" in stages
    assert any(m.startswith("loader workers: ") and m.endswith(" over 2 scenes") for m in logged)
    assert any(re.fullmatch(r"a step: 0 host syncs \(\), 0 MB to the host \(\), 0 MB to the "
                            r"card, [0-2] of 2 scenes ready when asked", m) for m in logged)
