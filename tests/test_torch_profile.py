"""The trainer's ``profile``: torch.profiler over the first steps, the trace
written under the work directory (``gapro_tpu_torch/tools/train.py``)."""

import json

import torch

from gapro_tpu_torch.data.dataset import SyntheticDataset
from gapro_tpu_torch.tools import train as port_train

from tests.test_torch_trainer import SMALL, _tiny_cfg


def test_profile_writes_a_trace(tmp_path):
    cfg = _tiny_cfg(1)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port_train.train(cfg, str(tmp_path), device="cpu", skip_validate=True, profile=1,
                         dataset=SyntheticDataset(n_scenes=2, training=True,
                                                  voxel_cfg=port_train.voxel_cfg(cfg), **SMALL))
    finally:
        torch.set_num_threads(n)
    trace = json.load(open(tmp_path / "trace" / "trace.json"))
    assert trace["traceEvents"]
