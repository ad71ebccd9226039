"""The port imports no JAX, flax or ``gapro_tpu`` module, and its entry
points refuse to fall back to the CPU when no card is present."""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gapro_tpu_torch
from gapro_tpu_torch.labeler import generate_scene_labels, generate_scene_labels_stream
from gapro_tpu_torch.models import isbnet, prepare, spformer

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(gapro_tpu_torch.__path__,
                                                        "gapro_tpu_torch."))
    assert {"gapro_tpu_torch.models.isbnet", "gapro_tpu_torch.convert",
            "gapro_tpu_torch.losses.criterion", "gapro_tpu_torch.losses.matcher",
            "gapro_tpu_torch.train.state", "gapro_tpu_torch.train.step",
            "gapro_tpu_torch.models.dyco", "gapro_tpu_torch.data.dataset",
            "gapro_tpu_torch.data.augment", "gapro_tpu_torch.eval.instance_eval",
            "gapro_tpu_torch.eval.runner", "gapro_tpu_torch.train.checkpoint",
            "gapro_tpu_torch.train.config", "gapro_tpu_torch.tools.train",
            "gapro_tpu_torch.tools.test", "gapro_tpu_torch.gp.linalg",
            "gapro_tpu_torch.gp.variational", "gapro_tpu_torch.gp.fallback",
            "gapro_tpu_torch.gp.ensemble", "gapro_tpu_torch.labeler.boxes",
            "gapro_tpu_torch.labeler.pipeline", "gapro_tpu_torch.eval.pseudo",
            "gapro_tpu_torch.tools.gen_ps", "gapro_tpu_torch.models.spformer",
            "gapro_tpu_torch.losses.spformer_criterion",
            "gapro_tpu_torch.eval.point_wise_eval", "gapro_tpu_torch.eval.s3dis_eval",
            "gapro_tpu_torch.native.segmentator", "gapro_tpu_torch.data.ply",
            "gapro_tpu_torch.utils.logger", "gapro_tpu_torch.utils.profiling",
            "gapro_tpu_torch.ops.components", "gapro_tpu_torch.ops.interpolate",
            "gapro_tpu_torch.ops.maskiou", "gapro_tpu_torch.tools.prepare_scannet",
            "gapro_tpu_torch.tools.prepare_s3dis",
            "gapro_tpu_torch.tools.convert_torch_ckpt", "gapro_tpu_torch.tools.dryrun_dp",
            "gapro_tpu_torch.tools.visualization"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', "
        "'gapro_tpu')]\n"
        "print(json.dumps(bad))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        isbnet.ISBNet(isbnet.ISBNetConfig(channels=8, num_blocks=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spformer.SPFormer(spformer.SPFormerConfig(media=8, blocks=2, num_layer=1, num_query=4,
                                                  d_model=16, nhead=2, hidden_dim=16))
    pb = prepare.points_to_batch_np(
        [dict(xyz=[[0.0, 0.0, 0.0]], rgb=[[0.0, 0.0, 0.0]], spp=[0])], n_cap=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare.upload_point_batch(pb)


def test_labeler_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    xyz = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate_scene_labels(xyz, xyz, [0, 1], np.array([0]),
                              np.array([[0, 0, 0, 1, 1, 1]], np.float32),
                              np.array([1.0], np.float32))
    # the sweep's default device list is every visible card
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(generate_scene_labels_stream(iter([])))
