"""``chip_smoke.py``'s bf16 phase on the CPU at the tiny configuration: the
request held against its fp64 run (``fp64_request``, ``hold_request``),
the launches a bf16 step takes (``bf16_counts``) and the mode's switch
(``conv_dtype``).

On the card the bf16 kernel path is held against an fp64 run of the same
request, each output's rms error over the plain bf16 path's. Here the plain
path stands in for both, so every ratio is 1 and the hold passes; noise of
one bf16 step of each output's scale added to the stand-in fails it.
"""

import os
import types

import numpy as np
import pytest
import torch

import chip_smoke
from gapro_tpu_torch.models import isbnet, prepare
from gapro_tpu_torch.sparse import conv
from gapro_tpu_torch.sparse.plan import level_capacities, window_level

TINY = dict(channels=8, num_blocks=3, n_sample_pa1=64, n_queries=16, neighbor=8, dec_dim=32,
            mask_dim_out=8, spp_cap=256, filter_bg_thresh=0.0)


@pytest.fixture(scope="module")
def tiny_request():
    """The tiny request in bf16 and fp32 mode, and its fp64 run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        _, pb = chip_smoke.scene_inputs(0, tiny=True)
        prepared = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, "cpu"), 2048, 1, 3,
                                               256, 0.7)
        model = isbnet.ISBNet(isbnet.ISBNetConfig(**TINY), seed=0, device="cpu")
        outs = {}
        for mode in ("bf16", None):
            with chip_smoke.conv_dtype(mode):
                outs[mode] = model.forward_inference(prepared.batch, chip_smoke.ROUNDS)
        ref = chip_smoke.fp64_request(model, prepared)
    finally:
        torch.set_num_threads(threads)
    return outs["bf16"], outs[None], ref


def _rel(a, b):
    return float((a.double() - b).abs().max()) / max(1.0, float(b.abs().max()))


def test_fp64_request_is_the_unrounded_request(tiny_request):
    """The fp64 run is the fp32 mode's function in float64 (within fp32
    rounding of it), and the bf16 request lies a bf16 rounding away."""
    bf16, fp32, ref = tiny_request
    assert ref["voxel_feats"].dtype == torch.float64
    for key in ("voxel_feats", "semantic_scores", "box_preds"):
        assert _rel(fp32[key], ref[key]) < 1e-4, key
        assert 1e-4 < _rel(bf16[key], ref[key]) < 8 * chip_smoke.BF16_STEP, key


def test_hold_request_passes_the_plain_path(tiny_request):
    bf16, _, ref = tiny_request
    out = chip_smoke.hold_request(bf16, bf16, ref, "tiny bf16 request")
    assert out["kernel_over"] == out["plain_over"] == 0 and out["largest"] == 1.0
    assert out["leaves"] >= 5


def test_hold_request_fails_a_perturbed_path(tiny_request):
    bf16, _, ref = tiny_request
    rng = np.random.default_rng(0)
    noisy = {k: v + chip_smoke.BF16_STEP * v.abs().max()
             * torch.from_numpy(rng.standard_normal(v.shape)).to(v.dtype)
             if isinstance(v, torch.Tensor) and v.is_floating_point() else v
             for k, v in bf16.items()}
    with pytest.raises(SystemExit):
        chip_smoke.hold_request(noisy, bf16, ref, "tiny bf16 request, perturbed")


@pytest.mark.parametrize("model,levels,shrink,want", [
    ("isbnet", 7, chip_smoke.FULL_SHRINK, (53, 32, 33)),
    ("spformer", 5, chip_smoke.SPF_SHRINK, (37, 32, 33)),
    ("tiny", 3, 0.7, (21, 0, 0))])
def test_bf16_counts(model, levels, shrink, want):
    """A bf16 step's conv launches: K1-bf16 on every subm conv, dfeats and dW
    only on the levels with window tables (levels 0-3 at full width, none in
    the tiny plan), never the fp32 K1 forward."""
    cfg = types.SimpleNamespace(unet_width=8 if model == "tiny" else 32, unet_levels=levels,
                                with_coords=True)
    caps = level_capacities(2048 if model == "tiny" else chip_smoke.N_CAP, levels, shrink)
    plan = [types.SimpleNamespace(window=window_level(i, c)) for i, c in enumerate(caps)]
    got = chip_smoke.bf16_counts(cfg, caps, plan)
    assert (got["subm_conv_bf16"], got["subm_conv_dfeats"], got["subm_conv_dw"]) == want
    assert got["subm_conv"] == 0


def test_conv_dtype_restores_the_variable(monkeypatch):
    monkeypatch.setenv("GAPRO_CONV_DTYPE", "fp32")
    with chip_smoke.conv_dtype("bf16"):
        assert conv.compute_dtype() is torch.bfloat16
        with chip_smoke.conv_dtype(None):
            assert conv.compute_dtype() is torch.float32
        assert conv.compute_dtype() is torch.bfloat16
    assert conv.compute_dtype() is torch.float32
    monkeypatch.delenv("GAPRO_CONV_DTYPE")
    with chip_smoke.conv_dtype("bf16"):
        pass
    assert "GAPRO_CONV_DTYPE" not in os.environ
