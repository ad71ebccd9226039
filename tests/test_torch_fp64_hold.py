"""``chip_smoke.py``'s hold of a training step against its fp64 run
(``fp64_step``, ``fp64_hold``), at the tiny configuration on the CPU.

The S3DIS batch-4 step on the card is held this way: each leaf's rms
error against an fp64 run of the same step (the plain versions, model and
inputs in float64, the same assignment), the kernel path's over the plain
path's. Here the plain path stands in for both, so every ratio is 1 and the
hold passes; a seeded perturbation of the stand-in's gradients, 1e-3 of
each leaf's scale (far past fp32 rounding, about what one TF32 pass in
place of 3xTF32 leaves), must fail it.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gapro_tpu_torch.losses.criterion import CriterionConfig
from gapro_tpu_torch.models import isbnet, prepare


@pytest.fixture(scope="module")
def tiny_step():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = isbnet.ISBNetConfig(channels=8, num_blocks=3, n_sample_pa1=64, n_queries=16,
                                  neighbor=8, dec_dim=32, mask_dim_out=8, spp_cap=256,
                                  filter_bg_thresh=0.0)
        _, pb = chip_smoke.scene_inputs(0, tiny=True)
        prepared = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, "cpu"), 2048, 1, 3,
                                               256, 0.7)
        crit = CriterionConfig(inst_cap=chip_smoke.TINY_INST_CAP)
        make = lambda: isbnet.ISBNet(cfg, seed=0, device="cpu")
        plain, assign, _ = chip_smoke.one_step_grads(make(), prepared, crit)
        ref = chip_smoke.fp64_step(make, prepared, crit, assign)
    finally:
        torch.set_num_threads(threads)
    return plain, ref


def test_fp64_run_is_the_same_step(tiny_step):
    (lp, gp, sp), (lr, gr, sr) = tiny_step
    assert all(t.dtype == torch.float64 for t in gr.values() if t is not None)
    # the fp32 step within 1e-4 of its fp64 run's losses (fp32 rounding
    # through 3 levels and the heads; the same step, not another one)
    for k, v in lr.items():
        assert abs(lp[k] - v) <= 1e-4 * max(1.0, abs(v)), (k, lp[k], v)
    assert set(gp) == set(gr) and set(sp) == set(sr)


def test_hold_passes_the_plain_path(tiny_step):
    plain, ref = tiny_step
    out = chip_smoke.fp64_hold(plain, plain, ref, "tiny step")
    assert out["kernel_over"] == out["plain_over"] == 0
    assert out["largest"] == 1.0 and out["leaves"] > 300


def test_hold_fails_a_perturbed_path(tiny_step):
    (lp, gp, sp), ref = tiny_step
    rng = np.random.default_rng(0)
    noisy = {k: None if g is None else
             g + 1e-3 * g.abs().max() * torch.from_numpy(rng.standard_normal(g.shape)).float()
             for k, g in gp.items()}
    with pytest.raises(SystemExit):
        chip_smoke.fp64_hold((lp, noisy, sp), (lp, gp, sp), ref, "tiny step, perturbed")
