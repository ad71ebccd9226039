"""Data-parallel ranks without JAX.

* ``mesh_rank`` and ``dp_rank``, the rank processes of
  ``tests/test_torch_dp.py``: they live in this file, which imports no JAX,
  so that a spawned rank imports only torch and the port, and each runs on
  two CPU threads beside the test workers;
* on the card (``gpu``), ``chip_smoke.py``'s data-parallel step phase at
  the tiny configuration, for ISBNet and for SPFormer: two gloo ranks on
  one card against the emulation in this process (each scene's step with
  that rank's own assignment, reduced as the ranks reduce: the losses, the
  reduced gradients, the statistics and the parameters after AdamW equal
  bit for bit, both ranks equal bit for bit), then a world-size-1 NCCL
  group against ``make_train_step`` or ``make_spformer_train_step``, bit
  for bit; the phase exits through ``chip_smoke.fail`` on any
  disagreement; and the dry run (``tools/dryrun_dp.py``) at four ranks.
  The card's machine has no JAX and runs them so:

    python -m pytest --noconftest -m gpu tests/test_torch_dp_card.py
"""

import numpy as np
import pytest
import torch

import chip_smoke
from gapro_tpu_torch import convert
from gapro_tpu_torch.losses import criterion, spformer_criterion
from gapro_tpu_torch.models import isbnet, prepare, spformer
from gapro_tpu_torch.parallel import mesh
from gapro_tpu_torch.tools import dryrun_dp
from gapro_tpu_torch.train import state, step

RANK_THREADS = 2


def mesh_rank(rank, init_method, out, world):
    """``parallel/mesh.py``'s helpers on one of ``world`` gloo CPU ranks."""
    torch.set_num_threads(RANK_THREADS)
    group = mesh.data_parallel_mesh(world, rank, init_method, device="cpu")
    try:
        model = torch.nn.Linear(3, 2)
        with torch.no_grad():
            model.weight.fill_(rank + 1.0)
        mesh.replicate(model, group)
        summed = group.all_reduce_sum(torch.tensor([rank + 1.0]))
        gathered = mesh.process_allgather({"r": rank, "a": np.arange(3) * (rank + 1)}, group)
        own = mesh.shard_batch(np.arange(world * 2).reshape(world, 2), group)
        out.put((rank, dict(backend=group.backend, device=str(group.device),
                            weight=model.weight.detach().numpy().copy(), sum=float(summed[0]),
                            gathered=gathered, own=own.numpy().copy())))
    finally:
        torch.distributed.destroy_process_group()


def dp_rank(rank, init_method, out, cfg_kwargs, inst_cap, plan, lr, variables, bufs, weights,
            model_name="isbnet"):
    """One of two gloo CPU ranks of the port's DP step: for each set of
    ``weights``, the model ``model_name`` (``isbnet`` or ``spformer``, of
    ``cfg_kwargs``; ``chip_smoke.dp_model``) from ``variables``, one step
    on this rank's buffer with the ``prepare_fn`` of ``plan`` (levels, flat
    superpoint capacity, shrink) and the model's loss; puts the losses, the
    reduced gradients, the statistics and the parameters after the update,
    as flax trees."""
    torch.set_num_threads(RANK_THREADS)
    spf = model_name == "spformer"
    cfg = (spformer.SPFormerConfig if spf else isbnet.ISBNetConfig)(**cfg_kwargs)
    crit = (spformer_criterion.SPFormerCriterionConfig if spf
            else criterion.CriterionConfig)(inst_cap=inst_cap)
    group = mesh.data_parallel_mesh(2, rank, init_method, device="cpu")
    try:
        results = []
        for w in weights:
            model, loss_fn = chip_smoke.dp_model(cfg, "cpu")
            convert.load_flax_variables(model, variables)
            mesh.replicate(model, group)
            st = state.create_train_state(model, lr=lr)
            dp_step = step.make_dp_train_step(model, crit, group, loss_fn=loss_fn,
                                              prepare_fn=prepare.packed_prepare(*plan))
            st, losses = dp_step(st, torch.from_numpy(bufs[rank]), lr, w[rank])
            after = convert.to_flax_variables(model)
            results.append(dict(losses={k: float(v) for k, v in losses.items()},
                                grads=convert.to_flax_variables(model, grads=True)["params"],
                                batch_stats=after["batch_stats"], params=after["params"]))
        out.put((rank, results))
    finally:
        torch.distributed.destroy_process_group()


@pytest.mark.gpu
def test_dp_step_two_ranks_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    tiny = isbnet.ISBNetConfig(channels=8, num_blocks=3, n_sample_pa1=64, n_queries=16,
                               neighbor=8, dec_dim=32, mask_dim_out=8, spp_cap=256,
                               filter_bg_thresh=0.0)
    pbs = [chip_smoke.scene_inputs(seed, tiny=True)[1] for seed in (0, 1)]
    out = chip_smoke.dp_step_phase(torch.device("cuda"), tiny, pbs, "DP step, tiny", shrink=0.7,
                                   crit=criterion.CriterionConfig(
                                       inst_cap=chip_smoke.TINY_INST_CAP))
    assert {r["backend"] for r in out["ranks"].values()} == {"gloo"}
    assert out["nccl_backend"] == "nccl"
    for r in out["ranks"].values():
        launches = r["steps"][0]["launches"]
        assert all(launches[k] > 0 for k in launches), launches


@pytest.mark.gpu
def test_spformer_dp_step_two_ranks_on_one_card():
    """``chip_smoke.dp_step_phase`` with SPFormer at the tiny widths
    (``chip_smoke.SPF_TINY``) and ``_spformer_loss_fn``: the two ranks
    against the emulation and the NCCL step against
    ``make_spformer_train_step``, bit for bit; the conv kernels launched on
    both ranks (SPFormer runs no K4 or K5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    pbs = [chip_smoke.scene_inputs(seed, tiny=True)[1] for seed in (0, 1)]
    out = chip_smoke.dp_step_phase(
        torch.device("cuda"), spformer.SPFormerConfig(**chip_smoke.SPF_TINY), pbs,
        "SPFormer DP step, tiny", shrink=0.7,
        crit=spformer_criterion.SPFormerCriterionConfig(inst_cap=chip_smoke.TINY_INST_CAP))
    assert out["nccl_backend"] == "nccl"
    for r in out["ranks"].values():
        launches = r["steps"][0]["launches"]
        assert all(launches[k] > 0 for k in ("subm_conv", "subm_conv_dfeats", "subm_conv_dw"))
        assert launches["fps"] == launches["dyco"] == 0, launches


@pytest.mark.gpu
def test_dryrun_four_ranks_on_one_card(capsys):
    """``tools/dryrun_dp.py:dryrun_multichip(4, "cuda")``: four gloo ranks
    sharing the card, the three stages' ``ok`` lines, every ``ovf_*`` 0 on
    every rank (the run raises otherwise), the ranks equal bit for bit after
    each step, and every kernel of each model's path launched on every
    rank."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = dryrun_dp.dryrun_multichip(4, "cuda")
    printed = capsys.readouterr().out
    assert out["backend"] == ("nccl" if torch.cuda.device_count() >= 4 else "gloo")
    for stage in dryrun_dp.stages():
        assert f"dryrun_multichip(4) {stage.name} ok" in printed
        for rep in out[stage.name]["ranks"]:
            assert all(v == 0 for k, v in rep["own"].items() if k.startswith("ovf")), rep["own"]
            kernels = ("subm_conv", "subm_conv_dfeats", "subm_conv_dw")
            kernels += () if stage.spformer else ("fps", "dyco")
            assert all(rep["launches"][k] > 0 for k in kernels), rep["launches"]
