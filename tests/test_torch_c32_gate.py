"""The scaled C = 32 gate: a full-width backbone (C = 32) at a small depth
leaves every ``ovf_*`` counter at 0, and one training step of the port
matches the JAX package's.

The configuration of ``__graft_entry__.py``'s multi-device stage: C = 32, 3
levels, the small heads, a flat superpoint capacity of 512 and inst_cap 32,
on a synthetic scene of 8 objects (about 8k points) at voxel scale 25,
capacity 8192, every level at its full capacity (shrink 1.0), as
``chip_smoke.py`` runs it on the card (``C32_GATE``, ``c32_points``). Each
point also carries seeded GP labels, so that the KL loss and the
prob-weighted BCE run. The weights are the JAX init,
redrawn, carried by ``convert.py``. Tolerances are ``test_torch_train.py``'s:
losses 1e-4; each gradient leaf within 1e-3 of its largest |g| plus 1e-5;
BatchNorm statistics 1e-5. The one exception is a bias right before a
batch-statistics BatchNorm (``mu_linear`` / ``logvar_linear``'s
``Dense_i/bias`` before ``bn{i}``): its exact gradient is 0, and each
package holds only the rounding noise of a sum that cancels, which at this
width reaches 5e-5 (JAX) and 8e-5 (the port) against the model's largest
|g| of about 260. Such a leaf is held, in both packages, within 1e-5 of the
model's largest |g| (``chip_smoke.py``'s ``GRAD_ATOL`` rule), which is what
"0 up to rounding" means at that scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import C32_GATE, C32_INST_CAP, C32_N_CAP, c32_points
from gapro_tpu.losses import criterion as jax_criterion
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxConfig
from gapro_tpu.models.prepare import prepare_voxel_batch as jax_prepare
from gapro_tpu.train.step import _loss_fn as jax_loss_fn
from gapro_tpu_torch import convert
from gapro_tpu_torch.losses import criterion
from gapro_tpu_torch.models import isbnet, prepare
from gapro_tpu_torch.train import state, step

from tests.test_torch_isbnet import _randomize
from tests.test_torch_train import LOSS_TOL, _assert_trees_close, _leaves, _np_tree

OVF = ("ovf_fg_voxels", "ovf_spp_slots", "ovf_plan_voxels", "ovf_window_escapees",
       "ovf_inst_voxels")


@pytest.fixture(scope="module")
def gate():
    pb = c32_points()
    jprep = jax_prepare(jax.tree_util.tree_map(jnp.asarray, pb), C32_N_CAP, 1, 3, 512, 1.0)
    tprep = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, device="cpu"), C32_N_CAP,
                                        1, 3, 512, 1.0)
    jmodel = JaxISBNet(JaxConfig(**C32_GATE))
    variables = _np_tree(_randomize(
        jax.jit(jmodel.init, static_argnums=(2,))(jax.random.PRNGKey(0), jprep.batch, False),
        seed=1))
    jcrit = jax_criterion.CriterionConfig(inst_cap=C32_INST_CAP)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bs, pr: jax_loss_fn(p, bs, jmodel, pr, jcrit), has_aux=True))
    (_, (jlosses, jbs)), jgrads = grad_fn(variables["params"], variables["batch_stats"], jprep)

    tmodel = isbnet.ISBNet(isbnet.ISBNetConfig(**C32_GATE), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    _, tlosses = step.make_train_step(tmodel, criterion.CriterionConfig(inst_cap=C32_INST_CAP))(
        state.create_train_state(tmodel, lr=1e-3), tprep, 1e-3)
    return dict(jlosses=_np_tree(jlosses), jbs=_np_tree(jbs), jgrads=_np_tree(jgrads),
                tmodel=tmodel, tlosses={k: float(v) for k, v in tlosses.items()},
                n_voxels=int(tprep.batch.valid.sum()))


def test_c32_gate_counters_are_zero(gate):
    """Every ``ovf_*`` counter of the step reads 0 in both packages, on a
    scene that fills a good part of the capacity."""
    assert gate["n_voxels"] > C32_N_CAP // 4
    for losses in (gate["jlosses"], gate["tlosses"]):
        assert set(OVF) <= set(losses)
        assert {k: float(losses[k]) for k in OVF} == {k: 0.0 for k in OVF}


def test_c32_gate_step_matches_jax(gate):
    """Losses, every gradient leaf and the new BatchNorm statistics against
    ``jax.value_and_grad`` of the JAX ``_loss_fn``."""
    assert set(gate["tlosses"]) == set(gate["jlosses"])
    assert gate["jlosses"]["kl_loss"] > 0 and gate["jlosses"]["bce_loss"] > 0
    for k, want in gate["jlosses"].items():
        np.testing.assert_allclose(gate["tlosses"][k], want, err_msg=k, **LOSS_TOL)
    got = dict(_leaves(convert.to_flax_variables(gate["tmodel"], grads=True)["params"]))
    want = dict(_leaves(gate["jgrads"]))
    top = max(float(np.abs(w).max()) for w in want.values())
    zero = set()
    for head in ("mu_linear", "logvar_linear"):
        for i in (0, 1):  # Dense_i -> bn_i in the 3-layer MLP heads
            assert f"{head}/bn{i}/bias" in want
            k = f"{head}/Dense_{i}/bias"
            assert max(float(np.abs(got[k]).max()), float(np.abs(want[k]).max())) <= 1e-5 * top, k
            zero.add(k)
    _assert_trees_close({k: v for k, v in got.items() if k not in zero},
                        {k: v for k, v in want.items() if k not in zero}, "grad", rel=1e-3,
                        atol=1e-5)
    _assert_trees_close(convert.to_flax_variables(gate["tmodel"])["batch_stats"], gate["jbs"],
                        "batch_stats", rel=1e-5, atol=1e-5)
