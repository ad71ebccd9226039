"""SPFormer's data-parallel step in the port against the JAX package.

``make_dp_train_step(..., loss_fn=_spformer_loss_fn)`` on 2 gloo ranks on
the CPU against JAX's ``make_dp_train_step(spf, spf_crit, mesh,
loss_fn=_spformer_loss_fn)`` on a 2-device CPU mesh, from the same weights
(the JAX init at ``tests/test_torch_spformer.py``'s ``SPF_KW``, redrawn)
on the two synthetic scenes of ``tests/test_torch_dp.py``, packed as the
train CLI packs them, at the reduction weights [1, 1] and [1, 0] (scene 1
a filler). SPFormer reduces another set of losses than ISBNet (its six,
with ``ovf_spp_slots``), and its BatchNorm statistics sit in the U-Net
alone. Tolerances, ``tests/test_torch_dp.py``'s:

- losses 1e-4 relative and absolute; BatchNorm statistics 1e-5 of their
  scale plus 1e-5;
- the reduced gradients against the weighted mean of JAX's per-scene
  ``value_and_grad(_spformer_loss_fn)``: each leaf within 1e-3 of its
  largest |g| plus 1e-5; a leaf whose exact gradient is 0 (its JAX
  gradient within 1e-6 of the model's largest |g|) held to its exact
  value, 0, as the JAX package holds it: its largest |g| at most twice the
  JAX package's, plus 1e-5;
- the parameters after the update against the JAX step's: within that
  tolerance of the parameter, plus 2 lr where the JAX gradient lies within
  it of zero (Adam's first step moves a parameter by lr times the
  gradient's sign);
- both ranks' parameters equal bit for bit.

Then ``tools/train.py --dp 2`` on the tiny SPFormer configuration for two
epochs: the loader batch, the learning rate scaled by the world batch and
decayed by the poly schedule as the JAX CLI computes them, an odd scene
dropped as the JAX loader drops a short last batch, and a resume that
continues the run bit for bit.
"""

import json
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from gapro_tpu.losses import spformer_criterion as jax_spf_criterion
from gapro_tpu.models import prepare as jax_prepare
from gapro_tpu.models.spformer import SPFormer as JaxSPFormer
from gapro_tpu.models.spformer import SPFormerConfig as JaxSPFormerConfig
from gapro_tpu.train import state as jax_state
from gapro_tpu.train.state import poly_lr as jax_poly_lr
from gapro_tpu.train.step import _spformer_loss_fn as jax_spf_loss_fn
from gapro_tpu.train.step import make_dp_train_step as jax_dp_step
from gapro_tpu_torch.parallel import mesh
from gapro_tpu_torch.tools import train as port_train

from tests.test_torch_dp import _two_threads  # noqa: F401 (the module's autouse fixture)
from tests.test_torch_dp import LR, N_CAP, WEIGHTS, _assert_grads_close, _scene, _weighted
from tests.test_torch_dp_card import dp_rank
from tests.test_torch_isbnet import _randomize
from tests.test_torch_spformer import INST_CAP, SPF_KW
from tests.test_torch_train import LOSS_TOL, _assert_trees_close, _leaves, _np_tree

LEVELS, SHRINK = SPF_KW["blocks"], 0.7
GRAD_REL, GRAD_ATOL = 1e-3, 1e-5
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY_SPF = osp.join(ROOT, "configs", "tiny_spformer_synthetic.yaml")


@pytest.fixture(scope="module")
def spf_dp_runs():
    """Both packages' SPFormer DP steps and JAX's per-scene gradients, as
    ``tests/test_torch_dp.py:dp_runs`` makes ISBNet's."""
    scenes = [_scene(0), _scene(1)]
    bufs = [jax_prepare.pack_point_batch_np(jax_prepare.points_to_batch_np([s], 10, N_CAP))
            for s in scenes]
    spp_cap = SPF_KW["spp_cap"]
    jpreps = [jax_prepare.prepare_voxel_batch(jax_prepare.unpack_point_batch(jnp.asarray(b)),
                                              N_CAP, 1, LEVELS, spp_cap, SHRINK) for b in bufs]
    jmodel = JaxSPFormer(JaxSPFormerConfig(**SPF_KW))
    init = jax.jit(jmodel.init, static_argnums=(2,))(jax.random.PRNGKey(0), jpreps[0].batch,
                                                      False)
    variables = _np_tree(_randomize(init, seed=1))
    with ThreadPoolExecutor(1) as pool:  # the ranks run beside the JAX steps
        ranks = pool.submit(mesh.spawn_ranks, dp_rank, 2, SPF_KW, INST_CAP,
                            (LEVELS, spp_cap, SHRINK), LR, variables, bufs, WEIGHTS, "spformer",
                            timeout_s=300)
        jcrit = jax_spf_criterion.SPFormerCriterionConfig(inst_cap=INST_CAP)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, bs, pr: jax_spf_loss_fn(p, bs, jmodel, pr, jcrit), has_aux=True))
        per_scene = [_np_tree(grad_fn(variables["params"], variables["batch_stats"], pr)[1])
                     for pr in jpreps]
        two = Mesh(np.array(jax.devices()[:2]), ("dp",))
        jstep = jax_dp_step(jmodel, jcrit, two, loss_fn=jax_spf_loss_fn)
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jpreps)
        st0 = jax_state.create_train_state(variables, lr=LR)
        jax_runs = []
        for w in WEIGHTS:
            st = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), st0)
            st, losses = jstep(st, stacked, jnp.float32(LR), jnp.asarray(w, jnp.float32))
            jax_runs.append(dict(losses=_np_tree(losses), params=_np_tree(st.params),
                                 batch_stats=_np_tree(st.batch_stats)))
        ranks = ranks.result()
    return dict(per_scene=per_scene, jax=jax_runs, ranks=ranks)


@pytest.mark.parametrize("which", [0, 1], ids=["weights_1_1", "weights_1_0"])
def test_spformer_dp_step_matches_jax(spf_dp_runs, which):
    """Losses, reduced gradients, BatchNorm statistics and the updated
    parameters of the port's 2-rank SPFormer step against JAX's 2-device
    step; both ranks end bit-equal."""
    w = WEIGHTS[which]
    want, got = spf_dp_runs["jax"][which], spf_dp_runs["ranks"][0][which]
    assert set(got["losses"]) == set(want["losses"])
    assert {"cls_loss", "dice_loss", "kl_loss", "ovf_spp_slots"} <= set(got["losses"])
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, err_msg=k, **LOSS_TOL)
    wgrads = _weighted(spf_dp_runs["per_scene"], w)
    tols = _assert_grads_close(got["grads"], wgrads, "reduced grad")
    _assert_trees_close(got["batch_stats"], want["batch_stats"], "batch_stats", rel=1e-5,
                        atol=1e-5)
    g, p, wp = dict(_leaves(wgrads)), dict(_leaves(got["params"])), dict(_leaves(want["params"]))
    assert set(p) == set(wp)
    for k in wp:
        bound = (GRAD_REL * float(np.abs(wp[k]).max()) + GRAD_ATOL
                 + 2 * LR * (np.abs(g[k]) <= tols[k]))
        err = np.abs(p[k] - wp[k])
        assert (err <= bound).all(), f"params {k}: max |err| {err.max():.3g}"
    other = spf_dp_runs["ranks"][1][which]
    for a, b in zip(_leaves(got["params"]), _leaves(other["params"])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"rank 1 {a[0]}")
    for a, b in zip(_leaves(got["batch_stats"]), _leaves(other["batch_stats"])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"rank 1 {a[0]}")


def test_spformer_dp_filler_scene_is_left_out(spf_dp_runs):
    """With weights [1, 0] the reduction is scene 0's own step: the reduced
    gradients are JAX's scene-0 gradients."""
    _assert_grads_close(spf_dp_runs["ranks"][0][1]["grads"], spf_dp_runs["per_scene"][0],
                        "scene-0 grad")


def test_spformer_train_cli_dp_and_resume(tmp_path):
    """``--dp 2`` on the tiny SPFormer configuration (loader batch 2 as the
    config's, ``base_batch_size`` 2) over 5 synthetic scenes for two
    epochs: each epoch is 2 steps (the fifth scene, a short last batch,
    dropped, as the JAX loader drops it), the learning rate of epoch e is
    ``poly_lr`` of the world batch's scaled rate, as the JAX CLI computes
    it; rank 0 writes the metrics and the checkpoint, and both ranks end
    in one state. A resume from epoch 1 reaches that state bit for bit."""
    cfg = port_train.load_config(TINY_SPF)
    kw = dict(device="cpu", synthetic=5, skip_validate=True)
    full = port_train.train_dp(cfg, str(tmp_path / "full"), 2, **kw)
    lr0 = cfg.train.lr * 2 / cfg.train.get("base_batch_size", 16)
    rec = [json.loads(x) for x in open(tmp_path / "full" / "metrics.jsonl")]
    assert [r["epoch"] for r in rec] == [1, 2]
    for r in rec:
        want = float(jax_poly_lr(lr0, r["epoch"] - 1, cfg.train.epochs, power=0.9))
        assert r["lr"] == pytest.approx(want, rel=1e-6)
        assert np.isfinite(r["loss"]) and "kl_loss" in r
    assert [r["steps"] for r in full["ranks"]] == [4, 4]
    assert full["ranks"][0]["digest"] == full["ranks"][1]["digest"]

    cfg1 = port_train.load_config(TINY_SPF)
    cfg1.train["epochs"] = 1
    port_train.train_dp(cfg1, str(tmp_path / "half"), 2, **kw)
    again = port_train.train_dp(cfg, str(tmp_path / "half"), 2,
                                resume=str(tmp_path / "half" / "latest"), **kw)
    assert [r["epoch"] for r in again["records"]] == [2]
    assert {r["digest"] for r in again["ranks"]} == {full["ranks"][0]["digest"]}
