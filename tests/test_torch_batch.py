"""The port at batch 2 against the JAX package.

Two synthetic scenes share one padded point batch. The tiny configuration
of ``__graft_entry__.py`` runs through both packages with the same weights,
with room for every superpoint (a dense capacity of 1024 per scene and a
flat one of 2048 for the batch), so that both batch items carry masks: at
the configuration's 256, shared by the batch, the first scene's
superpoints fill every flat slot and the second gets none.

* ``prepare_voxel_batch``: every table equal;
* ``forward`` in eval and training mode and ``forward_inference``: discrete
  outputs equal, floats within rtol = atol = 1e-4
  (``tests/test_torch_isbnet.py``);
* ``get_instances`` (batch item 0, as in both packages);
* one training step against ``jax.value_and_grad`` of the JAX ``_loss_fn``
  with the tolerances of ``tests/test_torch_train.py``: losses 1e-4, each
  gradient leaf 1e-3 of its scale plus 1e-5, BatchNorm statistics 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.data import make_synthetic_scene, remap_semantic_for_training
from gapro_tpu.losses import criterion as jax_criterion
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxConfig
from gapro_tpu.models import inference as jax_inference
from gapro_tpu.models.prepare import points_to_batch_np, prepare_voxel_batch
from gapro_tpu.train.step import _loss_fn as jax_loss_fn
from gapro_tpu_torch import convert
from gapro_tpu_torch.losses import criterion
from gapro_tpu_torch.models import inference, isbnet, prepare
from gapro_tpu_torch.train import state, step

from tests.test_torch_isbnet import ROUNDS, TOL, _np, _randomize, _tiny_cfg_kwargs
from tests.test_torch_train import INST_CAP, LOSS_TOL, _assert_trees_close, _np_tree

B = 2
N_CAP = 4096
SPP_FLAT = 2048


def _cfg_kwargs():
    return dict(_tiny_cfg_kwargs(), spp_cap=1024)


def _scenes():
    out = []
    for seed in range(B):
        s = make_synthetic_scene(seed=seed, n_objects=3, points_per_object=200, n_floor=300,
                                 n_wall=200)
        n = len(s.xyz)
        rng = np.random.default_rng(seed)
        var = rng.uniform(0.0, 0.5, n).astype(np.float32)
        var[rng.random(n) < 0.2] = 0.0
        out.append(dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
                        semantic=remap_semantic_for_training(s.semantic_label),
                        instance=s.instance_label,
                        prob=rng.uniform(0.5, 1.0, n).astype(np.float32),
                        mu=rng.normal(size=n).astype(np.float32), var=var))
    return out


@pytest.fixture(scope="module")
def run():
    scenes = _scenes()
    pb = points_to_batch_np(scenes, voxel_scale=10, n_cap=N_CAP)
    jprep = prepare_voxel_batch(jax.tree_util.tree_map(jnp.asarray, pb), N_CAP, B, 3, SPP_FLAT,
                                0.7)
    tprep = prepare.prepare_voxel_batch(prepare.upload_point_batch(
        prepare.points_to_batch_np(scenes, voxel_scale=10, n_cap=N_CAP), device="cpu"),
        N_CAP, B, 3, SPP_FLAT, 0.7)
    jmodel = JaxISBNet(JaxConfig(**_cfg_kwargs()))
    init = jax.jit(jmodel.init, static_argnums=(2,))
    variables = _np_tree(_randomize(init(jax.random.PRNGKey(0), jprep.batch, False), seed=1))
    infer = jax.jit(lambda v, b: jmodel.apply(v, b, method=lambda m, x: m.forward_inference(
        x, ROUNDS)))
    tmodel = isbnet.ISBNet(isbnet.ISBNetConfig(**_cfg_kwargs()), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    return dict(scenes=scenes, jprep=jprep, tprep=tprep, variables=variables, jmodel=jmodel,
                tmodel=tmodel,
                jout=dict(inference=_np_tree(infer(variables, jprep.batch)),
                          eval=_np_tree(jax.jit(jmodel.apply)(variables, jprep.batch))),
                tout=dict(inference=tmodel.forward_inference(tprep.batch, ROUNDS),
                          eval=tmodel(tprep.batch)))


def test_prepare_batch2_matches_jax(run):
    jp, tp = run["jprep"], run["tprep"]
    assert int(np.asarray(jp.batch.batch_idx)[np.asarray(jp.batch.valid)].max()) == B - 1
    for name in ("point2voxel", "voxel_semantic", "voxel_instance", "voxel_prob", "voxel_mu",
                 "voxel_var", "voxel_rgb"):
        np.testing.assert_array_equal(_np(getattr(tp, name)), np.asarray(getattr(jp, name)),
                                      err_msg=name)
    for name in ("feats", "coords_float", "batch_idx", "valid", "spp"):
        np.testing.assert_array_equal(_np(getattr(tp.batch, name)),
                                      np.asarray(getattr(jp.batch, name)), err_msg=name)
    for lvl, (tl, jl) in enumerate(zip(tp.batch.plan.levels, jp.batch.plan.levels)):
        np.testing.assert_array_equal(_np(tl.subm_nbr), np.asarray(jl.subm_nbr),
                                      err_msg=f"level {lvl} subm_nbr")
        np.testing.assert_array_equal(_np(tl.grid.coords), np.asarray(jl.grid.coords),
                                      err_msg=f"level {lvl} coords")


@pytest.mark.parametrize("path", ["inference", "eval"])
def test_forward_batch2_matches_jax(run, path):
    jout, tout = run["jout"][path], run["tout"][path]
    assert set(tout) == set(jout)
    assert tout["mask_logits"].shape[0] == B
    # both batch items sample queries and have superpoints, none dropped
    assert (np.asarray(jout["query_valid"]).sum(1) > 0).all()
    assert (np.asarray(jout["sp_dense_valid"]).sum(1) > 0).all()
    assert int(jout["ovf_spp_slots"]) == 0
    for key in sorted(jout):
        want, got = np.asarray(jout[key]), _np(tout[key])
        assert got.shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_get_instances_batch2_matches_jax(run):
    scene = run["scenes"][0]
    n = len(scene["xyz"])
    kw = dict(npoint_thresh=10, topk=16, topk_insts=32)
    want = jax_inference.get_instances(
        "s0", run["jout"]["inference"], run["jprep"].batch, np.asarray(scene["spp"]),
        np.asarray(run["jprep"].point2voxel), n, jax_inference.TestConfig(**kw))
    got = inference.get_instances("s0", run["tout"]["inference"], run["tprep"].batch,
                                  np.asarray(scene["spp"]), run["tprep"].point2voxel, n,
                                  inference.TestConfig(**kw))
    assert len(want) > 0 and len(got) == len(want)
    for g, w in zip(got, want):
        assert g["label_id"] == w["label_id"]
        np.testing.assert_allclose(g["conf"], w["conf"], **TOL)
        np.testing.assert_array_equal(g["pred_mask"]["counts"], w["pred_mask"]["counts"])


def test_train_step_batch2_matches_jax(run):
    jprep, tprep, variables = run["jprep"], run["tprep"], run["variables"]
    jcrit = jax_criterion.CriterionConfig(inst_cap=INST_CAP)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bs, pr: jax_loss_fn(p, bs, run["jmodel"], pr, jcrit), has_aux=True))
    (_, (jlosses, jbs)), jgrads = grad_fn(variables["params"], variables["batch_stats"], jprep)
    tmodel = isbnet.ISBNet(isbnet.ISBNetConfig(**_cfg_kwargs()), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    tstate = state.create_train_state(tmodel, lr=1e-3)
    tstate, tlosses = step.make_train_step(tmodel, criterion.CriterionConfig(inst_cap=INST_CAP))(
        tstate, tprep, 1e-3)
    jlosses = _np_tree(jlosses)
    assert set(tlosses) == set(jlosses) and float(jlosses["kl_loss"]) > 0
    for k, want in jlosses.items():
        np.testing.assert_allclose(float(tlosses[k]), want, err_msg=k, **LOSS_TOL)
    _assert_trees_close(convert.to_flax_variables(tmodel, grads=True)["params"],
                        _np_tree(jgrads), "grad", rel=1e-3, atol=1e-5)
    _assert_trees_close(convert.to_flax_variables(tmodel)["batch_stats"], _np_tree(jbs),
                        "batch_stats", rel=1e-5, atol=1e-5)
