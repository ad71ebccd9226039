"""The port's ISBNet training step against the JAX package.

The tiny configuration of ``__graft_entry__.py`` (C = 8, 3 levels, spp_cap
256, inst_cap 16, every voxel foreground) takes one step in both packages
from the same weights (the redrawn flax init of ``test_torch_isbnet.py``) on
one synthetic scene with seeded per-point GP labels, so that both KL
branches and the prob-weighted BCE run. Tolerances:

* losses: 1e-4 (relative and absolute), fp32 sums in other orders;
* gradients: each leaf within 1e-3 of its largest |g|, plus 1e-5 absolute.
  Sums in other orders compound through the backward; a bias right before a
  batch-statistics BatchNorm has an exact gradient of 0, so both packages
  hold only rounding noise there (of order 1e-6);
* BatchNorm statistics: 1e-5; AdamW fed the same gradients: 1e-6.
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gapro_tpu.losses.matcher as jax_matcher
from gapro_tpu.data import make_synthetic_scene, remap_semantic_for_training
from gapro_tpu.losses import criterion as jax_criterion
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxConfig
from gapro_tpu.models.prepare import points_to_batch_np, prepare_voxel_batch
from gapro_tpu.train import state as jax_state
from gapro_tpu.train.step import _loss_fn as jax_loss_fn
from gapro_tpu_torch import convert
from gapro_tpu_torch.losses import criterion, matcher
from gapro_tpu_torch.models import common, isbnet, prepare
from gapro_tpu_torch.train import state, step

from tests.test_torch_isbnet import _randomize, _tiny_cfg_kwargs

N_CAP = 2048
INST_CAP = 16
FROZEN = ("input_conv", "unet", "output_layer", "semantic_linear",
          "offset_vertices_linear", "box_conf_linear")
FROZEN_KEYS = {"backbone", "semantic_linear", "offset_vertices_linear", "box_conf_linear"}
LOSS_TOL = dict(rtol=1e-4, atol=1e-4)


def _scene():
    s = make_synthetic_scene(seed=0, n_objects=3, points_per_object=200, n_floor=300, n_wall=200)
    n = len(s.xyz)
    rng = np.random.default_rng(0)
    var = rng.uniform(0.0, 0.5, n).astype(np.float32)
    var[rng.random(n) < 0.2] = 0.0
    return dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
                semantic=remap_semantic_for_training(s.semantic_label),
                instance=s.instance_label, prob=rng.uniform(0.5, 1.0, n).astype(np.float32),
                mu=rng.normal(size=n).astype(np.float32), var=var)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree, path=()):
    """(path, array) of every leaf of a nested dict."""
    if hasattr(tree, "items"):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield "/".join(path), np.asarray(tree)


def _assert_trees_close(got, want, what, rel=None, atol=0.0):
    """Leaf by leaf; ``rel`` scales the tolerance by each leaf's max |x|."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w), f"{what}: leaves differ: {sorted(set(g) ^ set(w))}"
    for k in w:
        tol = atol + (rel * float(np.abs(w[k]).max()) if rel else 0.0)
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= tol, f"{what} {k}: max |err| {err:.3g} > {tol:.3g}"


@pytest.fixture(scope="module")
def base():
    """The scene prepared by both packages and the shared initial weights."""
    scene = _scene()
    pb = points_to_batch_np([scene], voxel_scale=10, n_cap=N_CAP)
    jprep = prepare_voxel_batch(jax.tree_util.tree_map(jnp.asarray, pb), N_CAP, 1, 3, 256, 0.7)
    tprep = prepare.prepare_voxel_batch(
        prepare.upload_point_batch(prepare.points_to_batch_np([scene], voxel_scale=10,
                                                              n_cap=N_CAP), device="cpu"),
        N_CAP, 1, 3, 256, 0.7)
    init = jax.jit(JaxISBNet(JaxConfig(**_tiny_cfg_kwargs())).init, static_argnums=(2,))
    variables = _np_tree(_randomize(init(jax.random.PRNGKey(0), jprep.batch, False), seed=1))
    return dict(jprep=jprep, tprep=tprep, variables=variables)


def _run_both(base, fixed_modules):
    """One step of each package from the same weights and scene."""
    jprep, tprep, variables = base["jprep"], base["tprep"], base["variables"]
    kw = dict(_tiny_cfg_kwargs(), fixed_modules=fixed_modules)
    jmodel = JaxISBNet(JaxConfig(**kw))
    jcrit = jax_criterion.CriterionConfig(inst_cap=INST_CAP)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bs, pr: jax_loss_fn(p, bs, jmodel, pr, jcrit), has_aux=True))
    (_, (jlosses, jbs)), jgrads = grad_fn(variables["params"], variables["batch_stats"], jprep)

    tmodel = isbnet.ISBNet(isbnet.ISBNetConfig(**kw), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    tstate = state.create_train_state(tmodel, lr=1e-3, fixed_modules=fixed_modules)
    tstate, tlosses = step.make_train_step(tmodel, criterion.CriterionConfig(inst_cap=INST_CAP))(
        tstate, tprep, 1e-3)
    return dict(base, jlosses=_np_tree(jlosses), jbs=_np_tree(jbs), jgrads=_np_tree(jgrads),
                tmodel=tmodel, tstate=tstate,
                tlosses={k: float(v) for k, v in tlosses.items()})


@pytest.fixture(scope="module")
def trained(base):
    return _run_both(base, ())


@pytest.fixture(scope="module")
def trained_frozen(base):
    return _run_both(base, FROZEN)


def _check_step(r):
    assert set(r["tlosses"]) == set(r["jlosses"])
    for k, want in r["jlosses"].items():
        np.testing.assert_allclose(r["tlosses"][k], want, err_msg=k, **LOSS_TOL)
    _assert_trees_close(convert.to_flax_variables(r["tmodel"], grads=True)["params"],
                        r["jgrads"], "grad", rel=1e-3, atol=1e-5)
    _assert_trees_close(convert.to_flax_variables(r["tmodel"])["batch_stats"], r["jbs"],
                        "batch_stats", rel=1e-5, atol=1e-5)


def test_train_step_matches_jax(trained):
    """Losses, every parameter gradient and the new BatchNorm statistics of
    ``make_train_step`` against ``jax.value_and_grad(_loss_fn)``."""
    assert trained["jlosses"]["kl_loss"] > 0 and trained["jlosses"]["bce_loss"] > 0
    assert trained["tstate"].step == 1
    _check_step(trained)


def test_frozen_modules_match_jax(trained_frozen):
    """With ``fixed_modules`` the frozen parameters do not move, their
    BatchNorm statistics stay, and the rest matches the JAX step."""
    r = trained_frozen
    _check_step(r)
    after = convert.to_flax_variables(r["tmodel"])
    moved = set()
    for coll in ("params", "batch_stats"):
        for key in after[coll]:
            before, now = dict(_leaves(r["variables"][coll][key])), dict(_leaves(after[coll][key]))
            if any(not np.array_equal(before[k], now[k]) for k in before):
                moved.add((coll, key))
    assert not {key for _, key in moved} & FROZEN_KEYS, sorted(moved)
    assert {key for coll, key in moved if coll == "params"} == set(after["params"]) - FROZEN_KEYS
    assert ("batch_stats", "point_aggregator1") in moved


@pytest.mark.parametrize("fixed_modules", [(), FROZEN])
def test_adamw_matches_optax(trained, fixed_modules):
    """Three updates fed the same gradients, each with its own injected
    learning rate, against ``optax.adamw`` (with the frozen modules masked)."""
    variables = trained["variables"]
    jst = jax_state.create_train_state(variables, lr=1e-3, fixed_modules=fixed_modules)
    tmodel = isbnet.ISBNet(isbnet.ISBNetConfig(**_tiny_cfg_kwargs()), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    tst = state.create_train_state(tmodel, lr=1e-3, fixed_modules=fixed_modules)
    rng = np.random.default_rng(7)
    params = dict(tmodel.named_parameters())
    update = jax.jit(lambda st, g, lr: st.apply_gradients(g, lr=lr))
    for lr in (1e-3, 5e-4, 2e-4):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=x.shape).astype(np.float32), variables["params"])
        jst = update(jst, grads, jnp.float32(lr))
        for name, g in convert.flax_to_state_dict({"params": grads}).items():
            params[name].grad = g
        tst = tst.apply_gradients(lr=lr)
        _assert_trees_close(convert.to_flax_variables(tmodel)["params"], _np_tree(jst.params),
                            f"params at lr {lr}", atol=1e-6)


@pytest.mark.parametrize("shape,mask_shape,eps", [((300, 16), (300, 1), 1e-4),
                                                  ((2, 12, 5, 8), (2, 12, 1, 1), 1e-5)])
def test_batchnorm_train_matches_flax(shape, mask_shape, eps):
    """Training-mode BatchNorm against flax ``nn.BatchNorm(mask=...)``: the
    output, the new running statistics and the input gradient, with a mask
    that leaves out rows and a constant channel (a variance of exactly 0,
    where ``jnp.maximum`` splits the gradient)."""
    rng = np.random.default_rng(len(shape))
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32) * 2 + 0.5
    x[..., 0] = 1.5
    mask = rng.random(mask_shape) > 0.3
    g = rng.normal(size=shape).astype(np.float32)
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32)},
                 "batch_stats": {"mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=eps)

    def f(xx):
        y, upd = bn.apply(variables, xx, mask=jnp.asarray(mask), mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (want_y, want_bs)), want_dx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))

    tbn = common.BatchNorm(c, eps)
    with torch.no_grad():
        tbn.weight.copy_(torch.tensor(variables["params"]["scale"]))
        tbn.bias.copy_(torch.tensor(variables["params"]["bias"]))
        tbn.running_mean.copy_(torch.tensor(variables["batch_stats"]["mean"]))
        tbn.running_var.copy_(torch.tensor(variables["batch_stats"]["var"]))
    tbn.train()
    tx = torch.tensor(x, requires_grad=True)
    y = tbn(tx, torch.tensor(mask))
    (y * torch.tensor(g)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **tol)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(want_bs["mean"]), **tol)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(want_bs["var"]), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_dx), rtol=1e-4, atol=1e-4)


def test_matcher_matches_jax(monkeypatch):
    """The cost matrices equal the JAX matcher's to 1e-5, and the assignment
    is the same."""
    rng = np.random.default_rng(11)
    B, Q, I, S, C = 2, 24, 7, 40, 19
    lo = rng.uniform(-1, 0, (B, Q, 3))
    glo = rng.uniform(-1, 0, (B, I, 3))
    args = [rng.normal(size=(B, Q, C)), rng.normal(size=(B, Q, S)) * 2, rng.normal(size=(B, Q)),
            np.concatenate([lo, lo + rng.uniform(0.1, 1, (B, Q, 3))], -1),
            rng.integers(0, C - 1, (B, I)), (rng.random((B, I, S)) > 0.6),
            np.concatenate([glo, glo + rng.uniform(0.1, 1, (B, I, 3))], -1),
            rng.random((B, I)) > 0.2, rng.random((B, S)) > 0.1, rng.random((B, Q)) > 0.1]
    args = [a.astype(np.float32) if a.dtype.kind == "f" else a for a in args]
    args[5] = args[5].astype(np.float32)
    args[4] = args[4].astype(np.int32)

    seen = {}
    host = jax_matcher._lsap_host

    def recording(cost):
        seen["cost"] = np.asarray(cost)
        return host(cost)

    monkeypatch.setattr(jax_matcher, "_lsap_host", recording)
    want = np.asarray(jax_matcher.hungarian_match(*(jnp.asarray(a) for a in args)))
    targs = [torch.tensor(a) for a in args]
    np.testing.assert_allclose(matcher.match_costs(*targs).numpy(), seen["cost"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(matcher.hungarian_match(*targs).numpy(), want)


def _jax_outputs(tout):
    return {k: jnp.asarray(v.detach().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tout.items()}


def test_criterion_matches_jax(trained):
    """``build_targets``, every instance term and the point-wise terms on
    the same outputs, with the JAX matcher's assignment injected."""
    tprep, jprep = trained["tprep"], trained["jprep"]
    tmodel = copy.deepcopy(trained["tmodel"]).train()
    with torch.no_grad():
        tout = tmodel(tprep.batch)
    jout = _jax_outputs(tout)
    b, jb = tprep.batch, jprep.batch
    tt = criterion.build_targets(
        tprep.voxel_instance, tprep.voxel_semantic, b.coords_float, b.spp, b.batch_idx, b.valid,
        tout["sp_dense_idx"], b.n_spp, INST_CAP, voxel_prob=tprep.voxel_prob,
        voxel_mu=tprep.voxel_mu, voxel_var=tprep.voxel_var, voxel_rgb=tprep.voxel_rgb)
    jt = jax_criterion.build_targets(
        jprep.voxel_instance, jprep.voxel_semantic, jb.coords_float, jb.spp, jb.batch_idx,
        jb.valid, jout["sp_dense_idx"], jb.n_spp, INST_CAP, voxel_prob=jprep.voxel_prob,
        voxel_mu=jprep.voxel_mu, voxel_var=jprep.voxel_var, voxel_rgb=jprep.voxel_rgb)
    assert int(jt.num_gts) > 0
    for name in jt._fields:
        np.testing.assert_allclose(np.asarray(getattr(tt, name)), np.asarray(getattr(jt, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)

    jassign = jax_matcher.hungarian_match(
        jout["cls_logits"], jout["mask_logits"], jout["conf_logits"], jout["query_box_preds"],
        jt.gt_cls, jt.gt_sp_masks, jt.gt_boxes, jt.gt_valid, jout["sp_dense_valid"],
        jout["query_valid"])
    cfg = criterion.CriterionConfig(inst_cap=INST_CAP, trainall=True)
    got = criterion.isbnet_loss(tout, tprep, tt, cfg,
                                assign=torch.tensor(np.asarray(jassign)))
    want = jax_criterion.instance_loss(jout, jt, jax_criterion.CriterionConfig(inst_cap=INST_CAP),
                                       assign=jassign)
    want = {k: float(want[k]) * w for k, w in cfg.loss_weight}
    pw = jax_criterion.pointwise_loss(jout, jprep.voxel_semantic, jprep.voxel_instance,
                                      jt.corners_offset_labels, jb.coords_float, jb.valid, cfg)
    want.update({k: 0.25 * float(v) for k, v in pw.items()})
    want["loss"] = sum(want.values())
    assert set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, err_msg=k, **LOSS_TOL)


def test_weight_bridge_round_trips(trained):
    """``to_flax_variables`` inverts ``load_flax_variables`` exactly."""
    tmodel = isbnet.ISBNet(isbnet.ISBNetConfig(**_tiny_cfg_kwargs()), device="cpu")
    variables = trained["variables"]
    convert.load_flax_variables(tmodel, variables)
    back = dict(_leaves(convert.to_flax_variables(tmodel)))
    want = dict(_leaves(variables))
    assert back.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
