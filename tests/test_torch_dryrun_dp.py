"""The port's multi-device dry run (``gapro_tpu_torch/tools/dryrun_dp.py``)
against ``__graft_entry__.py``'s.

* Its inputs: ``_tiny_cfgs`` field for field, ``_tiny_point_batch(seed)``
  and ``_tiny_prepared`` array for array and bit for bit, and the SPFormer stage's and the scaled
  C = 32 stage's configurations, scenes, in-step plans and learning rates
  against the literals of ``__graft_entry__.py:dryrun_multichip`` and
  ``_dryrun_scaled`` (read from its source: they are local to those
  functions). The JAX scaled stage takes minutes to compile on the CPU, so
  the port's scaled stage is held here by its inputs only, and runs on the
  card.
* ``dryrun_multichip(2, device="cpu", scaled=False)`` on 2 gloo ranks
  prints both ``ok`` lines, and its ISBNet and SPFormer losses (weights
  [1, 0]: rank 1 is the filler) agree within ``LOSS_TOL``
  (``tests/test_torch_train.py``: 1e-4 relative and absolute) with JAX's
  2-device ``make_dp_train_step`` from the port's seed-0 weights on the same
  tiny scenes, prepared by the JAX package.

The card's case, ``dryrun_multichip(4, "cuda")``, lives in
``tests/test_torch_dp_card.py``, which imports no JAX.
"""

import ast
import dataclasses
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from gapro_tpu.data import make_synthetic_scene as jax_scene
from gapro_tpu.data import remap_semantic_for_training as jax_remap
from gapro_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from gapro_tpu.losses.spformer_criterion import SPFormerCriterionConfig as JaxSPFCritConfig
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxISBNetConfig
from gapro_tpu.models.prepare import points_to_batch_np as jax_points_to_batch_np
from gapro_tpu.models.spformer import SPFormer as JaxSPFormer
from gapro_tpu.models.spformer import SPFormerConfig as JaxSPFormerConfig
from gapro_tpu.train.state import create_train_state as jax_train_state
from gapro_tpu.train.step import _spformer_loss_fn as jax_spf_loss_fn
from gapro_tpu.train.step import make_dp_train_step as jax_dp_step
from gapro_tpu_torch import convert
from gapro_tpu_torch.tools import dryrun_dp

from tests.test_torch_dp import _two_threads  # noqa: F401 (the module's autouse fixture)
from tests.test_torch_train import LOSS_TOL, _np_tree

GRAFT = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "__graft_entry__.py")


def _literal(node):
    try:
        return ast.literal_eval(node)
    except ValueError:
        return None


def _calls(function: str) -> dict:
    """Every call in ``__graft_entry__.py``'s ``function``, by the called
    name: a list of (literal positional arguments, literal keywords), a
    non-literal argument as None; and the literal assignments, under
    ``"="``."""
    tree = ast.parse(open(GRAFT).read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    out = {"=": {}}
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr", None)
            kw = {k.arg: _literal(k.value) for k in node.keywords}
            out.setdefault(name, []).append(([_literal(a) for a in node.args],
                                             {k: v for k, v in kw.items() if v is not None}))
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            value = _literal(node.value)
            if value is not None:
                out["="][node.targets[0].id] = value
    return out


def _assert_cfg_equal(port_cfg, jax_cfg):
    """Every field of the port's configuration equal to the JAX one's."""
    for f in dataclasses.fields(port_cfg):
        want = getattr(jax_cfg, f.name)
        got = getattr(port_cfg, f.name)
        assert (tuple(got) if isinstance(got, (list, tuple)) else got) == (
            tuple(want) if isinstance(want, (list, tuple)) else want), f.name


def _assert_point_batch_equal(got, want):
    assert type(got)._fields == type(want)._fields
    for name, g, w in zip(type(got)._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def _stage(name):
    return next(s for s in dryrun_dp.stages(scaled=True) if s.name == name)


def test_tiny_cfgs_equal_jax():
    port_model, port_crit = dryrun_dp._tiny_cfgs()
    jax_model, jax_crit = graft._tiny_cfgs()
    _assert_cfg_equal(port_model, jax_model)
    _assert_cfg_equal(port_crit, jax_crit)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_tiny_point_batch_equals_jax(seed):
    _assert_point_batch_equal(dryrun_dp._tiny_point_batch(seed), graft._tiny_point_batch(seed))


def test_tiny_prepared_equals_jax():
    """``_tiny_prepared``: the voxel batch's arrays and the voxel labels
    equal the JAX package's bit for bit."""
    got, want = dryrun_dp._tiny_prepared(0), graft._tiny_prepared(0)
    for name in ("feats", "coords_float", "batch_idx", "valid", "spp", "vox_npoints"):
        np.testing.assert_array_equal(getattr(got.batch, name).numpy(),
                                      np.asarray(getattr(want.batch, name)), err_msg=name)
    for name in got._fields[1:]:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_stage_inputs_equal_jax():
    """The SPFormer stage's configurations, plan and learning rate, and the
    ISBNet stage's plan and learning rate, against ``dryrun_multichip``'s
    literals."""
    calls = _calls("dryrun_multichip")
    (spf_kw,) = [kw for _, kw in calls["SPFormerConfig"]]
    (crit_kw,) = [kw for _, kw in calls["SPFormerCriterionConfig"]]
    spf = _stage("SPFormer")
    _assert_cfg_equal(spf.model_cfg, JaxSPFormerConfig(**spf_kw))
    _assert_cfg_equal(spf.crit_cfg, JaxSPFCritConfig(**crit_kw))
    (plan,) = [args[2:] for args, _ in calls["prepare_voxel_batch"]]  # batch, levels, spp, shrink
    lrs = [args[0] for args, _ in calls["float32"] if args[0] is not None]
    for stage, lr in zip((_stage("ISBNet"), spf), lrs):
        assert [1, stage.model_cfg.unet_levels, stage.spp_cap, stage.shrink] == plan, stage.name
        assert stage.lr == lr, stage.name
    assert len(lrs) == 2


def test_scaled_stage_inputs_equal_jax():
    """The scaled C = 32 stage's configurations, plan, learning rate and
    scenes (seeds 0-3) against ``_dryrun_scaled``'s literals."""
    calls = _calls("_dryrun_scaled")
    stage = _stage("scaled C=32")
    (cfg_kw,) = [kw for _, kw in calls["ISBNetConfig"]]
    (crit_kw,) = [kw for _, kw in calls["CriterionConfig"]]
    _assert_cfg_equal(stage.model_cfg, JaxISBNetConfig(**cfg_kw))
    _assert_cfg_equal(stage.crit_cfg, JaxCriterionConfig(**crit_kw))
    (plan,) = [args[2:] for args, _ in calls["prepare_voxel_batch"]]
    assert [1, stage.model_cfg.unet_levels, stage.spp_cap, stage.shrink] == plan
    assert [args[0] for args, _ in calls["float32"]] == [stage.lr]
    (scene_kw,) = [kw for _, kw in calls["make_synthetic_scene"]]
    (batch_kw,) = [kw for _, kw in calls["points_to_batch_np"]]
    n_cap = calls["="]["n_cap"]
    assert dryrun_dp.SCALED_N_CAP == n_cap
    for seed in range(4):
        s = jax_scene(seed=seed, **scene_kw)
        want = jax_points_to_batch_np(
            [dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp, semantic=jax_remap(s.semantic_label),
                  instance=s.instance_label)], n_cap=n_cap, **batch_kw)
        _assert_point_batch_equal(stage.point_batch(seed), want)


def _jax_dp_losses(stage, jax_model, jax_crit, loss_fn=None):
    """JAX's 2-device step at weights [1, 0] from the port's seed-0 weights
    on ``graft._tiny_prepared`` of seeds 0 and 1."""
    from jax.sharding import Mesh

    variables = _np_tree(convert.to_flax_variables(stage.build("cpu")))
    kw = {} if loss_fn is None else dict(loss_fn=loss_fn)
    step = jax_dp_step(jax_model, jax_crit, Mesh(np.array(jax.devices()[:2]), ("dp",)), **kw)
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *[graft._tiny_prepared(seed) for seed in (0, 1)])
    _, losses = step(jax_train_state(variables), stacked, jnp.float32(stage.lr),
                     jnp.asarray([1.0, 0.0], jnp.float32))
    return {k: float(v) for k, v in losses.items()}


def test_dryrun_two_ranks_matches_jax(capsys):
    spf_kw = [kw for _, kw in _calls("dryrun_multichip")["SPFormerConfig"]][0]
    with ThreadPoolExecutor(1) as pool:  # the ranks run beside the JAX steps
        run = pool.submit(dryrun_dp.dryrun_multichip, 2, device="cpu", scaled=False,
                          timeout_s=300)
        jax_isb, jax_isb_crit = graft._tiny_cfgs()
        want = {"ISBNet": _jax_dp_losses(_stage("ISBNet"), JaxISBNet(jax_isb), jax_isb_crit),
                "SPFormer": _jax_dp_losses(_stage("SPFormer"),
                                           JaxSPFormer(JaxSPFormerConfig(**spf_kw)),
                                           JaxSPFCritConfig(inst_cap=16), jax_spf_loss_fn)}
        got = run.result()
    printed = capsys.readouterr().out
    assert got["backend"] == "gloo" and got["devices"] == ["cpu", "cpu"]
    assert "scaled C=32" not in got
    for name in ("ISBNet", "SPFormer"):
        assert f"dryrun_multichip(2) {name} ok: loss={got[name]['losses']['loss']:.4f}" in printed
        assert set(got[name]["losses"]) == set(want[name])
        for k, v in want[name].items():
            np.testing.assert_allclose(got[name]["losses"][k], v, err_msg=f"{name} {k}",
                                       **LOSS_TOL)
        assert len({r["digest"] for r in got[name]["ranks"]}) == 1


def test_dryrun_raises_without_a_card(monkeypatch):
    """The dry run runs on the card unless the caller names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_dp.dryrun_multichip(2)
