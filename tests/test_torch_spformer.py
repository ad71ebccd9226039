"""SPFormer in the port against the JAX package.

The tiny configuration of ``configs/tiny_spformer_synthetic.yaml`` (media
8, 3 levels, 2 decoder layers, 16 queries, d_model 32, 4 heads), batch 2:
two synthetic scenes with seeded GP labels, the flat superpoint capacity
set to scene 0's superpoint count so that scene 1 keeps no valid
superpoint (as the trainer's flat capacity leaves scenes at batch 4,
``ROADMAP.md`` §3): its queries attend over no valid key. The weights are
the JAX init, redrawn, carried by ``convert.py``. Tolerances:

* forward outputs, and the targets' float pools: 1e-4 of each output's
  scale (fp32 sums in other orders through the U-Net and 2 decoder layers);
  discrete outputs exact;
* ``segment_weighted_mean``: 1e-6 relative (fp32 sums in another order);
* one step: losses 1e-4; each gradient leaf within 1e-3 of its largest |g|
  plus 1e-5; BatchNorm statistics 1e-5 (``test_torch_train.py``'s);
* instances: labels and masks exact, confidences 1e-5 relative;
* box AP: equal (the same numpy code on the same inputs);
* ``convert.py`` both ways: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.core import segment as jax_segment
from gapro_tpu.data import make_synthetic_scene, remap_semantic_for_training
from gapro_tpu.eval.instance_eval import ScanNetEval as JaxScanNetEval
from gapro_tpu.losses import criterion as jax_criterion
from gapro_tpu.losses import spformer_criterion as jax_spf_criterion
from gapro_tpu.models import inference as jax_inference
from gapro_tpu.models.prepare import prepare_voxel_batch as jax_prepare
from gapro_tpu.models.spformer import SPFormer as JaxSPFormer
from gapro_tpu.models.spformer import SPFormerConfig as JaxSPFormerConfig
from gapro_tpu.train.step import _spformer_loss_fn as jax_spf_loss_fn
from gapro_tpu_torch import convert
from gapro_tpu_torch.core import segment
from gapro_tpu_torch.eval.instance_eval import ScanNetEval
from gapro_tpu_torch.losses import criterion, spformer_criterion
from gapro_tpu_torch.models import inference, prepare, spformer
from gapro_tpu_torch.train import state, step

from tests.test_torch_isbnet import _randomize
from tests.test_torch_train import LOSS_TOL, _assert_trees_close, _leaves, _np_tree

SPF_KW = dict(media=8, blocks=3, num_layer=2, num_query=16, d_model=32, nhead=4,
              hidden_dim=64, spp_cap=256)
INST_CAP = 16
N_CAP = 4096


def _scene(seed):
    s = make_synthetic_scene(seed=seed, n_objects=3, points_per_object=200, n_floor=300,
                             n_wall=200)
    n = len(s.xyz)
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.0, 0.5, n).astype(np.float32)
    var[rng.random(n) < 0.2] = 0.0
    return dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
                semantic=remap_semantic_for_training(s.semantic_label),
                instance=s.instance_label, prob=rng.uniform(0.5, 1.0, n).astype(np.float32),
                mu=rng.normal(size=n).astype(np.float32), var=var)


def _prepare_both(scenes, n_spp):
    pb = prepare.points_to_batch_np(scenes, voxel_scale=10, n_cap=N_CAP)
    jprep = jax_prepare(jax.tree_util.tree_map(jnp.asarray, pb), N_CAP, len(scenes), 3, n_spp,
                        0.7)
    tprep = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, device="cpu"), N_CAP,
                                        len(scenes), 3, n_spp, 0.7)
    return jprep, tprep


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_outputs_close(got, want, rtol=1e-4):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for key in sorted(want):
        w, g = np.asarray(want[key]), _np(got[key])
        assert g.shape == w.shape, key
        if w.dtype.kind == "f":
            scale = max(1.0, float(np.abs(w).max())) if w.size else 1.0
            np.testing.assert_allclose(g, w, rtol=0, atol=rtol * scale, err_msg=key)
        else:
            np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.fixture(scope="module")
def base():
    scenes = [_scene(0), _scene(1)]
    _, probe = _prepare_both(scenes, 4096)
    b = probe.batch
    n0 = int(b.spp[b.valid & (b.batch_idx == 0)].max()) + 1  # scene 0's superpoints
    jprep, tprep = _prepare_both(scenes, n0)
    jmodel = JaxSPFormer(JaxSPFormerConfig(**SPF_KW))
    init = jax.jit(jmodel.init, static_argnums=(2,))(jax.random.PRNGKey(0), jprep.batch, False)
    variables = _np_tree(_randomize(init, seed=1))
    tmodel = spformer.SPFormer(spformer.SPFormerConfig(**SPF_KW), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    jout = _np_tree(jax.jit(jmodel.apply, static_argnums=(2,))(variables, jprep.batch, False))
    return dict(scenes=scenes, jprep=jprep, tprep=tprep, jmodel=jmodel, init=_np_tree(init),
                variables=variables, tmodel=tmodel, jout=jout, tout=tmodel(tprep.batch))


def test_convert_both_ways_matches_jax_init(base):
    """The JAX model's init loads strictly into the port, and the port's
    tree maps back to it leaf for leaf: the attention's [d, h, d/h] and
    [h, d/h, d] kernels and [h, d/h] biases, the LayerNorms, the queries and
    the auto-named modules."""
    init = base["init"]
    model = spformer.SPFormer(spformer.SPFormerConfig(**SPF_KW), device="cpu")
    convert.load_flax_variables(model, init)
    back = convert.to_flax_variables(model)
    for coll in ("params", "batch_stats"):
        got, want = dict(_leaves(back[coll])), dict(_leaves(init[coll]))
        assert set(got) == set(want), sorted(set(got) ^ set(want))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    attn = init["params"]["decoder"]["cross0"]["MultiHeadDotProductAttention_0"]
    assert attn["query"]["kernel"].shape == (32, 4, 8) and attn["out"]["kernel"].shape == (4, 8, 32)
    assert "LayerNorm_0" in init["params"]["decoder"]["self1"]
    assert init["params"]["decoder"]["query"].shape == (16, 32)
    assert model.decoder.ffn1.norm.eps == 1e-6


def test_segment_weighted_mean_matches_jax():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(500, 3)).astype(np.float32)
    seg = rng.integers(-2, 40, 500).astype(np.int32)
    w = rng.integers(0, 5, 500).astype(np.float32)
    w[seg == 7] = 0.0  # a segment of zero weight gives 0
    want = jax_segment.segment_weighted_mean(jnp.asarray(data), jnp.asarray(seg),
                                             jnp.asarray(w), 32)
    got = segment.segment_weighted_mean(torch.as_tensor(data), torch.as_tensor(seg),
                                        torch.as_tensor(w), 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert not got[7].any()


@pytest.mark.parametrize("pool", ["mean", "max"])
def test_build_targets_point_weighted_pools_match_jax(base, pool):
    """``build_targets`` with ``vox_weights`` (point-weighted mask fractions
    and pools) and ``pool``, field by field."""
    jp, tp = base["jprep"], base["tprep"]
    idx = base["jout"]["sp_dense_idx"]
    jb, tb = jp.batch, tp.batch
    want = jax_criterion.build_targets(
        jp.voxel_instance, jp.voxel_semantic, jb.coords_float, jb.spp, jb.batch_idx, jb.valid,
        jnp.asarray(idx), jb.n_spp, INST_CAP, voxel_prob=jp.voxel_prob, voxel_mu=jp.voxel_mu,
        voxel_var=jp.voxel_var, voxel_rgb=jp.voxel_rgb, vox_weights=jb.vox_npoints, pool=pool)
    got = criterion.build_targets(
        tp.voxel_instance, tp.voxel_semantic, tb.coords_float, tb.spp, tb.batch_idx, tb.valid,
        torch.tensor(idx), tb.n_spp, INST_CAP, voxel_prob=tp.voxel_prob,
        voxel_mu=tp.voxel_mu, voxel_var=tp.voxel_var, voxel_rgb=tp.voxel_rgb,
        vox_weights=tb.vox_npoints, pool=pool)
    _assert_outputs_close(got._asdict(), _np_tree(want._asdict()))
    assert float(np.asarray(want.gt_sp_masks).sum()) > 0
    plain = criterion.build_targets(
        tp.voxel_instance, tp.voxel_semantic, tb.coords_float, tb.spp, tb.batch_idx, tb.valid,
        torch.tensor(idx), tb.n_spp, INST_CAP, voxel_prob=tp.voxel_prob)
    assert not torch.equal(plain.sp_prob, got.sp_prob)  # the options change the pools


def test_spformer_forward_matches_jax(base):
    """Every output, each decoder head's labels / scores / masks included;
    batch item 1 has no valid superpoint and its rows stay finite."""
    jout, tout = base["jout"], base["tout"]
    assert jout["labels"].shape == (3, 2, 16, 19) and jout["masks"].shape == (3, 2, 16, 256)
    assert jout["sp_dense_valid"][0].sum() > 0 and not jout["sp_dense_valid"][1].any()
    assert all(np.isfinite(jout[k]).all() for k in ("labels", "scores", "masks"))
    _assert_outputs_close(tout, jout)


def test_spformer_step_matches_jax(base):
    """Losses, every gradient leaf, the new BatchNorm statistics and every
    decoder head's assignment of one training step against
    ``jax.value_and_grad`` of the JAX ``_spformer_loss_fn``."""
    jcrit = jax_spf_criterion.SPFormerCriterionConfig(inst_cap=INST_CAP)
    v, jprep, jmodel = base["variables"], base["jprep"], base["jmodel"]
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bs, pr: jax_spf_loss_fn(p, bs, jmodel, pr, jcrit), has_aux=True))
    (_, (jlosses, jbs)), jgrads = grad_fn(v["params"], v["batch_stats"], jprep)

    tmodel = spformer.SPFormer(spformer.SPFormerConfig(**SPF_KW), device="cpu")
    convert.load_flax_variables(tmodel, v)
    crit = spformer_criterion.SPFormerCriterionConfig(inst_cap=INST_CAP)
    st, tlosses = step.make_spformer_train_step(tmodel, crit)(
        state.create_train_state(tmodel, lr=2e-4, weight_decay=0.05), base["tprep"], 2e-4)
    assert st.step == 1
    jlosses = _np_tree(jlosses)
    assert set(tlosses) == set(jlosses)
    assert jlosses["kl_loss"] > 0 and jlosses["dice_loss"] > 0
    for k, want in jlosses.items():
        np.testing.assert_allclose(float(tlosses[k]), want, err_msg=k, **LOSS_TOL)
    _assert_trees_close(convert.to_flax_variables(tmodel, grads=True)["params"],
                        _np_tree(jgrads), "grad", rel=1e-3, atol=1e-5)
    _assert_trees_close(convert.to_flax_variables(tmodel)["batch_stats"], _np_tree(jbs),
                        "batch_stats", rel=1e-5, atol=1e-5)

    # every head's assignment, from the kernels' own matcher in each package
    tp, jout = base["tprep"], base["jout"]
    targets = step._targets(tp, base["tout"], INST_CAP, vox_weights=tp.batch.vox_npoints)
    got = spformer_criterion.spformer_match_layers(base["tout"], targets, crit)
    t = _np_tree(targets._asdict())
    for li in range(3):
        want = jax_spf_criterion.spformer_match(
            jnp.asarray(jout["labels"][li]), jnp.asarray(jout["masks"][li]),
            jnp.asarray(t["gt_cls"]), jnp.asarray(t["gt_sp_masks"]), jnp.asarray(t["gt_valid"]),
            jnp.asarray(jout["sp_dense_valid"]), jcrit)
        np.testing.assert_array_equal(got[li].numpy(), np.asarray(want), err_msg=f"head {li}")
    assert (got >= 0).sum() > 0


def test_spformer_get_instances_with_a_topk_tie(base):
    """The final head's records for scene 0 alone, after query 1 is given
    query 0's class logits and score, so that every class ties between the
    two in the flat top-k: ``lax.top_k`` takes the lower index first, and so
    must the port."""
    jprep, tprep = _prepare_both(base["scenes"][:1], 256)
    out = _np_tree(jax.jit(base["jmodel"].apply, static_argnums=(2,))(
        base["variables"], jprep.batch, False))
    for key in ("labels", "scores"):
        out[key] = out[key].copy()
        out[key][-1, 0, 1] = out[key][-1, 0, 0]
    flat = (jax.nn.softmax(out["labels"][-1, 0], -1)[:, :18] * out["scores"][-1, 0][:, None])
    flat = np.asarray(flat).reshape(-1)
    top = np.argsort(-flat, kind="stable")[:24]
    assert len(set(flat[top])) < len(top)  # ties inside the top 24
    spp = base["scenes"][0]["spp"]
    n = len(base["scenes"][0]["xyz"])
    kw = dict(topk_insts=24, score_thr=-1e9, npoint_thr=0)
    want = jax_inference.spformer_get_instances(
        "s0", jax.tree_util.tree_map(jnp.asarray, out), jprep.batch, spp,
        np.asarray(jprep.point2voxel), n, **kw)
    got = inference.spformer_get_instances(
        "s0", {k: torch.as_tensor(v) for k, v in out.items()}, tprep.batch, spp,
        tprep.point2voxel, n, **kw)
    assert len(got) == len(want) == 24
    for g, w in zip(got, want):
        assert g["label_id"] == w["label_id"] and g["scan_id"] == w["scan_id"]
        assert g["pred_mask"]["length"] == w["pred_mask"]["length"] == n
        np.testing.assert_array_equal(g["pred_mask"]["counts"], w["pred_mask"]["counts"])
        np.testing.assert_allclose(g["conf"], w["conf"], rtol=1e-5)


def _assert_results_equal(got, want, path="result"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_results_equal(got[k], want[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got, float), np.asarray(want, float),
                                      err_msg=path)


def test_evaluate_box_matches_jax():
    """Box AP on two synthetic scenes: predictions from the ground-truth
    instances with points moved in and out, and with wrong labels."""
    rng = np.random.default_rng(5)
    preds, coords, sems, insts = [], [], [], []
    for seed in range(2):
        s = make_synthetic_scene(seed=seed, n_objects=5, points_per_object=300, n_floor=400,
                                 n_wall=300)
        sem = remap_semantic_for_training(s.semantic_label)
        scene_preds = []
        for i in np.unique(s.instance_label[s.instance_label >= 0]):
            m = (s.instance_label == i) & (rng.random(len(s.xyz)) < 0.9)
            if rng.random() < 0.3:  # a part of the instance only
                m &= s.xyz[:, 0] < np.median(s.xyz[m, 0])
            label = int(np.bincount(sem[s.instance_label == i].clip(0)).argmax()) + 1
            if rng.random() < 0.2:
                label = int(rng.integers(1, 19))
            scene_preds.append(dict(scan_id=f"s{seed}", label_id=label,
                                    conf=float(rng.random()), pred_mask=m.astype(np.uint8)))
        preds.append(scene_preds)
        coords.append(s.xyz)
        sems.append(sem)
        insts.append(s.instance_label)
    want = JaxScanNetEval().evaluate_box(preds, coords, sems, insts)
    got = ScanNetEval().evaluate_box(preds, coords, sems, insts)
    assert want["all_ap_25%"] > 0
    _assert_results_equal(got, want)
