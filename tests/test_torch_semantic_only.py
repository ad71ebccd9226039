"""ISBNet's backbone pre-training stage (``semantic_only``) in the port
against the JAX package.

The tiny configuration of ``test_torch_train.py`` with ``semantic_only``
(the model holds the backbone and the point-wise heads only) takes the same
weights, carried by ``convert.py`` from the JAX init, on the same scene.
Tolerances, as ``test_torch_train.py`` states them:

* forward outputs: 1e-4 of each output's scale (fp32 sums in other orders
  through 3 U-Net levels);
* corner labels: exact (min and max of the same coordinates);
* one step: losses 1e-4; each gradient leaf within 1e-3 of its largest |g|
  plus 1e-5; BatchNorm statistics 1e-5;
* ``PointWiseEval``: the confusion matrix exact, the metrics within 1e-12
  (the same integer counts and float64 sums);
* the point-wise ``validate``: mIoU and accuracy exact (the same argmax
  of the same logits within 1e-4), the offset MAE within 1e-5 relative.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from gapro_tpu.data.dataset import VoxelCfg as JaxVoxelCfg
from gapro_tpu.eval import runner as jax_runner
from gapro_tpu.eval.point_wise_eval import PointWiseEval as JaxPointWiseEval
from gapro_tpu.losses import criterion as jax_criterion
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxConfig
from gapro_tpu.models.prepare import prepare_voxel_batch as jax_prepare
from gapro_tpu.models.prepare import upload_point_batch as jax_upload
from gapro_tpu.train.step import _loss_fn as jax_loss_fn
from gapro_tpu_torch import convert
from gapro_tpu_torch.data.dataset import SyntheticDataset, VoxelCfg
from gapro_tpu_torch.eval import runner
from gapro_tpu_torch.eval.point_wise_eval import PointWiseEval
from gapro_tpu_torch.losses import criterion
from gapro_tpu_torch.models import isbnet, prepare
from gapro_tpu_torch.train import state, step
from gapro_tpu_torch.train.config import AttrDict

from tests.test_torch_isbnet import _randomize, _tiny_cfg_kwargs
from tests.test_torch_train import (INST_CAP, LOSS_TOL, N_CAP, _assert_trees_close, _np_tree,
                                    _scene)

KW = dict(_tiny_cfg_kwargs(), semantic_only=True)
HEADS = {"backbone", "semantic_linear", "offset_vertices_linear", "box_conf_linear"}
SMALL = dict(n_objects=3, points_per_object=300, n_floor=400, n_wall=300)


@pytest.fixture(scope="module")
def base():
    scene = _scene()
    pb = prepare.points_to_batch_np([scene], voxel_scale=10, n_cap=N_CAP)
    jprep = jax_prepare(jax.tree_util.tree_map(jnp.asarray, pb), N_CAP, 1, 3, 256, 0.7)
    tprep = prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, device="cpu"), N_CAP, 1,
                                        3, 256, 0.7)
    jmodel = JaxISBNet(JaxConfig(**KW))
    variables = _np_tree(_randomize(
        jax.jit(jmodel.init, static_argnums=(2,))(jax.random.PRNGKey(0), jprep.batch, False),
        seed=1))
    tmodel = isbnet.ISBNet(isbnet.ISBNetConfig(**KW), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    return dict(jprep=jprep, tprep=tprep, jmodel=jmodel, variables=variables, tmodel=tmodel)


def test_semantic_only_model_holds_the_backbone_stage_only(base):
    """The JAX tree of a semantic_only model loads strictly: the port builds
    none of the superpoint heads, aggregators or mask head."""
    assert set(base["variables"]["params"]) == HEADS
    assert {n.split(".")[0] for n, _ in base["tmodel"].named_parameters()} == HEADS
    with pytest.raises(ValueError, match="semantic_only"):
        base["tmodel"].forward_inference(base["tprep"].batch)


def test_semantic_only_forward_matches_jax(base):
    jout = _np_tree(jax.jit(base["jmodel"].apply)(base["variables"], base["jprep"].batch))
    tout = base["tmodel"](base["tprep"].batch)
    assert set(tout) == set(jout) == {"semantic_scores", "corners_offset", "box_conf",
                                      "box_preds", "voxel_feats"}
    for k, want in jout.items():
        got = tout[k].numpy()
        assert got.shape == want.shape, k
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale, err_msg=k)


def test_corner_labels_only_matches_jax(base):
    """With an instance id past the cap, which reads the last instance in
    both packages."""
    jp, tp = base["jprep"], base["tprep"]
    inst = np.asarray(jp.voxel_instance).copy()
    inst[np.flatnonzero(inst >= 0)[:5]] = INST_CAP + 3
    want = jax_criterion.corner_labels_only(jnp.asarray(inst), jp.batch.coords_float,
                                            jp.batch.valid, INST_CAP)
    got = criterion.corner_labels_only(torch.as_tensor(inst), tp.batch.coords_float,
                                       tp.batch.valid, INST_CAP)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 0] > -100).sum() > 0


def test_semantic_only_step_matches_jax(base):
    """Losses, every gradient leaf and the new BatchNorm statistics of one
    step against ``jax.value_and_grad`` of the JAX ``_loss_fn``."""
    jcrit = jax_criterion.CriterionConfig(inst_cap=INST_CAP, semantic_only=True)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bs, pr: jax_loss_fn(p, bs, base["jmodel"], pr, jcrit), has_aux=True))
    v = base["variables"]
    (_, (jlosses, jbs)), jgrads = grad_fn(v["params"], v["batch_stats"], base["jprep"])

    tmodel = isbnet.ISBNet(isbnet.ISBNetConfig(**KW), device="cpu")
    convert.load_flax_variables(tmodel, v)
    crit = criterion.CriterionConfig(inst_cap=INST_CAP, semantic_only=True)
    st, tlosses = step.make_train_step(tmodel, crit)(
        state.create_train_state(tmodel, lr=1e-3), base["tprep"], 1e-3)
    assert st.step == 1
    jlosses = _np_tree(jlosses)
    assert set(tlosses) == set(jlosses) == {"pw_sem_loss", "pw_corners_loss", "pw_giou_loss",
                                            "pw_conf_loss", "loss", "ovf_inst_voxels"}
    for k, want in jlosses.items():
        np.testing.assert_allclose(float(tlosses[k]), want, err_msg=k, **LOSS_TOL)
    _assert_trees_close(convert.to_flax_variables(tmodel, grads=True)["params"],
                        _np_tree(jgrads), "grad", rel=1e-3, atol=1e-5)
    _assert_trees_close(convert.to_flax_variables(tmodel)["batch_stats"], _np_tree(jbs),
                        "batch_stats", rel=1e-5, atol=1e-5)


def test_semantic_only_model_without_the_criterion_flag_raises(base):
    """A semantic_only model under a criterion that is not: the JAX package
    fails in ``build_targets`` for want of ``sp_dense_idx`` (a KeyError);
    the port raises a ValueError that says what to set, at the same
    point."""
    crit = criterion.CriterionConfig(inst_cap=INST_CAP)
    with pytest.raises(ValueError, match="criterion.semantic_only"):
        step._loss_fn(base["tmodel"], base["tprep"], crit)
    jcrit = jax_criterion.CriterionConfig(inst_cap=INST_CAP)
    v = base["variables"]
    with pytest.raises(KeyError, match="sp_dense_idx"):
        jax_loss_fn(v["params"], v["batch_stats"], base["jmodel"], base["jprep"], jcrit)


def test_point_wise_eval_matches_jax():
    rng = np.random.default_rng(3)
    pe, jpe = PointWiseEval(num_classes=19), JaxPointWiseEval(num_classes=19)
    for n in (500, 800):
        gt = rng.integers(0, 19, n)
        gt[rng.random(n) < 0.1] = -100
        pred = np.where(rng.random(n) < 0.6, gt.clip(0), rng.integers(0, 19, n))
        inst = np.where(rng.random(n) < 0.7, rng.integers(0, 6, n), -100)
        corners = rng.normal(size=(n, 6)).astype(np.float32)
        gt_corners = rng.normal(size=(n, 6)).astype(np.float32)
        for e in (pe, jpe):
            e.update(pred, corners, gt, gt_corners, inst)
    np.testing.assert_array_equal(pe.conf, jpe.conf)
    np.testing.assert_allclose(pe.get_eval(), jpe.get_eval(), rtol=1e-12)


def test_point_wise_validate_matches_jax(base):
    """``validate`` of a semantic_only model on 2 synthetic scenes against
    the JAX ``validate``. The JAX function indexes the padded batch's point
    map and fails on any scene shorter than its padding (``ROADMAP.md``
    §3); its prepare function here hands it the scene's own points, which
    the port takes itself."""
    cfg = AttrDict.wrap(dict(model=dict(type="isbnet", semantic_only=True, instance_classes=18),
                             data=dict(type="scannetv2")))
    log = logging.getLogger("test")
    vc = VoxelCfg(scale=10, max_npoint=20000, min_npoint=100)
    ds = SyntheticDataset(n_scenes=2, training=False, voxel_cfg=vc, **SMALL)
    jds = JaxSynthetic(n_scenes=2, training=False,
                       voxel_cfg=JaxVoxelCfg(scale=10, max_npoint=20000, min_npoint=100), **SMALL)

    def jprep(lb):
        n = lb.points.coords.shape[0]
        p = jax_prepare(jax_upload(lb.points), n, 1, 3, 256, 0.7)
        return p._replace(point2voxel=p.point2voxel[:len(lb.scenes[0]["xyz"])])

    want = jax_runner.validate(base["jmodel"], base["variables"], "isbnet", jds, cfg, log,
                               jprep, max_scenes=2)
    got = runner.validate(base["tmodel"], "isbnet", ds, cfg, log, lambda lb: prepare.
                          prepare_voxel_batch(prepare.upload_point_batch(lb.points, "cpu"),
                                              lb.points.coords.shape[0], 1, 3, 256, 0.7),
                          max_scenes=2)
    assert set(got[1]) == set(want[1]) == {"val_miou", "val_acc", "val_offset_mae"}
    assert got[0] == want[0] == want[1]["val_miou"]
    assert got[1]["val_acc"] == want[1]["val_acc"]
    np.testing.assert_allclose(got[1]["val_offset_mae"], want[1]["val_offset_mae"], rtol=1e-5)
