"""The port's ISBNet inference slice against the JAX package, end to end.

The tiny configuration of ``__graft_entry__.py`` (C = 8, 3 levels, spp_cap
256, every voxel foreground) runs on one synthetic scene through both
packages with the same weights: the flax init with every parameter and
batch statistic redrawn from numpy at O(1/sqrt(fan_in)) scale (the
controller's normal(0.01) init would leave every mask logit near 0 and make
each ``mask > 0`` decision a coin flip). Discrete outputs must be equal;
float outputs agree to rtol = atol = 1e-4, the room fp32 leaves for two
libraries summing the same products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.data import make_synthetic_scene, remap_semantic_for_training
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxConfig
from gapro_tpu.models import inference as jax_inference
from gapro_tpu.models.prepare import points_to_batch_np, prepare_voxel_batch
from gapro_tpu.utils.rle import rle_encode
from gapro_tpu_torch import convert
from gapro_tpu_torch.models import inference as port_inference
from gapro_tpu_torch.models import isbnet as port_isbnet
from gapro_tpu_torch.models import prepare as port_prepare
from gapro_tpu_torch.utils.rle import rle_encode_rows

TOL = dict(rtol=1e-4, atol=1e-4)
ROUNDS = (16, 8, 4)
N_CAP = 2048


def _tiny_cfg_kwargs():
    return dict(channels=8, num_blocks=3, n_sample_pa1=64, n_queries=16, neighbor=8,
                dec_dim=32, mask_dim_out=8, spp_cap=256, filter_bg_thresh=0.0)


def _randomize(variables, seed):
    """Redraw every leaf: kernels uniform with variance 1/fan_in, biases and
    BN means in +-0.1, BN scales and variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        shape = leaf.shape
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in ("bias", "mean"):
            return rng.uniform(-0.1, 0.1, shape).astype(np.float32)
        fan_in = shape[0] if len(shape) == 2 else shape[0] * shape[1]
        b = np.sqrt(3.0 / fan_in)
        return rng.uniform(-b, b, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def slice_run():
    s = make_synthetic_scene(seed=0, n_objects=3, points_per_object=200, n_floor=300, n_wall=200)
    scene = dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
                 semantic=remap_semantic_for_training(s.semantic_label),
                 instance=s.instance_label)
    pb = points_to_batch_np([scene], voxel_scale=10, n_cap=N_CAP)
    jprep = prepare_voxel_batch(jax.tree_util.tree_map(jnp.asarray, pb), N_CAP, 1, 3, 256, 0.7)

    tpb = port_prepare.upload_point_batch(
        port_prepare.points_to_batch_np([scene], voxel_scale=10, n_cap=N_CAP), device="cpu")
    tprep = port_prepare.prepare_voxel_batch(tpb, N_CAP, 1, 3, 256, 0.7)

    jmodel = JaxISBNet(JaxConfig(**_tiny_cfg_kwargs()))
    init = jax.jit(jmodel.init, static_argnums=(2,))
    variables = _randomize(init(jax.random.PRNGKey(0), jprep.batch, False), seed=1)
    infer = jax.jit(lambda v, b: jmodel.apply(v, b, method=lambda m, x: m.forward_inference(x, ROUNDS)))
    jout = jax.tree_util.tree_map(np.asarray, infer(variables, jprep.batch))
    jout_once = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.apply)(variables, jprep.batch))

    tmodel = port_isbnet.ISBNet(port_isbnet.ISBNetConfig(**_tiny_cfg_kwargs()), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    tout = tmodel.forward_inference(tprep.batch, ROUNDS)
    return dict(scene=scene, n_points=len(s.xyz), jprep=jprep, tprep=tprep,
                jout=jout, tout=tout, jout_once=jout_once, tout_once=tmodel(tprep.batch))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("path", ["forward_inference", "forward"])
def test_forward_inference_matches_jax(slice_run, path):
    """``forward_inference`` (iterative sampling) and the one-shot forward
    (the JAX module's ``__call__``), output by output."""
    suffix = "" if path == "forward_inference" else "_once"
    jout, tout = slice_run["jout" + suffix], slice_run["tout" + suffix]
    assert set(tout) == set(jout)
    assert int(jout["agg1_valid"].sum()) > 0 and int(jout["query_valid"].sum()) > 0
    for key in sorted(jout):
        want, got = np.asarray(jout[key]), _np(tout[key])
        assert got.shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_get_instances_matches_jax(slice_run):
    r = slice_run
    point_spp = np.asarray(r["scene"]["spp"])
    cfg_kw = dict(npoint_thresh=10, topk=16, topk_insts=32)
    want = jax_inference.get_instances(
        "scene0000_00", r["jout"], r["jprep"].batch, point_spp,
        np.asarray(r["jprep"].point2voxel), r["n_points"], jax_inference.TestConfig(**cfg_kw))
    got = port_inference.get_instances(
        "scene0000_00", r["tout"], r["tprep"].batch, point_spp,
        r["tprep"].point2voxel, r["n_points"], port_inference.TestConfig(**cfg_kw))
    assert len(want) > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["scan_id"] == w["scan_id"] and g["label_id"] == w["label_id"]
        np.testing.assert_allclose(g["conf"], w["conf"], **TOL)
        assert g["pred_mask"]["length"] == w["pred_mask"]["length"]
        np.testing.assert_array_equal(g["pred_mask"]["counts"], w["pred_mask"]["counts"])


def test_rle_rows_match_jax():
    """Run boundaries found for a batch of masks at once equal the JAX
    package's per-mask encoding, empty and full rows included."""
    rng = np.random.default_rng(4)
    masks = rng.random((6, 257)) > rng.random((6, 1))
    masks[0] = False
    masks[1] = True
    masks[2, 1:-1] = False
    got = rle_encode_rows(torch.as_tensor(masks))
    assert len(got) == len(masks)
    for g, m in zip(got, masks):
        w = rle_encode(m)
        assert g["length"] == w["length"]
        np.testing.assert_array_equal(g["counts"], w["counts"])
    assert rle_encode_rows(torch.zeros((0, 5), dtype=torch.bool)) == []
