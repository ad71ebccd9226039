"""The port's S3DIS slice against the JAX package, on the real-format
fixture room (``tests/fixtures/s3dis_raw``) prepared once per module by
the root ``tools/prepare_s3dis.py``: ``S3DISDataset`` (file list, loads,
the training subsample, ``split_pieces`` and the collated batches, through
the forked loader too), ``forward_inference(x4_split=True)`` on the tiny
configuration with 13 classes, ``get_instances`` with the ceiling and
floor served from the semantics (``sem2ins_classes``), ``S3DISEval``, and
the port's train and test CLIs on the room.

Host-side data and metrics must be equal. Float model outputs agree to
rtol = atol = 1e-4, as ``tests/test_torch_isbnet.py``'s (fp32 sums in
another order); instance records are compared on the same model outputs,
so their masks and labels must be equal and their confidences within
1e-6.
"""

import json
import os
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from gapro_tpu.data import dataset as jax_dataset
from gapro_tpu.eval.s3dis_eval import S3DISEval as JaxS3DISEval
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxConfig
from gapro_tpu.models import inference as jax_inference
from gapro_tpu.models import prepare as jax_prepare
from gapro_tpu.utils.rle import rle_decode as jax_rle_decode
from gapro_tpu.utils.rle import rle_encode as jax_rle_encode
from gapro_tpu_torch import convert
from gapro_tpu_torch.data import augment, dataset
from gapro_tpu_torch.eval import S3DISEval
from gapro_tpu_torch.models import inference as port_inference
from gapro_tpu_torch.models import isbnet as port_isbnet
from gapro_tpu_torch.models import prepare as port_prepare
from gapro_tpu_torch.utils.rle import rle_decode
from tests.test_torch_data import _assert_scenes_equal
from tests.test_torch_isbnet import _randomize, _tiny_cfg_kwargs

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
RAW = osp.join(ROOT, "tests", "fixtures", "s3dis_raw")
TOL = dict(rtol=1e-4, atol=1e-4)
SCALE = 20
ROUNDS = (8, 4)
SPP_CAP = 512
SHRINK = 0.75
TEST_CFG = dict(topk=8, topk_insts=16, npoint_thresh=10, score_thresh=0.0, instance_classes=13,
                label_offset=3, sem2ins_classes=(0, 1))


@pytest.fixture(scope="module")
def s3dis_root(tmp_path_factory):
    out = tmp_path_factory.mktemp("s3dis")
    r = subprocess.run([sys.executable, osp.join(ROOT, "tools", "prepare_s3dis.py"),
                        "--data_dir", RAW, "--out", str(out), "--areas", "5"],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    return str(out)


def _datasets(root, prefix="Area_5", **kw):
    vc = dict(scale=SCALE, max_npoint=20000, min_npoint=50)
    return (dataset.S3DISDataset(root, prefix=prefix, voxel_cfg=dataset.VoxelCfg(**vc), **kw),
            jax_dataset.S3DISDataset(root, prefix=prefix, voxel_cfg=jax_dataset.VoxelCfg(**vc),
                                     **kw))


@pytest.mark.parametrize("prefix", ["Area_5", "Area_1, Area_5", "Area_4"])
def test_file_list_matches_jax(s3dis_root, prefix):
    """A filename prefix inside ``preprocess/``, or a comma-separated list."""
    got, want = _datasets(s3dis_root, prefix, training=False)
    assert got.files == want.files
    assert len(got.files) == (0 if prefix == "Area_4" else 1)


@pytest.mark.parametrize("training", [False, True])
def test_load_matches_jax(s3dis_root, training):
    """A test load keeps the 13 classes as they stand; a training load keeps
    the same 25% subsample (``default_rng(index)``) for each index."""
    got, want = _datasets(s3dis_root, training=training, repeat=2)
    for i in range(len(want)):
        _assert_scenes_equal(got.load(i), want.load(i))
    scene = got.load(0)
    assert set(np.unique(scene["semantic"])) <= {0, 1, 2, 7, 8}
    if training:
        assert 0.15 < len(scene["xyz"]) / 1250 < 0.35


def test_split_pieces_match_jax(s3dis_root):
    got, want = _datasets(s3dis_root, training=False)
    scene = augment.transform_test(got.load(0), SCALE)
    pieces = got.split_pieces(scene)
    for g, w in zip(pieces, want.split_pieces(scene)):
        _assert_scenes_equal(g, w)
    perm = np.concatenate([p["piece_indices"] for p in pieces])
    np.testing.assert_array_equal(np.sort(perm), np.arange(len(scene["xyz"])))


@pytest.mark.parametrize("num_workers", [0, 2])
def test_collated_batches_match_jax(s3dis_root, num_workers):
    """The training batches through the port's loader (serial, and in forked
    workers) equal the JAX loader's serial ones."""
    got_ds, want_ds = _datasets(s3dis_root, training=True, repeat=4)
    got = list(dataset.build_dataloader(got_ds, 2, training=True, seed=3,
                                        num_workers=num_workers))
    want = list(jax_dataset.build_dataloader(want_ds, 2, training=True, seed=3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.scan_ids == w.scan_ids
        for field in w.points._fields:
            np.testing.assert_array_equal(getattr(g.points, field), getattr(w.points, field),
                                          err_msg=field)


@pytest.fixture(scope="module")
def x4_run(s3dis_root):
    """The room's test load split into 4 pieces, through both packages'
    ``forward_inference(x4_split=True)`` with the same weights."""
    ds = dataset.S3DISDataset(s3dis_root, prefix="Area_5", training=False)
    scene = augment.transform_test(ds.load(0), SCALE)
    pieces = ds.split_pieces(scene)
    kw = dict(_tiny_cfg_kwargs(), instance_classes=13, semantic_classes=13, spp_cap=SPP_CAP)

    pb = jax_prepare.points_to_batch_np(pieces, voxel_scale=SCALE)
    cap = pb.coords.shape[0]
    jprep = jax_prepare.prepare_voxel_batch(jax.tree_util.tree_map(jnp.asarray, pb), cap, 4, 3,
                                            SPP_CAP, SHRINK)
    jmodel = JaxISBNet(JaxConfig(**kw))
    variables = _randomize(jax.jit(jmodel.init, static_argnums=(2,))(
        jax.random.PRNGKey(0), jprep.batch, False), seed=2)
    infer = jax.jit(lambda v, b: jmodel.apply(
        v, b, method=lambda m, x: m.forward_inference(x, ROUNDS, x4_split=True)))
    jout = jax.tree_util.tree_map(np.asarray, infer(variables, jprep.batch))

    tprep = port_prepare.prepare_voxel_batch(port_prepare.upload_point_batch(
        port_prepare.points_to_batch_np(pieces, voxel_scale=SCALE), "cpu"), cap, 4, 3, SPP_CAP,
        SHRINK)
    tmodel = port_isbnet.ISBNet(port_isbnet.ISBNetConfig(**kw), device="cpu")
    convert.load_flax_variables(tmodel, variables)
    tout = tmodel.forward_inference(tprep.batch, ROUNDS, x4_split=True)
    return dict(scene=scene, pieces=pieces, jprep=jprep, tprep=tprep, jout=jout, tout=tout)


def test_forward_inference_x4_split_matches_jax(x4_run):
    jout, tout = x4_run["jout"], x4_run["tout"]
    assert set(tout) == set(jout)
    # the heads saw one merged scene: stage 1 draws from all four pieces
    assert jout["agg1_valid"].shape[0] == 1 and int(jout["query_valid"].sum()) > 0
    for key in sorted(jout):
        want = np.asarray(jout[key])
        got = tout[key].cpu().numpy() if isinstance(tout[key], torch.Tensor) else np.asarray(
            tout[key])
        assert got.shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=key, **TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_get_instances_sem2ins_matches_jax(x4_run):
    """The JAX model's outputs through both packages' ``get_instances``:
    the ceiling and floor instances first (conf 1, labels 1 and 2), then
    the NMS instances at ``label_offset`` 3; every mask equal after both
    are put back into the room's point order."""
    r = x4_run
    spp = np.concatenate([p["spp"] for p in r["pieces"]])
    perm = np.concatenate([p["piece_indices"] for p in r["pieces"]])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    n = len(r["scene"]["xyz"])
    want = jax_inference.get_instances(
        "Area_5_office_1", r["jout"], r["jprep"].batch, spp, np.asarray(r["jprep"].point2voxel),
        n, jax_inference.TestConfig(**TEST_CFG))
    tout = {k: torch.as_tensor(np.array(v)) if isinstance(v, np.ndarray) else v
            for k, v in r["jout"].items()}
    got = port_inference.get_instances(
        "Area_5_office_1", tout, r["tprep"].batch, spp, r["tprep"].point2voxel, n,
        port_inference.TestConfig.from_dict(dict(TEST_CFG, x4_split=True)))
    assert len(want) > 2 and len(got) == len(want)
    assert [(g["label_id"], g["conf"]) for g in got[:2]] == [(1, 1.0), (2, 1.0)]
    for g, w in zip(got, want):
        assert g["scan_id"] == w["scan_id"] and g["label_id"] == w["label_id"]
        np.testing.assert_allclose(g["conf"], w["conf"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(rle_decode(g["pred_mask"])[inv],
                                      jax_rle_decode(w["pred_mask"])[inv])


def _eval_inputs(seed):
    """Two rooms of 600 points with ignored points and 13 classes, one of
    them (class 5) with no ground truth but with predictions; the
    predictions overlap each other and carry tied confidences."""
    rng = np.random.default_rng(seed)
    preds, sems, insts = [], [], []
    for room in range(2):
        n = 600
        inst = rng.integers(-1, 14, n)
        sem = np.where(inst >= 0, (inst * 7 + room) % 13, -100)
        sem[sem == 5] = 6
        sem[rng.random(n) < 0.05] = -100
        scene_preds = []
        for k in range(12):
            src = inst == rng.integers(0, 14)
            mask = np.where(rng.random(n) < 0.8, src, rng.random(n) < 0.05)
            label = int(rng.integers(1, 14)) if k % 4 else 6
            scene_preds.append(dict(scan_id=f"room{room}", label_id=label,
                                    conf=float(round(rng.random(), 1)),
                                    pred_mask=jax_rle_encode(mask)))
        preds.append(scene_preds)
        sems.append(sem)
        insts.append(inst)
    return preds, sems, insts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_s3dis_eval_matches_jax(seed):
    preds, sems, insts = _eval_inputs(seed)
    got = S3DISEval().evaluate(preds, sems, insts)
    want = JaxS3DISEval().evaluate(preds, sems, insts)
    assert all(np.isfinite(got)) and 0.0 < got[0] < 1.0
    assert got == want


def test_s3dis_eval_without_predictions_matches_jax():
    """No prediction at all: coverage 0, and precision undefined (NaN) in both."""
    _, sems, insts = _eval_inputs(3)
    got = S3DISEval().evaluate([[], []], sems, insts)
    np.testing.assert_array_equal(got, JaxS3DISEval().evaluate([[], []], sems, insts))
    assert got[0] == 0.0 and np.isnan(got[2])


def _cli(module, *args):
    r = subprocess.run([sys.executable, "-m", f"gapro_tpu_torch.tools.{module}", *args],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


@pytest.fixture(scope="module")
def cli_run(s3dis_root, tmp_path_factory):
    """``configs/isbnet_s3dis.yaml`` at the tiny widths on the fixture room:
    its data, test and criterion sections, with Area_5 as the training split
    too (the fixture holds one room) and a crop the room's 25% subsample
    passes."""
    with open(osp.join(ROOT, "configs", "isbnet_s3dis.yaml")) as f:
        cfg = yaml.safe_load(f)
    with open(osp.join(ROOT, "configs", "tiny_synthetic.yaml")) as f:
        tiny = yaml.safe_load(f)
    cfg["model"] = dict(tiny["model"], instance_classes=13, semantic_classes=13)
    cfg["criterion"]["inst_cap"] = 32
    cfg["data"].update(data_root=s3dis_root, label_type=None, prefix_train="Area_5",
                       repeat=2, plan_shrink=SHRINK,
                       voxel=dict(scale=SCALE, spatial_shape=[128, 512], max_npoint=20000,
                                  min_npoint=50))
    cfg["train"].update(batch_size=2, base_batch_size=2, epochs=1)
    cfg["test"].update(topk=16, npoint_thresh=10, score_thresh=0.0)
    path = str(tmp_path_factory.mktemp("cfg") / "isbnet_s3dis_tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    work = str(tmp_path_factory.mktemp("s3dis_cli") / "run")
    _cli("train", path, "--epochs", "1", "--device", "cpu", "--work_dir", work)
    return path, work


def test_train_cli_on_s3dis(cli_run):
    _, work = cli_run
    lines = [json.loads(x) for x in open(osp.join(work, "metrics.jsonl"))]
    assert [r["epoch"] for r in lines] == [1]
    for k in ("loss", "val_ap", "val_ap50", "val_ap25"):
        assert np.isfinite(lines[0][k]), k
    assert osp.exists(osp.join(work, "best"))


def test_test_cli_x4_on_s3dis(cli_run, tmp_path):
    """The x4 path, with S3DIS's labels and ``S3DISEval`` after AP; the
    exported masks are in the room's point order, ceiling and floor
    first."""
    path, work = cli_run
    out = str(tmp_path / "bench")
    r = _cli("test", path, osp.join(work, "best"), "--device", "cpu", "--out", out)
    ap, s3 = (json.loads(x) for x in r.stdout.strip().splitlines()[-2:])
    assert {"all_ap", "all_ap_50%", "all_ap_25%"} <= set(ap)
    assert set(s3) == {"mcov", "mwcov", "mprec", "mrec"}
    lines = open(osp.join(out, "Area_5_office_1.txt")).read().splitlines()
    assert [ln.split()[1:] for ln in lines[:2]] == [["1", "1.0000"], ["2", "1.0000"]]
    mask = np.loadtxt(osp.join(out, lines[0].split()[0]))
    assert mask.shape == (1250,)
