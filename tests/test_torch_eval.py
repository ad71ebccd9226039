"""The port's evaluation against the JAX package's: ``ScanNetEval`` on the
same predictions (exact: both are the same numpy arithmetic), and
``validate`` of the tiny synthetic configuration with the same weights
(the same AP: the instances agree as ``tests/test_torch_isbnet.py``
holds them)."""

import logging
import math
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np

from gapro_tpu.data import dataset as jax_dataset
from gapro_tpu.eval import instance_eval as jax_eval
from gapro_tpu.eval import runner as jax_runner
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxConfig
from gapro_tpu.models.prepare import prepare_voxel_batch, upload_point_batch
from gapro_tpu.utils.rle import rle_encode
from gapro_tpu_torch import convert
from gapro_tpu_torch.data import dataset
from gapro_tpu_torch.eval import instance_eval, runner
from gapro_tpu_torch.tools import train as port_train
from gapro_tpu_torch.train.config import load_config

from tests.test_torch_isbnet import _randomize

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))


def _same(got, want, path="result"):
    """Equal dicts of floats, nan where the other has nan."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == want, f"{path}: {got} vs {want}"


def test_scannet_eval_matches_jax():
    """Three scenes; predictions are ground-truth instances with points
    flipped, some with the wrong class, some too small, as RLE or as dense
    masks."""
    rng = np.random.default_rng(0)
    preds, sems, insts = [], [], []
    for _ in range(3):
        n = 4000
        inst = rng.integers(-1, 12, n)
        sem = np.where(inst >= 0, inst % 18, rng.choice([18, -100], n))
        sem[rng.random(n) < 0.03] = 18
        p = []
        for i in range(12):
            m = (inst == i) ^ (rng.random(n) < 0.05)
            label = int(i % 18 + 1) if rng.random() < 0.8 else int(rng.integers(1, 19))
            mask = rle_encode(m) if rng.random() < 0.5 else m.astype(np.int8)
            p.append(dict(label_id=label, conf=float(rng.random()), pred_mask=mask))
        p.append(dict(label_id=3, conf=0.9, pred_mask=np.arange(n) < 50))
        preds.append(p)
        sems.append(sem)
        insts.append(inst)
    got = instance_eval.ScanNetEval().evaluate(preds, sems, insts)
    want = jax_eval.ScanNetEval().evaluate(preds, sems, insts)
    assert 0 < want["all_ap"] < 1
    _same(got, want)


def test_validate_matches_jax():
    cfg = load_config(osp.join(ROOT, "configs", "tiny_synthetic.yaml"))
    kw = dict(n_objects=3, points_per_object=300, n_floor=400, n_wall=300)
    vc = dict(scale=20, max_npoint=2500, min_npoint=100)
    tds = dataset.SyntheticDataset(n_scenes=2, training=False, voxel_cfg=dataset.VoxelCfg(**vc),
                                   **kw)
    jds = jax_dataset.SyntheticDataset(n_scenes=2, training=False,
                                       voxel_cfg=jax_dataset.VoxelCfg(**vc), **kw)
    mk = port_train._model_kwargs(cfg)
    jmodel = JaxISBNet(JaxConfig(**mk))
    shrink = port_train.read_plan_shrink(cfg.data)

    def jprepare(lb):
        pb = upload_point_batch(lb.points)
        return prepare_voxel_batch(pb, pb.coords.shape[0], 1, mk["num_blocks"], mk["spp_cap"],
                                   shrink)

    probe = next(iter(jax_dataset.build_dataloader(jds, 1, training=False)))
    variables = jax.tree_util.tree_map(np.asarray, _randomize(
        jax.jit(jmodel.init, static_argnums=(2,))(jax.random.PRNGKey(0),
                                                  jprepare(probe).batch, False), seed=1))
    log = logging.getLogger("test_torch_eval")
    want = jax_runner.validate(jmodel, jax.tree_util.tree_map(jnp.asarray, variables), "isbnet",
                               jds, cfg, log, jprepare)

    tmodel, _ = port_train.build_model(cfg, "cpu")
    convert.load_flax_variables(tmodel, variables)
    prepare = port_train.make_prepare(cfg, "cpu")
    got = runner.validate(tmodel, "isbnet", tds, cfg, log, lambda lb: prepare(lb.points, 1))
    assert want[1]["val_ap25"] > 0
    _same(got, want)
