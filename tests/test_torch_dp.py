"""The port's data-parallel training against the JAX package.

* ``pack_point_batch_np`` / ``unpack_point_batch``: the [N, 17] buffer and
  every field it carries bit-equal to the JAX package's;
* ``parallel/mesh.py``: the no-op ``initialize_multihost``, and at 1 and 2
  gloo ranks on the CPU ``process_allgather``, ``replicate``,
  ``shard_batch`` and the group's sum;
* ``make_dp_train_step`` on 2 gloo ranks on the CPU against JAX's
  ``make_dp_train_step`` on a 2-device CPU mesh, from the same weights
  (the redrawn tiny configuration of ``tests/test_torch_train.py``) on two
  synthetic scenes packed as the train CLI packs them, with the reduction
  weights [1, 1] and [1, 0] (scene 1 a filler). Tolerances:

  - losses and BatchNorm statistics: ``tests/test_torch_batch.py``'s,
    losses 1e-4 relative and absolute, statistics 1e-5 of their scale
    plus 1e-5;
  - the reduced gradients, read from each parameter's ``.grad`` after the
    group's sum, against the weighted mean of JAX's per-scene
    ``value_and_grad(_loss_fn)``: each leaf within 1e-3 of its largest
    |g| plus 1e-5 (``tests/test_torch_train.py``'s gradient tolerance).
    A bias right before a batch-statistics BatchNorm has an exact gradient
    of 0, and both packages hold only rounding noise there; on scene 1 the
    JAX package's own reaches 2.7e-5 (``offset_vertices_linear``), past the
    1e-5 that the comparison assumes of noise. Such a leaf (one whose JAX
    gradient lies within 1e-6 of the model's largest |g|) is held to its
    exact value, 0, as the JAX package holds it: its largest |g| at most
    twice the JAX package's, plus 1e-5;
  - the parameters after the update against the JAX step's: within that
    tolerance of the parameter, plus 2 lr where the JAX gradient lies
    within it of zero (Adam's first step moves a parameter by lr times
    the gradient's sign, which noise may flip there);
  - both ranks' parameters equal bit for bit;

* ``tools/train.py --dp 2`` on the CPU for one synthetic epoch: the loader
  batch and the scaled learning rate as the JAX CLI computes them.
"""

import json
import os.path as osp
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gapro_tpu.data import make_synthetic_scene, remap_semantic_for_training
from gapro_tpu.losses import criterion as jax_criterion
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models import ISBNetConfig as JaxConfig
from gapro_tpu.models import prepare as jax_prepare
from gapro_tpu.train import state as jax_state
from gapro_tpu.train.step import _loss_fn as jax_loss_fn
from gapro_tpu.train.step import make_dp_train_step as jax_dp_step
from gapro_tpu_torch import convert
from gapro_tpu_torch.models import isbnet, prepare
from gapro_tpu_torch.parallel import mesh
from gapro_tpu_torch.tools import train as port_train

from tests.test_torch_dp_card import dp_rank, mesh_rank
from tests.test_torch_isbnet import _randomize, _tiny_cfg_kwargs
from tests.test_torch_train import INST_CAP, LOSS_TOL, _assert_trees_close, _leaves, _np_tree

N_CAP = 2048
LEVELS, SPP_CAP, SHRINK = 3, 256, 0.7
LR = 1e-3
WEIGHTS = ([1.0, 1.0], [1.0, 0.0])
GRAD_REL, GRAD_ATOL = 1e-3, 1e-5
ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TINY = osp.join(ROOT, "configs", "tiny_synthetic.yaml")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """The port's CPU work here on two threads: the test workers share the
    machine's cores, and torch's default of one thread a core each
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


def test_pack_point_batch_matches_jax():
    """The packed buffer and the unpacked fields equal the JAX package's bit
    for bit, padding and the -100 sentinels included."""
    scenes = [_scene(0), _scene(1)]
    jbuf = jax_prepare.pack_point_batch_np(jax_prepare.points_to_batch_np(scenes, 10, 8192))
    tbuf = prepare.pack_point_batch_np(prepare.points_to_batch_np(scenes, 10, 8192))
    assert tbuf.dtype == np.float32 and tbuf.shape == (8192, 17)
    np.testing.assert_array_equal(tbuf, jbuf)
    want = jax_prepare.unpack_point_batch(jnp.asarray(jbuf))
    got = prepare.unpack_point_batch(torch.from_numpy(tbuf))
    for name, g, w in zip(prepare.PointBatch._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_initialize_multihost_without_env_is_a_noop(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert mesh.initialize_multihost(device="cpu") is None
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("world", [1, 2])
def test_mesh_helpers_on_gloo_ranks(world):
    """``replicate`` sets every rank to rank 0's weights, the sum and the
    gather see every rank, ``shard_batch`` hands each rank its own row; the
    CPU takes gloo; ``spawn_ranks`` starts the ranks. Without a group,
    ``process_allgather`` adds the rank axis to the one process's tree."""
    got = mesh.spawn_ranks(mesh_rank, world, world, timeout_s=300)
    for rank, r in got.items():
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        np.testing.assert_array_equal(r["weight"], np.ones((2, 3), np.float32))
        assert r["sum"] == world * (world + 1) / 2
        np.testing.assert_array_equal(r["gathered"]["r"], np.arange(world))
        np.testing.assert_array_equal(r["gathered"]["a"],
                                      np.arange(3)[None] * np.arange(1, world + 1)[:, None])
        np.testing.assert_array_equal(r["own"], [2 * rank, 2 * rank + 1])
    alone = mesh.process_allgather({"ap": np.float32(0.5), "n": [np.arange(4)]})
    assert alone["ap"].shape == (1,) and alone["n"][0].shape == (1, 4)


@pytest.fixture(scope="module")
def dp_runs():
    """Both packages' DP steps and JAX's per-scene gradients. The port's
    ranks take the packed buffers through the CLI's ``prepare_fn``; the
    JAX step takes the same scenes prepared by the JAX package (one
    compile of the step, without the prepare inside it)."""
    scenes = [_scene(0), _scene(1)]
    bufs = [jax_prepare.pack_point_batch_np(jax_prepare.points_to_batch_np([s], 10, N_CAP))
            for s in scenes]
    jpreps = [jax_prepare.prepare_voxel_batch(jax_prepare.unpack_point_batch(jnp.asarray(b)),
                                              N_CAP, 1, LEVELS, SPP_CAP, SHRINK) for b in bufs]
    tiny = isbnet.ISBNet(isbnet.ISBNetConfig(**_tiny_cfg_kwargs()), device="cpu")
    variables = _np_tree(_randomize(convert.to_flax_variables(tiny), seed=1))
    with ThreadPoolExecutor(1) as pool:  # the ranks run beside the JAX steps
        ranks = pool.submit(mesh.spawn_ranks, dp_rank, 2, _tiny_cfg_kwargs(), INST_CAP,
                            (LEVELS, SPP_CAP, SHRINK), LR, variables, bufs, WEIGHTS,
                            timeout_s=300)
        jmodel = JaxISBNet(JaxConfig(**_tiny_cfg_kwargs()))
        jcrit = jax_criterion.CriterionConfig(inst_cap=INST_CAP)
        grad_fn = jax.jit(jax.value_and_grad(
            lambda p, bs, pr: jax_loss_fn(p, bs, jmodel, pr, jcrit), has_aux=True))
        per_scene = [_np_tree(grad_fn(variables["params"], variables["batch_stats"], pr)[1])
                     for pr in jpreps]
        two = Mesh(np.array(jax.devices()[:2]), ("dp",))
        jstep = jax_dp_step(jmodel, jcrit, two)
        stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jpreps)
        # one state, copied for each run: a state made anew carries a new
        # optimizer, a new static field, and the step would compile again
        st0 = jax_state.create_train_state(variables, lr=LR)
        jax_runs = []
        for w in WEIGHTS:
            st = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), st0)
            st, losses = jstep(st, stacked, jnp.float32(LR), jnp.asarray(w, jnp.float32))
            jax_runs.append(dict(losses=_np_tree(losses), params=_np_tree(st.params),
                                 batch_stats=_np_tree(st.batch_stats)))
        ranks = ranks.result()
    return dict(per_scene=per_scene, jax=jax_runs, ranks=ranks)


def _weighted(trees, w):
    """``sum(w * x) / max(sum(w), 1e-6)`` leaf by leaf, as both steps reduce."""
    return jax.tree_util.tree_map(
        lambda *xs: sum(wi * x for wi, x in zip(w, xs)) / max(sum(w), 1e-6), *trees)


def _assert_grads_close(got, want, what) -> dict:
    """Each leaf within GRAD_REL of its largest |g| plus GRAD_ATOL; a leaf
    whose exact gradient is 0 (see the module's note) held to 0 as the JAX
    package holds it. Returns each leaf's tolerance."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w), f"{what}: leaves differ: {sorted(set(g) ^ set(w))}"
    top = max(float(np.abs(x).max()) for x in w.values())
    tols = {}
    for k in w:
        scale = float(np.abs(w[k]).max())
        if scale <= 1e-6 * top:
            err, tols[k] = float(np.abs(g[k]).max()), 2 * scale + GRAD_ATOL
        else:
            err, tols[k] = float(np.abs(g[k] - w[k]).max()), GRAD_REL * scale + GRAD_ATOL
        assert err <= tols[k], f"{what} {k}: max |err| {err:.3g} > {tols[k]:.3g}"
    return tols


@pytest.mark.parametrize("which", [0, 1], ids=["weights_1_1", "weights_1_0"])
def test_dp_step_matches_jax(dp_runs, which):
    """Losses, reduced gradients, BatchNorm statistics and the updated
    parameters of the port's 2-rank step against JAX's 2-device step."""
    w = WEIGHTS[which]
    want, got = dp_runs["jax"][which], dp_runs["ranks"][0][which]
    assert set(got["losses"]) == set(want["losses"])
    for k, v in want["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, err_msg=k, **LOSS_TOL)
    wgrads = _weighted(dp_runs["per_scene"], w)
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
    for a, b in zip(_leaves(got["params"]), _leaves(dp_runs["ranks"][1][which]["params"])):
        np.testing.assert_array_equal(a[1], b[1], err_msg=f"rank 1 {a[0]}")


def test_dp_filler_scene_is_left_out(dp_runs):
    """With weights [1, 0] the reduction is scene 0's own step: the reduced
    gradients are JAX's scene-0 gradients, whatever scene 1 holds."""
    _assert_grads_close(dp_runs["ranks"][0][1]["grads"], dp_runs["per_scene"][0], "scene-0 grad")


def test_train_cli_dp_loader_batch_and_lr(tmp_path):
    """``--dp 2 --batch_size 4`` on the CPU: the JAX CLI's rule makes the
    loader batch 2 (one scene a rank) and scales the learning rate by the
    world batch 2 over ``base_batch_size``, not by the config's 4; one
    epoch of 4 scenes is 2 steps, and rank 0 writes the metrics and the
    checkpoint."""
    work = str(tmp_path / "dp")
    port_train.main([TINY, "--dp", "2", "--batch_size", "4", "--synthetic", "4", "--epochs",
                     "1", "--skip_validate", "--device", "cpu", "--work_dir", work])
    cfg = port_train.load_config(TINY)
    dp, base = 2, cfg.train.get("base_batch_size", 16)
    loader_batch = dp  # tools/train.py: one scene per device when dp > 1
    lr = cfg.train.lr * loader_batch / base
    rec = [json.loads(x) for x in open(osp.join(work, "metrics.jsonl"))]
    assert [r["epoch"] for r in rec] == [1] and rec[0]["lr"] == pytest.approx(lr, rel=1e-12)
    ck = torch.load(osp.join(work, "latest"), map_location="cpu", weights_only=False)
    assert ck["step"] == 4 // loader_batch
    log = open(osp.join(work, "train.log")).read()
    assert "loader batch 4 -> 2" in log and "data-parallel over 2 ranks (gloo)" in log
