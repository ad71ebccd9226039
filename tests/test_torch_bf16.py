"""The port's bf16 conv mode (``GAPRO_CONV_DTYPE=bf16``) against the JAX
package under the same variable.

JAX reads the variable while it traces, so a test sets it with
``monkeypatch`` and clears JAX's caches: a function traced earlier in the
same worker would keep the mode it was traced in. The port reads it on every
call (``sparse/conv.py:compute_dtype``).

The contract (``sparse/conv.py``): every conv rounds its features and
weights to bf16 and sums the exact products in fp32. A subm conv's backward
is fp32 on a level that has window tables on the TPU (``_window_conv_bwd``
casts dout to the saved fp32 input's type); on another level it is
``jax.grad`` of the XLA gather-GEMM, which adds the table's gradient rows in
bf16 and rounds dW to bf16. Tolerances, each with its reason:

* one conv's forward: rtol = atol = 1e-4, the same exact products summed in
  another order;
* one conv's bf16 gradients: within ``BF16_STEPS`` bf16 rounding steps of
  the output's scale (a gradient row summed in bf16, or a dW entry rounded
  to bf16, lands one step away where an fp32 difference in the order of the
  products flips a rounding), and at least ``SAME_BITS`` of the entries
  equal bit for bit, which an fp32 sum rounded once (the other contract)
  would not give;
* the tiny ISBNet: where an fp32 difference flips a bf16 rounding of a
  conv's input, that operand moves by one bf16 step (2^-8 of itself), and
  the heads' batch-statistics BatchNorms and the backward carry such flips
  on: floats within ``BF16_STEP`` of their scale, gradients within
  ``GRAD_REL`` of each leaf's largest entry, and the port's gradients far
  closer to the JAX package's bf16 ones than the JAX package's own fp32
  gradients are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gapro_tpu.data import make_synthetic_scene, remap_semantic_for_training
from gapro_tpu.losses.criterion import CriterionConfig as JaxCriterionConfig
from gapro_tpu.models import ISBNet as JaxISBNet
from gapro_tpu.models.prepare import points_to_batch_np, prepare_voxel_batch
from gapro_tpu.ops.voxelize import voxelize as jax_voxelize
from gapro_tpu.sparse import conv as jax_conv
from gapro_tpu.sparse.plan import build_unet_plan as jax_build_plan
from gapro_tpu.sparse.tensor import SparseGrid as JaxGrid
from gapro_tpu.sparse import window_conv
from gapro_tpu.sparse.window_conv import build_window_tables, subm_conv_window
from gapro_tpu.train import state as jax_state
from gapro_tpu.train.step import _loss_fn as jax_loss_fn
from gapro_tpu.train.step import make_train_step as jax_make_train_step
from gapro_tpu_torch import convert
from gapro_tpu_torch.losses import criterion
from gapro_tpu_torch.models import isbnet, prepare
from gapro_tpu_torch.sparse import conv as port_conv
from gapro_tpu_torch.sparse.plan import ConvTables, level_capacities, window_level
from gapro_tpu_torch.train import state, step

from tests.test_train_step import _cfg as jax_test_cfg

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_STEP = 2.0 ** -8
BF16_STEPS = 2
SAME_BITS = 0.99
GRAD_REL, GRAD_ATOL = 2.0 ** -4, 1e-5
LOSS_TOL = dict(rtol=BF16_STEP, atol=BF16_STEP)
CAP, EXTENTS = 1024, (24, 32, 32)
INST_CAP = 16


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the Tier-1 run's xdist workers share the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _mode(monkeypatch, bf16: bool):
    if bf16:
        monkeypatch.setenv("GAPRO_CONV_DTYPE", "bf16")
    else:
        monkeypatch.delenv("GAPRO_CONV_DTYPE", raising=False)
    jax.clear_caches()


@pytest.fixture(scope="module")
def level():
    """The 700-voxel grid of capacity 1024 of ``test_torch_conv_bwd.py``, two
    levels of the JAX plan (the second for the down and inverse convs)."""
    rng = np.random.default_rng(3)
    pts = set()
    while len(pts) < 700:
        pts.add((0, rng.integers(0, 24), rng.integers(0, 32), rng.integers(0, 32)))
    coords = np.pad(np.array(sorted(pts), np.int32), ((0, CAP - 700), (0, 0)),
                    constant_values=-1)
    maps = jax_voxelize(jnp.asarray(coords), EXTENTS, CAP, valid=jnp.arange(CAP) < 700)
    grid = JaxGrid(coords=maps.voxel_coords, valid=maps.valid_voxel,
                   num_voxels=maps.num_voxels, spatial_shape=EXTENTS, batch_size=1)
    return jax_build_plan(grid, 2, 0.5).levels


def _inputs(lp, cin, cout):
    rng = np.random.default_rng(cin * 100 + cout)
    valid = np.asarray(lp.grid.valid)
    feats = np.where(valid[:, None], rng.normal(size=(CAP, cin)), 0).astype(np.float32)
    w = rng.normal(size=(27, cin, cout)).astype(np.float32)
    g = rng.normal(size=(CAP, cout)).astype(np.float32)  # unmasked: the backward masks it
    return feats, np.asarray(lp.subm_nbr), w, valid, g


def _port_grads(feats, nbr, w, valid, g, window):
    tf, tw = torch.tensor(feats, requires_grad=True), torch.tensor(w, requires_grad=True)
    tn, tv = torch.tensor(nbr), torch.tensor(valid)
    out = port_conv.SubmConvFn.apply(tf, tw, tn, tv, ConvTables(tn, tv), window)
    (out * torch.tensor(g)).sum().backward()
    return out.detach().numpy(), tf.grad.numpy(), tw.grad.numpy()


def _jax_grads(fn, args, g):
    loss = lambda *a: jnp.sum(fn(*a) * jnp.asarray(g))
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*(jnp.asarray(a) for a in args))
    return [np.asarray(x) for x in grads]


def _assert_bf16_grad(got, want, what):
    """Within BF16_STEPS rounding steps of the scale, most entries bit-equal."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= BF16_STEPS * BF16_STEP * scale, f"{what}: max |err| {err:.3g} of {scale:.3g}"
    same = float((got == want).mean())
    assert same >= SAME_BITS, f"{what}: only {same:.2%} of the entries equal bit for bit"


def test_compute_dtype_follows_the_variable_on_every_call(monkeypatch):
    """``compute_dtype`` and the plain conv follow ``GAPRO_CONV_DTYPE`` as it
    changes, with no import or cache in between; fp32 is the default."""
    rng = np.random.default_rng(0)
    feats = torch.tensor(rng.normal(size=(40, 8)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(27, 8, 4)).astype(np.float32))
    nbr = torch.tensor(rng.integers(-1, 40, size=(40, 27)).astype(np.int32))
    valid = torch.ones(40, dtype=torch.bool)
    outs = {}
    for value, want in ((None, torch.float32), ("bf16", torch.bfloat16), ("fp32", torch.float32),
                        ("bf16", torch.bfloat16), (None, torch.float32)):
        if value is None:
            monkeypatch.delenv("GAPRO_CONV_DTYPE", raising=False)
        else:
            monkeypatch.setenv("GAPRO_CONV_DTYPE", value)
        assert port_conv.compute_dtype() is want
        out = port_conv.subm_conv(feats, nbr, w, valid)
        assert out.dtype is torch.float32
        outs.setdefault(want, out)
        assert torch.equal(out, outs[want])
    assert not torch.equal(outs[torch.float32], outs[torch.bfloat16])
    assert torch.equal(outs[torch.bfloat16], port_conv.subm_conv(
        feats.bfloat16().float(), nbr, w.bfloat16().float(), valid, torch.float32))


def test_window_flag_follows_the_tpu_plan():
    """``LevelPlan.window``'s predicate: at full width (ISBNet's plan shrink)
    levels 0-3 have window tables on the TPU and levels 4-6 do not; a
    capacity that is not a multiple of the level's tile falls back to 256."""
    caps = level_capacities(262144, 7, (0.67, 0.3, 0.25, 0.25, 0.25, 0.25))
    assert caps == [262144, 176128, 52992, 13312, 3328, 1024, 256]
    assert [window_level(lvl, c) for lvl, c in enumerate(caps)] == [True] * 4 + [False] * 3
    assert window_level(1, 8192 + 256) and not window_level(0, 8192 + 128)
    assert not window_level(0, 4096)


@pytest.mark.parametrize("cin,cout", [(6, 32), (16, 8), (32, 32), (64, 64)])
def test_subm_forward_matches_xla(level, monkeypatch, cin, cout):
    """The plain conv and ``SubmConvFn`` (K1-bf16's plain version on the CPU)
    against the XLA ``subm_conv`` in bf16; fp32 mode stays as it was."""
    feats, nbr, w, valid, _ = _inputs(level[0], cin, cout)
    tn, tv = torch.tensor(nbr), torch.tensor(valid)
    for bf16 in (True, False):
        _mode(monkeypatch, bf16)
        want = np.asarray(jax_conv.subm_conv(jnp.asarray(feats), jnp.asarray(nbr),
                                             jnp.asarray(w), jnp.asarray(valid)))
        got = port_conv.subm_conv(torch.tensor(feats), tn, torch.tensor(w), tv).numpy()
        np.testing.assert_allclose(got, want, err_msg=f"bf16={bf16}", **TOL)
        fn = port_conv.SubmConvFn.apply(torch.tensor(feats), torch.tensor(w), tn, tv,
                                        ConvTables(tn, tv), False).numpy()
        np.testing.assert_array_equal(fn, got)
    rounded = np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32))
    assert not np.array_equal(rounded, w)  # the mode changes the weights it multiplies


@pytest.mark.parametrize("cin,cout", [(6, 32), (32, 32), (64, 64)])
def test_subm_forward_matches_window_kernel(level, monkeypatch, cin, cout):
    """The window levels' function (``subm_conv_bf16`` with ``window``, and
    ``SubmConvFn`` there) against ``subm_conv_window``, the TPU kernel K1 in
    interpret mode with its bf16 table, whose one-hot gather rounds each
    tap's sum to bf16. Rows without escapees within 1e-4 of the scale, and
    each entry within one bf16 step of its largest tap where an fp32
    difference flips a tap's rounding. An escapee's tap joins its row
    unrounded (``_escape_correction``); the port rounds every tap, so an
    escapee row lies within half a bf16 step of each of its escapee taps
    (from the bf16 operands, in fp64) of the kernel's, and there the two
    differ."""
    _mode(monkeypatch, True)
    feats, nbr, w, valid, _ = _inputs(level[0], cin, cout)
    # the default window (two tiles) holds every neighbour of this sparse
    # grid; a window of one tile leaves some outside it, the escapees
    tabs = build_window_tables(jnp.asarray(nbr), tile=256, window=256)
    want = np.asarray(subm_conv_window(jnp.asarray(feats), tabs, jnp.asarray(w),
                                       jnp.asarray(valid)))
    tf, tn, tw, tv = (torch.tensor(x) for x in (feats, nbr, w, valid))
    got = port_conv.subm_conv_bf16(tf, tn, tw, tv, window=True).numpy()
    np.testing.assert_array_equal(
        port_conv.SubmConvFn.apply(tf, tw, tn, tv, ConvTables(tn, tv), True).numpy(), got)
    # each tap from the bf16 operands, in fp64
    fb = torch.tensor(feats).bfloat16().double()
    wb = torch.tensor(w).bfloat16().double()
    taps = torch.stack([port_conv.gather_rows(fb, tn[:, k:k + 1])[:, 0] @ wb[k]
                        for k in range(27)], 1).numpy()  # [V, 27, Cout]
    esc, ks = np.asarray(tabs.esc_out), np.asarray(tabs.esc_k)
    live = esc >= 0
    esc_rows = np.unique(esc[live])
    assert len(esc_rows) > 0  # the grid has escapees
    plain = np.setdiff1d(np.arange(CAP), esc_rows)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    assert float((err[plain] <= 1e-4 * scale).mean()) >= SAME_BITS
    np.testing.assert_array_less(err[plain], BF16_STEP * np.abs(taps[plain]).max(1) + 1e-4 * scale)
    bound = np.zeros_like(want, dtype=np.float64)
    np.add.at(bound, esc[live], 0.5 * BF16_STEP * np.abs(taps[esc[live], ks[live]]))
    np.testing.assert_array_less(err[esc_rows], (bound + BF16_STEP * np.abs(taps).max(1)
                                                 + 1e-4 * scale)[esc_rows])
    assert float(err[esc_rows].max()) > 1e-4 * scale  # the escapee taps' rounding shows
    xla = port_conv.subm_conv(tf, tn, tw, tv).numpy()
    assert float(np.abs(xla - want)[plain].max()) > 1e-4 * scale  # the XLA function differs


@pytest.mark.parametrize("cin,cout", [(6, 32), (16, 8), (32, 32)])
def test_window_level_backward_is_fp32(level, monkeypatch, cin, cout):
    """On a window level the bf16 mode's backward is ``_window_conv_bwd``
    (fused, ``GAPRO_WINDOW_FUSED=1``): fp32, within 1e-4 of it, and equal
    bit for bit to the port's own fp32-mode backward."""
    feats, nbr, w, valid, g = _inputs(level[0], cin, cout)
    _mode(monkeypatch, False)
    _, df32, dw32 = _port_grads(feats, nbr, w, valid, g, window=True)
    _mode(monkeypatch, True)
    monkeypatch.setenv("GAPRO_WINDOW_FUSED", "1")
    _, df, dw = _port_grads(feats, nbr, w, valid, g, window=True)
    np.testing.assert_array_equal(df, df32)
    np.testing.assert_array_equal(dw, dw32)
    tabs = build_window_tables(jnp.asarray(nbr))
    jv = jnp.asarray(valid)
    calls = []
    fused = window_conv._pallas_bwd_fused
    monkeypatch.setattr(window_conv, "_pallas_bwd_fused",
                        lambda *a: calls.append(a[0].dtype) or fused(*a))
    want_df, want_dw = _jax_grads(lambda f, ww: subm_conv_window(f, tabs, ww, jv), (feats, w), g)
    assert calls == [jnp.float32]  # the fused kernel K2 ran, on the fp32 table
    np.testing.assert_allclose(df, want_df, err_msg="dfeats", **TOL)
    np.testing.assert_allclose(dw, want_dw, err_msg="dW", **TOL)
    assert want_df.dtype == np.float32 and not np.array_equal(
        want_df, want_df.astype(jnp.bfloat16).astype(np.float32))  # not rounded to bf16


@pytest.mark.parametrize("cin,cout", [(6, 32), (16, 8), (32, 32), (64, 64)])
def test_non_window_backward_matches_jax_grad(level, monkeypatch, cin, cout):
    """On a level without window tables the backward is ``jax.grad`` of the
    XLA ``subm_conv`` in bf16: dfeats summed in bf16, dW rounded to bf16."""
    _mode(monkeypatch, True)
    feats, nbr, w, valid, g = _inputs(level[0], cin, cout)
    _, df, dw = _port_grads(feats, nbr, w, valid, g, window=False)
    jn, jv = jnp.asarray(nbr), jnp.asarray(valid)
    want_df, want_dw = _jax_grads(lambda f, ww: jax_conv.subm_conv(f, jn, ww, jv), (feats, w), g)
    for got, want, what in ((df, want_df, "dfeats"), (dw, want_dw, "dW")):
        assert np.array_equal(want, want.astype(jnp.bfloat16).astype(np.float32)), what
        _assert_bf16_grad(got, want, what)
    _, df32, _ = _port_grads(feats, nbr, w, valid, g, window=True)
    assert float((df32 == want_df).mean()) < 0.5  # the fp32 backward is another function


@pytest.mark.parametrize("cin,cout", [(6, 32), (32, 64)])
def test_down_and_inverse_conv_match_jax(level, monkeypatch, cin, cout):
    """``down_conv`` and ``inverse_conv`` on the plan's rulebook: forward
    within 1e-4, and their gradients (the gathered rows' in bf16, dW rounded
    to bf16) as the subm conv's."""
    _mode(monkeypatch, True)
    fine, coarse = level
    rng = np.random.default_rng(cin + cout)
    feats = np.where(np.asarray(fine.grid.valid)[:, None],
                     rng.normal(size=(CAP, cin)), 0).astype(np.float32)
    vc = coarse.grid.capacity
    cfeats = np.where(np.asarray(coarse.grid.valid)[:, None],
                      rng.normal(size=(vc, cout)), 0).astype(np.float32)
    wd = rng.normal(size=(8, cin, cout)).astype(np.float32)
    wu = rng.normal(size=(8, cout, cin)).astype(np.float32)
    gd = rng.normal(size=(vc, cout)).astype(np.float32)
    gu = rng.normal(size=(CAP, cin)).astype(np.float32)
    child, cvalid = np.asarray(fine.down_child), np.asarray(coarse.grid.valid)
    parent, offset, valid = (np.asarray(fine.parent), np.asarray(fine.offset_id),
                             np.asarray(fine.grid.valid))
    cases = (
        ("down_conv", lambda f, w: jax_conv.down_conv(f, jnp.asarray(child), w,
                                                      jnp.asarray(cvalid)),
         lambda f, w: port_conv.down_conv(f, torch.tensor(child), w, torch.tensor(cvalid)),
         feats, wd, gd),
        ("inverse_conv", lambda f, w: jax_conv.inverse_conv(
            f, jnp.asarray(parent), jnp.asarray(offset), w, jnp.asarray(valid)),
         lambda f, w: port_conv.inverse_conv(f, torch.tensor(parent), torch.tensor(offset), w,
                                             torch.tensor(valid)),
         cfeats, wu, gu))
    for name, jfn, pfn, f, w, g in cases:
        tf, tw = torch.tensor(f, requires_grad=True), torch.tensor(w, requires_grad=True)
        out = pfn(tf, tw)
        (out * torch.tensor(g)).sum().backward()
        want = np.asarray(jfn(jnp.asarray(f), jnp.asarray(w)))
        np.testing.assert_allclose(out.detach().numpy(), want, err_msg=name, **TOL)
        want_df, want_dw = _jax_grads(jfn, (f, w), g)
        _assert_bf16_grad(tf.grad.numpy(), want_df, f"{name} dfeats")
        _assert_bf16_grad(tw.grad.numpy(), want_dw, f"{name} dW")


@pytest.fixture(scope="module")
def tiny():
    """``tests/test_train_step.py``'s bf16 case: its configuration (C = 8, 3
    levels, every voxel foreground) and flax init at PRNGKey(0), on the
    synthetic scene of seed 0 prepared by both packages (semantic labels
    remapped for training, as the port's criterion requires). Every level
    lies below 8192: no window tables, in either package."""
    s = make_synthetic_scene(seed=0, n_objects=3, points_per_object=200, n_floor=300, n_wall=200)
    scene = dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp,
                 semantic=remap_semantic_for_training(s.semantic_label),
                 instance=s.instance_label)
    pb = points_to_batch_np([scene], voxel_scale=10)
    cap = pb.coords.shape[0]
    jprep = prepare_voxel_batch(jax.tree_util.tree_map(jnp.asarray, pb), cap, 1, 3, 256, 0.7)
    tprep = prepare.prepare_voxel_batch(
        prepare.upload_point_batch(prepare.points_to_batch_np([scene], voxel_scale=10),
                                   device="cpu"), cap, 1, 3, 256, 0.7)
    assert not any(lp.window for lp in tprep.batch.plan.levels)
    cfg = jax_test_cfg()
    jmodel = JaxISBNet(cfg)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init, static_argnums=(2,))(jax.random.PRNGKey(0),
                                                               jprep.batch, False))
    kw = {k: v for k, v in cfg.__dict__.items() if k in isbnet.ISBNetConfig.__dataclass_fields__}
    return dict(jprep=jprep, tprep=tprep, jmodel=jmodel, variables=variables, kw=kw)


def _port_model(tiny):
    model = isbnet.ISBNet(isbnet.ISBNetConfig(**tiny["kw"]), device="cpu")
    convert.load_flax_variables(model, tiny["variables"])
    return model


def _leaves(tree, path=()):
    if hasattr(tree, "items"):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    else:
        yield "/".join(path), np.asarray(tree)


def _port_step(tiny):
    model = _port_model(tiny)
    st = state.create_train_state(model, lr=1e-3)
    st, losses = step.make_train_step(model, criterion.CriterionConfig(inst_cap=INST_CAP))(
        st, tiny["tprep"], 1e-3)
    return ({k: float(v) for k, v in losses.items()},
            dict(_leaves(convert.to_flax_variables(model, grads=True)["params"])),
            dict(_leaves(convert.to_flax_variables(model)["batch_stats"])))


def _jax_step(tiny):
    """``make_train_step``'s losses and new statistics, and the gradients
    of the ``_loss_fn`` it differentiates."""
    jmodel, v, jprep = tiny["jmodel"], tiny["variables"], tiny["jprep"]
    crit = JaxCriterionConfig(inst_cap=INST_CAP)
    st, losses = jax_make_train_step(jmodel, crit)(jax_state.create_train_state(v, lr=1e-3),
                                                   jprep, jnp.float32(1e-3))
    grad_fn = jax.jit(jax.grad(lambda p, bs, pr: jax_loss_fn(p, bs, jmodel, pr, crit)[0]))
    grads = grad_fn(v["params"], v["batch_stats"], jprep)
    return ({k: float(x) for k, x in losses.items()}, dict(_leaves(jax.device_get(grads))),
            dict(_leaves(jax.device_get(st.batch_stats))))


def test_tiny_forward_matches_jax_in_bf16(tiny, monkeypatch):
    """``forward_inference`` in bf16: discrete outputs equal, floats within
    one bf16 step of their scale."""
    _mode(monkeypatch, True)
    rounds = (16, 8, 4)
    jmodel = tiny["jmodel"]
    jout = jax.device_get(jax.jit(lambda v, b: jmodel.apply(
        v, b, method=lambda m, x: m.forward_inference(x, rounds)))(tiny["variables"],
                                                                    tiny["jprep"].batch))
    tout = _port_model(tiny).forward_inference(tiny["tprep"].batch, rounds)
    assert set(tout) == set(jout) and int(np.asarray(jout["query_valid"]).sum()) > 0
    for key in sorted(jout):
        want = np.asarray(jout[key])
        got = tout[key].numpy() if isinstance(tout[key], torch.Tensor) else np.asarray(tout[key])
        if want.dtype.kind == "f":
            scale = max(1.0, float(np.abs(want).max()))
            assert float(np.abs(got - want).max()) <= BF16_STEP * scale, key
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_tiny_train_step_matches_jax_in_bf16(tiny, monkeypatch):
    """One step in bf16 against ``make_train_step`` under the same variable:
    the losses, every gradient leaf and the new BatchNorm statistics; the
    port's gradients closer to the JAX package's bf16 ones by far than the
    JAX package's own fp32 gradients are; and ``tests/test_train_step.py``'s
    property, the bf16 loss within 0.3 of the fp32 one, for the port."""
    _mode(monkeypatch, True)
    tl, tg, tbs = _port_step(tiny)
    jl, jg, jbs = _jax_step(tiny)
    _mode(monkeypatch, False)
    tl32 = _port_step(tiny)[0]
    jg32 = _jax_step(tiny)[1]
    assert set(tl) == set(jl)
    for k, want in jl.items():
        np.testing.assert_allclose(tl[k], want, err_msg=k, **LOSS_TOL)
    assert set(tg) == set(jg)
    for k, want in jg.items():
        tol = GRAD_REL * float(np.abs(want).max()) + GRAD_ATOL
        err = float(np.abs(tg[k] - want).max())
        assert err <= tol, f"grad {k}: max |err| {err:.3g} > {tol:.3g}"
    port_off = sum(float(np.square(tg[k] - jg[k]).sum()) for k in jg)
    mode_off = sum(float(np.square(jg32[k] - jg[k]).sum()) for k in jg)
    assert port_off < 0.01 * mode_off, (port_off, mode_off)
    for k, want in jbs.items():
        np.testing.assert_allclose(tbs[k], want, rtol=1e-3, atol=1e-3, err_msg=k)
    assert np.isfinite(tl["loss"]) and abs(tl["loss"] - tl32["loss"]) < 0.3
