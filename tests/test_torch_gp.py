"""The port's GP package (``gapro_tpu_torch/gp/``) against the JAX package.

The same numpy inputs, made from a seed, go through both. Tolerances:

* the ELBO's pieces (``rbf_scaled``, ``_kl``, ``_expected_log_probit``,
  ``elbo``) at rtol 1e-5: one evaluation in fp32, summed in another order;
* ``cholesky_mm`` and ``tri_inv_mm``, values and gradients, at the bounds of
  ``tests/test_gp_linalg.py`` (residual 5e-6, against fp64 5e-5; the
  inverse's gradient rtol 2e-3 atol 2e-4; the Cholesky's rtol 1e-4
  atol 1e-6);
* one Adam step against optax at 1e-5;
* whole fits after 50 Adam steps at ``tests/test_parity_gp.py``'s
  cross-implementation bounds, mu and var atol 0.05 rtol 0.05, probs atol
  0.015: 50 fp32 steps amplify rounding (that file measures the oracle
  against itself in fp64 drifting to |dmu| 0.025), so two implementations
  are not closer than that;
* padding invariance at that file's padded bound (mu 5e-3, probs 2e-3);
* the ensemble at the probs bound, and on a heavy-overlap problem, where
  the JAX ensemble alone moves by more than that when its features move
  one ulp, within ``chip_smoke.NOISE_FACTOR`` times that measured spread.

The port's fits run on one CPU thread here (``one_cpu_thread``).
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import gapro_tpu.gp.linalg as jlin
import gapro_tpu.gp.variational as jv
from gapro_tpu.gp import fit_gp_ensemble as j_ensemble
from gapro_tpu.gp import fit_logreg_batch as j_logreg
from gapro_tpu_torch.gp import fit_gp_ensemble, fit_logreg_batch
import gapro_tpu_torch.gp.linalg as tlin
import gapro_tpu_torch.gp.variational as tv

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_parity_gp import CASES, _problem  # noqa: E402

PIECE_RTOL = 1e-5
FIT_TOL = dict(atol=0.05, rtol=0.05)
PROBS_ATOL = 0.015


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """The port's fits on one CPU thread: PyTorch's CPU reductions split
    their sums by the thread team, whose size changes with the machine's
    load, and 50 Adam steps amplify the changed rounding to the size of the
    bound."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _random_params(rng, t=40, m=16, d=6):
    """A problem with masked rows and parameters moved off their start."""
    x = rng.normal(size=(t, d)).astype(np.float32)
    y = np.where(rng.random(t) < 0.5, -1.0, 1.0).astype(np.float32)
    mask = np.arange(t) < t - 7
    ind = (x[:m] + 0.1 * rng.normal(size=(m, d))).astype(np.float32)
    chol = (np.eye(m) + 0.2 * np.tril(rng.normal(size=(m, m)))).astype(np.float32)
    leaves = [ind, (0.5 * rng.normal(size=m)).astype(np.float32), chol,
              np.float32(0.3), np.float32(-0.2), np.float32(0.1)]
    return x, y, mask, leaves


@pytest.mark.parametrize("seed", [0, 1])
def test_elbo_pieces_match_jax(seed):
    x, y, mask, leaves = _random_params(np.random.default_rng(seed))
    m = len(leaves[1])
    zm = mask[:m].copy()
    zm[3] = False  # a masked inducing row in the middle
    jp = jv.GPParams(*(jnp.asarray(v) for v in leaves))
    tp = tv.GPParams(*(_t(v) for v in leaves))

    got = tv.rbf_scaled(_t(x), _t(x[:9]), _t(np.float32(0.7)), _t(np.float32(1.3)))
    want = jv.rbf_scaled(jnp.asarray(x), jnp.asarray(x[:9]), 0.7, 1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PIECE_RTOL, atol=1e-7)
    np.testing.assert_allclose(tv._kl(tp, _t(zm)).numpy(), np.asarray(jv._kl(jp, jnp.asarray(zm))),
                               rtol=PIECE_RTOL)
    mean = np.linspace(-3, 3, len(x)).astype(np.float32)
    var = np.linspace(0.01, 4, len(x)).astype(np.float32)
    np.testing.assert_allclose(
        tv._expected_log_probit(_t(mean), _t(var), _t(y)).numpy(),
        np.asarray(jv._expected_log_probit(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(y))),
        rtol=PIECE_RTOL)
    want = float(jv.elbo(jp, jnp.asarray(zm), jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    got = tv.elbo(tp, _t(zm), _t(x), _t(y), _t(mask))
    np.testing.assert_allclose(float(got), want, rtol=PIECE_RTOL)
    # batched: two lanes, the second the first with everything masked out
    tb = tv.GPParams(*(torch.stack([v, v]) for v in tp))
    got = tv.elbo(tb, torch.stack([_t(zm), _t(zm) & False]), torch.stack([_t(x)] * 2),
                  torch.stack([_t(y)] * 2), torch.stack([_t(mask), _t(mask) & False]))
    np.testing.assert_allclose(float(got[0]), want, rtol=PIECE_RTOL)
    assert torch.isfinite(got[1])


def _spd(rng, n, shift):
    a = rng.standard_normal((n, n)).astype(np.float32)
    return a @ a.T / n + shift * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [3, 8, 16, 64, 90, 128])
def test_tri_inv_mm_and_cholesky_values(n):
    rng = np.random.default_rng(0)
    k = np.stack([_spd(rng, n, 0.1) for _ in range(3)])
    low = tlin.cholesky_mm(_t(k))
    np.testing.assert_allclose(low.numpy(), np.linalg.cholesky(k), rtol=1e-4, atol=1e-5)
    low = np.linalg.cholesky(k).astype(np.float32)
    inv = tlin.tri_inv_mm(_t(low)).numpy()
    assert np.allclose(inv * (np.arange(n)[None, :] > np.arange(n)[:, None]), 0.0)
    assert np.max(np.abs(inv @ low - np.eye(n, dtype=np.float32))) < 5e-6
    assert np.max(np.abs(inv - np.linalg.inv(low.astype(np.float64)))) < 5e-5


def test_tri_inv_mm_grad_matches_jax():
    rng = np.random.default_rng(1)
    n, q = 32, 12
    low = np.linalg.cholesky(_spd(rng, n, 0.1)).astype(np.float32)
    b = rng.standard_normal((n, q)).astype(np.float32)
    want = jax.grad(lambda l: jnp.sum(jnp.tanh(jlin.tri_inv_mm(l) @ jnp.asarray(b))))(
        jnp.asarray(low))
    lt = _t(low).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(torch.tanh(tlin.tri_inv_mm(lt) @ _t(b))), lt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-4)


def test_cholesky_mm_grad_matches_jax():
    rng = np.random.default_rng(2)
    n = 24
    k = _spd(rng, n, 0.5)
    c = rng.standard_normal((n, n)).astype(np.float32)
    want = jax.grad(lambda kk: jnp.sum(jnp.tanh(jlin.cholesky_mm(kk) * 0.3) * c))(jnp.asarray(k))
    kt = _t(k).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(torch.tanh(tlin.cholesky_mm(kt) * 0.3) * _t(c)), kt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_adam_step_matches_optax():
    """Three steps of the port's optax-form Adam (and AdamW) on the same
    gradients as optax's."""
    rng = np.random.default_rng(3)
    p0 = [rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=(7,)).astype(np.float32)]
    gs = [[rng.normal(size=a.shape).astype(np.float32) * 10.0 ** -i for a in p0]
          for i in range(3)]
    for wd, opt in ((0.0, optax.adam(0.1)), (0.01, optax.adamw(0.1, weight_decay=0.01))):
        jp = [jnp.asarray(a) for a in p0]
        state = opt.init(jp)
        leaves = [_t(a.copy()) for a in p0]
        mus = [torch.zeros_like(a) for a in leaves]
        nus = [torch.zeros_like(a) for a in leaves]
        for count, g in enumerate(gs, start=1):
            upd, state = opt.update([jnp.asarray(a) for a in g], state, jp)
            jp = optax.apply_updates(jp, upd)
            tv.adam_step(leaves, [_t(a) for a in g], mus, nus, count, 0.1, weight_decay=wd)
            for a, b in zip(leaves, jp):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def batch_fits():
    """The six cases of ``tests/test_parity_gp.py`` as lanes of one padded
    batch, through both packages' batched fits."""
    args = chip_smoke.parity_batch()
    want = jv.fit_gp_batch(*(jnp.asarray(a) for a in args), 50, 0.1, None)
    got = tv.fit_gp_batch(*(_t(a) for a in args), 50, 0.1, None)
    return args, want, got


@pytest.mark.parametrize("lane", range(len(CASES)), ids=[f"case{c['seed']}" for c in CASES])
def test_fit_gp_batch_matches_jax(batch_fits, lane):
    args, want, got = batch_fits
    q = args[4][lane]
    for f in ("mu", "var"):
        np.testing.assert_allclose(getattr(got, f)[lane].numpy()[q],
                                   np.asarray(getattr(want, f))[lane][q], **FIT_TOL)
    np.testing.assert_allclose(got.probs[lane].numpy()[q], np.asarray(want.probs)[lane][q],
                               atol=PROBS_ATOL)
    assert torch.equal(got.labels[lane], got.probs[lane] >= 0.5)


def test_chip_smoke_parity_cases(batch_fits):
    """``chip_smoke.py``'s copy of ``tests/test_parity_gp.py``'s problems
    (it cannot import that file, which imports JAX) is the same, and its
    CPU side of gate (a) is the port's fit above, bit for bit."""
    assert chip_smoke.PARITY_CASES == CASES
    for c in CASES:
        for a, b in zip(chip_smoke.parity_problem(**c), _problem(**c)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    args, _, got = batch_fits
    for lane, fit in enumerate(chip_smoke.parity_fits("cpu")):
        q = args[4][lane]
        for k, f in enumerate(("probs", "probs_new", "labels", "mu", "var")):
            assert np.array_equal(fit[k], getattr(got, f)[lane].numpy()[q])


def test_fit_gp_padding_invariance():
    """A problem padded with garbage rows (masked) against the same problem
    without padding, both through the port."""
    tx, ty, qx = _problem(seed=7, n1=20, n2=30, q=10)
    t, q = len(tx), len(qx)
    a = tv.fit_gp(_t(tx), _t(ty), torch.ones(t, dtype=torch.bool), _t(qx),
                  torch.ones(q, dtype=torch.bool))
    txp = np.concatenate([tx, np.full((14, tx.shape[1]), 99.0, np.float32)])
    typ = np.concatenate([ty, np.zeros(14, np.float32)])
    qxp = np.concatenate([qx, np.full((6, qx.shape[1]), -99.0, np.float32)])
    b = tv.fit_gp(_t(txp), _t(typ), _t(np.arange(len(txp)) < t), _t(qxp),
                  _t(np.arange(len(qxp)) < q))
    np.testing.assert_allclose(b.mu[:q].numpy(), a.mu.numpy(), atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(b.probs[:q].numpy(), a.probs.numpy(), atol=2e-3)
    assert torch.all(b.mu[q:] == 0) and torch.all(b.var[q:] == 1)


def test_all_padded_lane_is_finite():
    """A lane with every mask false (the labeler pads a group's lanes to a
    bucket) gives finite outputs and no NaN gradient, and leaves the real
    lane as it is alone."""
    tx, ty, qx = _problem(seed=8, n1=10, n2=12, q=6)
    t, q = len(tx), len(qx)
    txb = np.stack([tx, np.zeros_like(tx)])
    tyb = np.stack([ty, np.ones_like(ty)])
    tmb = np.stack([np.ones(t, bool), np.zeros(t, bool)])
    qxb = np.stack([qx, np.zeros_like(qx)])
    qmb = np.stack([np.ones(q, bool), np.zeros(q, bool)])
    params = tv.init_params(_t(txb))
    leaves = [p.requires_grad_(True) for p in params]
    loss = -tv.elbo(tv.GPParams(*leaves), _t(tmb), _t(txb), _t(tyb), _t(tmb)).sum()
    for g in torch.autograd.grad(loss, leaves):
        assert torch.isfinite(g).all()
    res = tv.fit_gp_batch(_t(txb), _t(tyb), _t(tmb), _t(qxb), _t(qmb))
    for f in res:
        assert torch.isfinite(f.float()).all()
    one = tv.fit_gp(_t(tx), _t(ty), torch.ones(t, dtype=torch.bool), _t(qx),
                    torch.ones(q, dtype=torch.bool))
    np.testing.assert_allclose(res.mu[0].numpy(), one.mu.numpy(), atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(res.probs[0].numpy(), one.probs.numpy(), atol=2e-3)


def test_fit_logreg_batch_matches_jax():
    """Logistic regression under AdamW: not chaotic like the GP's ELBO, so
    held at 1e-4 after 50 steps."""
    rng = np.random.default_rng(4)
    b, t, q, d = 3, 48, 20, 6
    tx = rng.normal(size=(b, t, d)).astype(np.float32)
    ty = np.where(tx[..., 0] + 0.3 * rng.normal(size=(b, t)) > 0, 1.0, -1.0).astype(np.float32)
    tm = rng.random((b, t)) > 0.1
    qx = rng.normal(size=(b, q, d)).astype(np.float32)
    qm = rng.random((b, q)) > 0.2
    want = j_logreg(*(jnp.asarray(a) for a in (tx, ty, tm, qx, qm)))
    got = fit_logreg_batch(*(_t(a) for a in (tx, ty, tm, qx, qm)))
    for f in ("probs", "probs_new", "mu", "var"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-4)
    assert np.array_equal(got.labels.numpy(), np.asarray(want.labels))


def test_fit_gp_ensemble_matches_jax():
    """Two channel blocks as lanes of one batched fit, with nearest-point
    subsampling and superpoint pooling, against the JAX ensemble on the
    geometry of ``tests/test_gp.py``'s ensemble test (two blobs 1.5 apart,
    4 points a superpoint), at the fit bounds above; labels equal where
    the JAX side is confident (|p - 0.5| > 0.1)."""
    rng = np.random.default_rng(1)
    n = 300
    b1 = rng.normal(0.0, 0.2, (n, 3))
    b2 = rng.normal(0.0, 0.2, (n, 3)) + np.array([1.5, 0, 0])
    qq = np.concatenate([b1[:12], b2[:12], rng.normal(0.0, 0.4, (12, 3)) + [0.75, 0, 0]]) + 0.02
    xyz = np.concatenate([b1, b2, qq]).astype(np.float32)
    feats = np.concatenate([xyz, xyz * 0.5 + rng.normal(0, 0.2, xyz.shape)], 1).astype(np.float32)
    spp = np.arange(len(xyz)) // 4
    args = (xyz, feats, spp, np.arange(n), np.arange(n, 2 * n), np.arange(2 * n, 2 * n + 36),
            [0, 3, 6])
    pj, lj, vj = j_ensemble(*args, training_iter=50, npoint_nearest=64)
    pt, lt, vt = fit_gp_ensemble(*args, training_iter=50, npoint_nearest=64, device="cpu")
    np.testing.assert_allclose(pt, pj, atol=PROBS_ATOL)
    np.testing.assert_allclose(vt, vj, atol=PROBS_ATOL)
    sure = np.abs(pj - 0.5) > 0.1
    assert np.array_equal(lt[sure], lj[sure])


def _heavy_overlap():
    """Two blobs of sigma 0.3 whose centres are 0.6 apart, 36 queries
    between them, two channel blocks, 4 points a superpoint."""
    rng = np.random.default_rng(1)
    n = 300
    b1 = rng.normal(0.0, 0.3, (n, 3))
    b2 = rng.normal(0.0, 0.3, (n, 3)) + np.array([0.6, 0, 0])
    qq = rng.normal(0.0, 0.4, (36, 3)) + [0.3, 0, 0]
    xyz = np.concatenate([b1, b2, qq]).astype(np.float32)
    feats = np.concatenate([xyz, xyz * 0.5 + rng.normal(0, 0.2, xyz.shape)], 1).astype(np.float32)
    return (xyz, feats, np.arange(len(xyz)) // 4, np.arange(n), np.arange(n, 2 * n),
            np.arange(2 * n, 2 * n + 36), [0, 3, 6])


def test_fit_gp_ensemble_heavy_overlap_within_jax_spread():
    """Where the blobs overlap heavily, 50 fp32 steps move the JAX
    ensemble's own vote and variance by more than PROBS_ATOL when its
    features move one ulp. The bound is NOISE_FACTOR (chip_smoke.py) times
    that spread, measured here on the JAX package alone (features one ulp
    up and one down); the port against JAX must be within it, and the
    labels equal where the JAX side is confident (|p - 0.5| > 0.1)."""
    args = _heavy_overlap()
    kw = dict(training_iter=50, npoint_nearest=64)
    pj, lj, vj = j_ensemble(*args, **kw)
    spread = 0.0
    for to in (np.inf, -np.inf):
        feats = np.nextafter(args[1], np.float32(to)).astype(np.float32)
        pu, _, vu = j_ensemble(args[0], feats, *args[2:], **kw)
        spread = max(spread, np.abs(pu - pj).max(), np.abs(vu - vj).max())
    pt, lt, vt = fit_gp_ensemble(*args, **kw, device="cpu")
    gap = max(np.abs(pt - pj).max(), np.abs(vt - vj).max())
    print(f"heavy-overlap ensemble: JAX one-ulp spread {spread:.6f}, port against JAX {gap:.6f}")
    assert spread > 0.0
    assert gap <= chip_smoke.NOISE_FACTOR * spread, (gap, spread)
    sure = np.abs(pj - 0.5) > 0.1
    assert np.array_equal(lt[sure], lj[sure])
