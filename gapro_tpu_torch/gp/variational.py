"""Batched whitened variational GP binary classification
(``gapro_tpu/gp/variational.py``).

The model of the reference's gpytorch ``GPClassificationModel``:

  * ScaleKernel(RBFKernel) covariance and a ConstantMean (softplus of raw
    parameters that start at 0, so both scales start at softplus(0)),
  * a Cholesky variational distribution (mean 0, Cholesky I at the start),
  * the whitened strategy with learned inducing locations (the first M
    train rows) and a 1e-4 jitter on K_zz,
  * a probit Bernoulli likelihood, its expected log taken by 20-node
    Gauss-Hermite quadrature,
  * 50 Adam(0.1) steps on -ELBO.

Every function takes any leading batch axes: ``fit_gp_batch`` fits a whole
batch of box-pair problems (lanes) as one set of batched tensors, with one
loss, the sum of the lanes' -ELBO, so each lane's gradient is its own.
Padding is masked and pinned to the prior, so a padded lane gives the same
answer as the problem without padding, and a lane with every mask false
stays finite.

Math (whitened):
  L = chol(K_zz + jitter I),  A = L^{-1} K_zx
  q(f(x)) mean = mu + A^T m,  var = k(x,x) + diag(A^T (S - I) A),  S = L_s L_s^T
  KL(q(u)||p(u)) = 0.5 (tr S + m^T m - M - log det S)
  ELBO = mean_i E_q[log Phi(y_i f_i)] - KL / N_valid,  y in {-1, +1}

Precision: every product runs in full fp32 whatever the caller set for
TF32 (the JAX package asks for ``Precision.HIGHEST``); see
``fit_numerics``. Inside the 50 steps nothing is read back to the host.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .linalg import cholesky_mm, tri_inv_mm

_JITTER = 1e-4
_GH_POINTS = 20
_GH_X, _GH_W = np.polynomial.hermite.hermgauss(_GH_POINTS)
# optax.adam's defaults (torch.optim.Adam's too)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class GPParams(NamedTuple):
    inducing: torch.Tensor  # [..., M, D] learned inducing locations
    var_mean: torch.Tensor  # [..., M] whitened variational mean
    var_chol: torch.Tensor  # [..., M, M] whitened variational Cholesky (lower)
    raw_lengthscale: torch.Tensor  # [...], softplus
    raw_outputscale: torch.Tensor  # [...], softplus
    mean_const: torch.Tensor  # [...] constant mean


class GPFitResult(NamedTuple):
    probs: torch.Tensor  # [..., Q] marginal p(y=+1)
    probs_new: torch.Tensor  # [..., Q] confidence max(p, 1-p)
    labels: torch.Tensor  # [..., Q] bool, probs >= 0.5
    mu: torch.Tensor  # [..., Q] latent posterior mean
    var: torch.Tensor  # [..., Q] latent posterior variance
    elbo: torch.Tensor  # [...] final ELBO (diagnostics)


@contextlib.contextmanager
def fit_numerics():
    """TF32 off for cuBLAS for the length of a fit, and the caller's setting
    given back afterwards. The flag is read when a product is launched, so
    the fit's products are full fp32 whatever the caller set.
    ``torch.backends.cuda.matmul.allow_tf32`` is process-global: while a fit
    runs it is off for every thread of the process."""
    m = torch.backends.cuda.matmul
    prev = m.allow_tf32
    m.allow_tf32 = False
    try:
        yield
    finally:
        m.allow_tf32 = prev


def rbf_scaled(x1, x2, lengthscale, outputscale):
    """outputscale * exp(-0.5 ||(x1 - x2) / lengthscale||^2), x1 [..., N, D],
    x2 [..., M, D], the scales [...].

    The direct pairwise-difference form: the |a|^2 + |b|^2 - 2ab expansion
    (which ``torch.cdist`` takes above 25 rows) loses the zero diagonal to
    rounding, the Gram matrix stops being PSD and the Cholesky gives NaN."""
    ls = lengthscale[..., None, None]
    x1s = x1 / ls
    x2s = x2 / ls
    diff = x1s[..., :, None, :] - x2s[..., None, :, :]
    d2 = torch.sum(diff * diff, dim=-1)
    return outputscale[..., None, None] * torch.exp(-0.5 * d2)


def init_params(train_x: torch.Tensor) -> GPParams:
    """The gpytorch start: inducing points at ``train_x`` [..., M, D]."""
    lead, m = train_x.shape[:-2], train_x.shape[-2]
    kw = dict(dtype=torch.float32, device=train_x.device)
    return GPParams(
        inducing=train_x.float().clone(),
        var_mean=torch.zeros(lead + (m,), **kw),
        var_chol=torch.eye(m, **kw).expand(lead + (m, m)).clone(),
        raw_lengthscale=torch.zeros(lead, **kw),
        raw_outputscale=torch.zeros(lead, **kw),
        mean_const=torch.zeros(lead, **kw),
    )


def _eye(m: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(m, dtype=torch.float32, device=like.device)


def _masked_params(params: GPParams, z_mask):
    """Pin padded inducing dims to the whitened prior N(0, I): they then add
    exactly 0 to the KL and to the predictions."""
    m = params.var_mean.shape[-1]
    mask2 = z_mask[..., :, None] & z_mask[..., None, :]
    var_mean = torch.where(z_mask, params.var_mean, 0.0)
    var_chol = torch.where(mask2, torch.tril(params.var_chol), _eye(m, z_mask))
    return params._replace(var_mean=var_mean, var_chol=var_chol)


def _predict_latent(params: GPParams, z_mask, x, x_mask):
    """q(f(x)) mean and variance [..., Q] under the whitened strategy."""
    p = _masked_params(params, z_mask)
    ls = F.softplus(p.raw_lengthscale)
    os_ = F.softplus(p.raw_outputscale)
    m = p.inducing.shape[-2]
    eye = _eye(m, x)
    mask2 = z_mask[..., :, None] & z_mask[..., None, :]

    k_zz = torch.where(mask2, rbf_scaled(p.inducing, p.inducing, ls, os_), eye)
    chol = cholesky_mm(k_zz + _JITTER * eye)
    k_zx = rbf_scaled(p.inducing, x, ls, os_)
    k_zx = torch.where(z_mask[..., :, None] & x_mask[..., None, :], k_zx, 0.0)
    interp = tri_inv_mm(chol) @ k_zx  # [..., M, Q], as the JAX package (linalg.py)
    mean = p.mean_const[..., None] + (interp * p.var_mean[..., :, None]).sum(-2)
    middle = p.var_chol @ p.var_chol.transpose(-1, -2) - eye
    var_diag = os_[..., None] + (interp * (middle @ interp)).sum(-2)
    var_diag = torch.clamp_min(var_diag, 1e-10)
    return torch.where(x_mask, mean, 0.0), torch.where(x_mask, var_diag, 1.0)


def _kl(params: GPParams, z_mask):
    p = _masked_params(params, z_mask)
    lchol = torch.tril(p.var_chol)
    s_diag = torch.sum(lchol * lchol, dim=-1)
    trace = torch.sum(torch.where(z_mask, s_diag, 1.0), dim=-1)
    quad = torch.sum(p.var_mean * p.var_mean, dim=-1)
    diag = torch.abs(torch.diagonal(lchol, dim1=-2, dim2=-1))
    logdet = 2.0 * torch.sum(
        torch.where(z_mask, torch.log(torch.clamp_min(diag, 1e-20)), 0.0), dim=-1)
    mdim = torch.sum(z_mask.float(), dim=-1)
    return 0.5 * (trace + quad - mdim - logdet)


@functools.lru_cache(maxsize=None)
def _gh_nodes(device: torch.device):
    """The quadrature's nodes and weights on ``device``, uploaded once: an
    upload from pageable memory waits for the card's queue, which inside
    the fit's steps would be a sync a step."""
    return (torch.as_tensor(_GH_X, dtype=torch.float32, device=device),
            torch.as_tensor(_GH_W, dtype=torch.float32, device=device))


def _expected_log_probit(mean, var, y):
    """E_{f~N(mean, var)}[log Phi(y f)] by 20-node Gauss-Hermite quadrature,
    y in {-1, +1} (the scheme gpytorch uses for non-conjugate likelihoods)."""
    gx, gw = _gh_nodes(mean.device)
    std = torch.sqrt(var)
    f = mean[..., None] + math.sqrt(2.0) * std[..., None] * gx
    ll = torch.special.log_ndtr(y[..., None] * f)
    return torch.sum(ll * gw, dim=-1) / math.sqrt(math.pi)


def elbo(params: GPParams, z_mask, train_x, train_y, train_mask):
    """The ELBO [...] of each lane."""
    mean, var = _predict_latent(params, z_mask, train_x, train_mask)
    ell = torch.where(train_mask, _expected_log_probit(mean, var, train_y), 0.0)
    n = torch.clamp_min(torch.sum(train_mask.float(), dim=-1), 1.0)
    return torch.sum(ell, dim=-1) / n - _kl(params, z_mask) / n


def adam_step(leaves, grads, mus, nus, count: int, lr: float, weight_decay: float = 0.0):
    """One step of optax's ``adam`` (``adamw`` with ``weight_decay``) on the
    leaves, in place: bias-corrected moments, eps outside the square root,
    eps_root 0, the decay added to the Adam direction before the rate."""
    bc1 = 1.0 - _B1 ** count
    bc2 = 1.0 - _B2 ** count
    for p, g, mu, nu in zip(leaves, grads, mus, nus):
        mu.mul_(_B1).add_(g, alpha=1.0 - _B1)
        nu.mul_(_B2).addcmul_(g, g, value=1.0 - _B2)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + _EPS)
        if weight_decay:
            u = u + weight_decay * p
        p.sub_(lr * u)


def fit_gp_batch(tx, ty, tm, qx, qm, iters: int = 50, lr: float = 0.1,
                 n_inducing: int | None = None) -> GPFitResult:
    """Fit B masked variational GPs at once and evaluate each posterior on
    its test rows.

    tx [B, T, D] train features, ty [B, T] in {-1, +1}, tm [B, T] bool;
    qx [B, Q, D], qm [B, Q] bool. ``n_inducing`` caps the inducing set at
    the first M train rows (callers shuffle the rows); the ELBO still sums
    over every train row. Returns a GPFitResult of [B, Q] fields (elbo [B]).
    """
    tx, ty, qx = tx.float(), ty.float(), qx.float()
    t = tx.shape[-2]
    m = t if n_inducing is None else min(n_inducing, t)
    z_mask = tm[..., :m]
    with fit_numerics():
        leaves = [p.requires_grad_(True) for p in init_params(tx[..., :m, :])]
        mus = [torch.zeros_like(p) for p in leaves]
        nus = [torch.zeros_like(p) for p in leaves]
        for count in range(1, iters + 1):
            with torch.enable_grad():
                loss = -elbo(GPParams(*leaves), z_mask, tx, ty, tm).sum()
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                adam_step(leaves, grads, mus, nus, count, lr)
        with torch.no_grad():
            params = GPParams(*(p.detach() for p in leaves))
            mu, var = _predict_latent(params, z_mask, qx, qm)
            probs = torch.special.ndtr(mu / torch.sqrt(1.0 + var))
            labels = probs >= 0.5
            probs_new = torch.where(labels, probs, 1.0 - probs)
            final_elbo = elbo(params, z_mask, tx, ty, tm)
    return GPFitResult(probs=probs, probs_new=probs_new, labels=labels, mu=mu, var=var,
                       elbo=final_elbo)


def fit_gp(train_x, train_y, train_mask, test_x, test_mask, iters: int = 50,
           lr: float = 0.1, n_inducing: int | None = None) -> GPFitResult:
    """One problem: ``fit_gp_batch`` on a batch of one (train_x [T, D],
    train_y [T], test_x [Q, D], masks bool)."""
    res = fit_gp_batch(train_x[None], train_y[None], train_mask[None], test_x[None],
                       test_mask[None], iters, lr, n_inducing)
    return GPFitResult(*(f[0] for f in res))
