"""Non-GP classifier for the labeler's box-pair task
(``gapro_tpu/gp/fallback.py``).

The reference's ``fit_regression_model`` trains ``RegressionModel()``, a
single ``nn.Linear(32, 1)``, with BCEWithLogitsLoss and AdamW(0.1): logistic
regression. ``fit_logreg_batch`` is that estimator, full batch, batched over
lanes with ``fit_gp_batch``'s (tx, ty, tm, qx, qm) arguments. The generation
path never calls it. ``nearest_subsample`` is ``fit_gp_ensemble``'s
npoint_nearest selection, on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .variational import adam_step, fit_numerics


class FallbackResult(NamedTuple):
    probs: torch.Tensor
    probs_new: torch.Tensor
    labels: torch.Tensor
    mu: torch.Tensor  # logits (stand-in for the latent mean)
    var: torch.Tensor  # zeros (a point classifier gives no uncertainty)


def fit_logreg_batch(tx, ty, tm, qx, qm, iters: int = 50, lr: float = 0.1) -> FallbackResult:
    """Batched logistic regression: tx [B, T, D]; ty [B, T] in {-1, +1}
    (box 1 is -1, box 2 is +1); tm [B, T] valid; qx [B, Q, D]; qm [B, Q].
    AdamW as optax's ``adamw`` with weight decay 0.01 (torch.optim.AdamW's
    default) on w and b. Returns a FallbackResult of [B, Q] fields."""
    tx, qx = tx.float(), qx.float()
    b, _, d = tx.shape
    y01 = (ty > 0).float()
    tmf = tm.float()
    n = torch.clamp_min(tmf.sum(-1), 1.0)
    with fit_numerics():
        w = torch.zeros((b, d), dtype=torch.float32, device=tx.device, requires_grad=True)
        bias = torch.zeros((b,), dtype=torch.float32, device=tx.device, requires_grad=True)
        leaves = [w, bias]
        mus = [torch.zeros_like(p) for p in leaves]
        nus = [torch.zeros_like(p) for p in leaves]
        for count in range(1, iters + 1):
            with torch.enable_grad():
                logits = (tx @ w[..., None])[..., 0] + bias[:, None]
                ll = F.binary_cross_entropy_with_logits(logits, y01, reduction="none")
                loss = (torch.sum(ll * tmf, -1) / n).sum()
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                adam_step(leaves, grads, mus, nus, count, lr, weight_decay=0.01)
        with torch.no_grad():
            logits = (qx @ w[..., None])[..., 0] + bias[:, None]
    probs = torch.where(qm, torch.sigmoid(logits), 0.5)
    return FallbackResult(probs=probs, probs_new=torch.maximum(probs, 1.0 - probs),
                          labels=probs >= 0.5, mu=torch.where(qm, logits, 0.0),
                          var=torch.zeros_like(probs))


def nearest_subsample(coords, member_idx, centroid, k):
    """Keep the k members closest to the intersection centroid (numpy)."""
    if len(member_idx) <= k:
        return member_idx
    d = np.sum((np.asarray(coords)[member_idx] - np.asarray(centroid)[None]) ** 2, 1)
    return member_idx[np.argpartition(d, k)[:k]]
