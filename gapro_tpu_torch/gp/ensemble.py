"""Per-channel-block GP ensemble classifier (``gapro_tpu/gp/ensemble.py``;
the reference's ``fit_gp_ensemble``, a selectable solver the generation
path does not call).

The reference fits one variational GP per feature channel block in a
serial loop and takes a soft two-class vote. Here the blocks are lanes of
one ``fit_gp_batch`` call: each block's features are zero-padded to the
widest block (constant dims add nothing to the RBF distance, so the padded
fit is the subspace fit).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .fallback import nearest_subsample
from .variational import fit_gp_batch


def _pool_by_spp(feats: np.ndarray, spp: np.ndarray):
    """Mean over each superpoint id. Returns (pooled, inverse)."""
    _, inv = np.unique(spp, return_inverse=True)
    n = int(inv.max()) + 1 if len(inv) else 0
    sums = np.zeros((n, feats.shape[1]), np.float64)
    np.add.at(sums, inv, feats)
    counts = np.bincount(inv, minlength=n).astype(np.float64)
    return (sums / counts[:, None]).astype(np.float32), inv


def fit_gp_ensemble(
    coords_float,
    feats,
    spp,
    b1_inds,
    b2_inds,
    intersect_inds,
    channel_dims,
    training_iter: int = 50,
    npoint_nearest: int = 800,
    spp_pool: bool = True,
    lr: float = 0.1,
    n_inducing: int | None = 128,
    device=None,
):
    """Ensemble-of-GPs box-pair classifier.

    Args (numpy): coords_float [N, 3]; feats [N, D]; spp [N]; the b1, b2 and
    intersection index arrays; channel_dims block boundaries (e.g. [0, 3, 6]
    fits xyz and rgb apart). The fit runs on ``device`` (``cuda`` unless
    named). Returns per intersection row (pred_probs, pred_labels bool,
    pred_variance): the winning class's mean probability mass over blocks,
    the soft-vote argmax, and the summed Bernoulli variance p(1 - p).
    """
    dev = resolve_device(device)
    coords_float = np.asarray(coords_float, np.float32)
    feats = np.asarray(feats, np.float32)
    spp = np.asarray(spp)
    b1_inds = np.asarray(b1_inds)
    b2_inds = np.asarray(b2_inds)
    intersect_inds = np.asarray(intersect_inds)

    centroid = coords_float[intersect_inds].mean(0)
    b1_inds = nearest_subsample(coords_float, b1_inds, centroid, npoint_nearest)
    b2_inds = nearest_subsample(coords_float, b2_inds, centroid, npoint_nearest)

    b1_feats = feats[b1_inds]
    b2_feats = feats[b2_inds]
    q_feats = feats[intersect_inds]
    if spp_pool:
        b1_feats, _ = _pool_by_spp(b1_feats, spp[b1_inds])
        b2_feats, _ = _pool_by_spp(b2_feats, spp[b2_inds])
        q_feats, q_inv = _pool_by_spp(q_feats, spp[intersect_inds])
    else:
        q_inv = None

    n_blocks = len(channel_dims) - 1
    dmax = max(channel_dims[i + 1] - channel_dims[i] for i in range(n_blocks))
    t = len(b1_feats) + len(b2_feats)
    q = len(q_feats)

    tx = np.zeros((n_blocks, t, dmax), np.float32)
    qx = np.zeros((n_blocks, q, dmax), np.float32)
    ty = np.concatenate([-np.ones(len(b1_feats), np.float32), np.ones(len(b2_feats), np.float32)])
    train = np.concatenate([b1_feats, b2_feats], axis=0)
    # shuffle rows: the first n_inducing rows become the inducing set
    perm = np.random.default_rng(0).permutation(t)
    train = train[perm]
    ty = ty[perm]
    for i in range(n_blocks):
        c0, c1 = channel_dims[i], channel_dims[i + 1]
        tx[i, :, : c1 - c0] = train[:, c0:c1]
        qx[i, :, : c1 - c0] = q_feats[:, c0:c1]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    res = fit_gp_batch(up(tx), up(np.tile(ty, (n_blocks, 1))),
                       torch.ones((n_blocks, t), dtype=torch.bool, device=dev), up(qx),
                       torch.ones((n_blocks, q), dtype=torch.bool, device=dev), training_iter,
                       lr, None if n_inducing is None else min(n_inducing, t))
    probs = res.probs.cpu().numpy()  # [n_blocks, Q] p(y=+1)

    # Soft two-class vote and the summed Bernoulli variance. The reference's
    # two branches are swapped so that its argmax is always class 1; as in
    # the JAX package, the vote here is the probability mass per class.
    vote = np.zeros((q, 2), np.float32)
    vote[:, 1] = np.sum(probs, axis=0)
    vote[:, 0] = np.sum(1.0 - probs, axis=0)
    variance = np.sum(probs * (1.0 - probs), axis=0).astype(np.float32)
    pred_labels = vote[:, 1] > vote[:, 0]  # ties -> class 0, as torch.max
    pred_probs = np.max(vote, axis=1) / n_blocks

    if q_inv is not None:
        pred_probs = pred_probs[q_inv]
        pred_labels = pred_labels[q_inv]
        variance = variance[q_inv]
    return pred_probs, pred_labels, variance
