# Frozen copy of gapro_tpu_torch/ops/interpolate.py; it does not follow later changes
# to the port.
"""k-NN feature interpolation and grouping (``gapro_tpu/ops/interpolate.py``).

Replaces the reference CUDA ops ``three_nn`` / ``three_interpolate`` /
``gather_points`` / ``group_points`` (ISBNet/isbnet/pointnet2/_ext_src/src/
interpolate_gpu.cu, group_points_gpu.cu; wrappers pointnet2_utils.py:
37-370) as the JAX package does: a dense masked [B, Q, N] distance matrix,
the k nearest, and an inverse-distance-weighted gather.
"""

from __future__ import annotations

import torch

_FAR = 1e10


def knn(query_xyz, ref_xyz, query_valid, ref_valid, k: int = 3):
    """[B, Q, 3] x [B, N, 3] -> (distances [B, Q, k], indices [B, Q, k]
    int32) of each query's k nearest valid refs, the nearest first and the
    lower index first on ties (``lax.top_k``'s order); an invalid query's
    distances are 1e10."""
    d2 = ((query_xyz[:, :, None, :] - ref_xyz[:, None, :, :]) ** 2).sum(-1)  # [B, Q, N]
    d2 = torch.where(ref_valid[:, None, :], d2, _FAR)
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    d = torch.sqrt(torch.clamp(vals[..., :k], min=0.0))
    d = torch.where(query_valid[..., None], d, _FAR)
    return d, idx[..., :k].int()


def three_interpolate(feats, idx, dists, query_valid, eps: float = 1e-8):
    """Inverse-distance-weighted 3-NN interpolation (interpolate_gpu.cu):
    feats [B, N, C], idx and dists [B, Q, 3] -> [B, Q, C], 0 for invalid
    queries."""
    w = 1.0 / (dists ** 2 + eps)
    w = w / w.sum(-1, keepdim=True)
    g = group_points(feats, idx)  # [B, Q, 3, C]
    out = (g * w[..., None]).sum(2)
    return torch.where(query_valid[..., None], out, 0.0)


def gather_points(values, idx):
    """values [B, N, ...], idx [B, S] -> [B, S, ...] (gather_points_gpu.cu)."""
    return values[torch.arange(values.shape[0], device=values.device)[:, None], idx.long()]


def group_points(values, idx):
    """values [B, N, C], idx [B, Q, K] -> [B, Q, K, C] (group_points_gpu.cu)."""
    return values[torch.arange(values.shape[0], device=values.device)[:, None, None],
                  idx.long()]
