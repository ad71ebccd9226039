"""Instance-aware local aggregator (``gapro_tpu/models/aggregator.py``).

FPS -> ball-query neighbourhoods -> [rel-xyz, rel-box-dims, feats] ->
SharedMLP + max-pool, twice -> bottleneck MLP + skip. Dense [B, N, ...]
layout with validity masks throughout. The max-pools are ``amax``, which
splits the gradient evenly among ties as JAX's ``max`` does: the ball query
repeats its first hit in empty slots, so ties are exact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..ops import fps as fps_ops
from ..ops.ballquery import ball_query_masked
from .common import ConvBlock1d, SharedMLP, jabs


class AggregatorOutput(NamedTuple):
    locs: torch.Tensor  # [B, S, 3]
    feats: torch.Tensor  # [B, S, C]
    boxes: torch.Tensor  # [B, S, 6]
    inds: torch.Tensor  # [B, S] indices into the input N axis
    valid: torch.Tensor  # [B, S]


def _group(values, idx):
    """values [B, N, C], idx [B, Q, K] -> [B, Q, K, C]."""
    b = torch.arange(values.shape[0], device=values.device)[:, None, None]
    return values[b, idx.long()]


def _take(values, idx):
    """values [B, N, C], idx [B, S] -> [B, S, C]."""
    b = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[b, idx.long()]


class LocalAggregator(nn.Module):
    def __init__(self, in_feat_dim: int, mlp_dim: int = 32, n_sample: int = 1024,
                 radius: float = 0.4, n_neighbor: int = 64, n_neighbor_post: int = 64):
        super().__init__()
        self.n_sample = n_sample
        self.radius = radius
        self.n_neighbor = n_neighbor
        self.n_neighbor_post = n_neighbor_post
        c = mlp_dim
        self.mlp1 = SharedMLP(in_feat_dim + 6, (c, 2 * c))
        self.mlp2 = SharedMLP(2 * c + 6, (2 * c,), final_activation=False)
        self.mlp3a = ConvBlock1d(2 * c, 2 * c * 4)
        self.mlp3b = ConvBlock1d(2 * c * 4, 2 * c, activation=False)

    def forward(self, locs, feats, boxes, valid, sampled_before: bool = False,
                n_sample: Optional[int] = None) -> AggregatorOutput:
        """locs [B,N,3], feats [B,N,C], boxes [B,N,6], valid [B,N].
        ``n_sample`` overrides the module's count (iterative inference)."""
        b = locs.shape[0]
        ns = self.n_sample if n_sample is None else n_sample
        dim_boxes = boxes[..., 3:] - boxes[..., :3]

        if sampled_before:
            fps_inds = torch.arange(ns, dtype=torch.int32, device=locs.device)[None].repeat(b, 1)
            s_valid = valid[:, :ns]
        else:
            fps_inds, s_valid = fps_ops.fps(locs, valid, ns)

        fps_locs = _take(locs, fps_inds)
        fps_dims = _take(dim_boxes, fps_inds)
        fps_boxes = _take(boxes, fps_inds)

        nbr, _ = ball_query_masked(fps_locs, locs, s_valid, valid, self.radius, self.n_neighbor)
        g_xyz = (_group(locs, nbr) - fps_locs[:, :, None, :]) / self.radius
        g_dim = jabs(_group(dim_boxes, nbr) - fps_dims[:, :, None, :])
        g_feat = torch.cat([g_xyz, g_dim, _group(feats, nbr)], -1)
        x = self.mlp1(g_feat, valid=s_valid[:, :, None]).amax(2)
        identity = x

        r2 = 2 * self.radius
        nbr2, _ = ball_query_masked(fps_locs, fps_locs, s_valid, s_valid, r2, self.n_neighbor_post)
        g2_xyz = (_group(fps_locs, nbr2) - fps_locs[:, :, None, :]) / r2
        g2_dim = jabs(_group(fps_dims, nbr2) - fps_dims[:, :, None, :])
        g2_feat = torch.cat([g2_xyz, g2_dim, _group(x, nbr2)], -1)
        y = self.mlp2(g2_feat, valid=s_valid[:, :, None]).amax(2)

        y = self.mlp3a(y, valid=s_valid)
        y = self.mlp3b(y, valid=s_valid)
        out = torch.where(s_valid[..., None], torch.relu(y + identity), 0.0)
        return AggregatorOutput(locs=fps_locs, feats=out, boxes=fps_boxes,
                                inds=fps_inds, valid=s_valid)
