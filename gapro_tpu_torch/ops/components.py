"""Connected components over point adjacency (``gapro_tpu/ops/components.py``).

Replaces the reference's PointGroup-style clustering: a ball query builds
an adjacency list, then a CPU BFS finds the components
(ISBNet/isbnet/ops/src/bfs_cluster/bfs_cluster.cpp:50-143). Here, as in
the JAX package: iterative min-label propagation with pointer jumping over
the fixed-K ball-query neighbour table, at most ``max_iters`` sweeps.
"""

from __future__ import annotations

import torch

from ..core.segment import segment_sum
from .ballquery import ball_query_masked


def connected_components(nbr_idx, valid, max_iters: int = 32):
    """[N, K] neighbour table (-1 none) -> [N] int32 component labels: the
    smallest point index of the component, -1 for invalid points."""
    n = nbr_idx.shape[0]
    idx = torch.arange(n, device=nbr_idx.device)
    safe = torch.where(nbr_idx >= 0, nbr_idx.long(), idx[:, None])
    label = idx
    for _ in range(max_iters):
        new = torch.minimum(label, label[safe].min(1).values)
        new = torch.minimum(new, new[new])  # pointer jump
        changed = bool((new != label).any())
        label = new
        if not changed:
            break
    return torch.where(valid, label, -1).int()


def cluster_points(xyz, valid, semantic, radius: float, k: int = 16, min_points: int = 50):
    """PointGroup-style semantic-constrained clustering of one scene: points
    within ``radius`` of one another (``ball_query_masked``, K = ``k``) and
    of one semantic class are connected. Returns (labels [N], the smallest
    index of each point's cluster, -1 for clusters under ``min_points``
    (bfs_cluster.cpp's threshold) and invalid points; sizes [N], each
    point's cluster size)."""
    n = xyz.shape[0]
    nbr, _ = ball_query_masked(xyz[None], xyz[None], valid[None], valid[None], radius, k)
    nbr = nbr[0].long()
    same = torch.where(nbr >= 0, semantic[nbr.clamp(min=0)] == semantic[:, None], False)
    labels = connected_components(torch.where(same, nbr, -1), valid)
    at = labels.long().clamp(min=0)
    size_of = segment_sum(torch.where(labels >= 0, 1, 0).int(), at, n)
    sizes = torch.where(labels >= 0, size_of[at], 0)
    return torch.where(sizes >= min_points, labels, -1), sizes
