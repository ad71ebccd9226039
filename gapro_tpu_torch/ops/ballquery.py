"""Ball query: fixed-K radius neighbours, masked, dense batch
(``gapro_tpu/ops/ballquery.py``).

For each query, the K lowest-index valid points within ``radius``; empty
slots repeat the first hit; a query with no hit, or an invalid query,
yields index 0. This is ``ball_query_tiled``'s semantics, including its
distance formula |q|^2 + |p|^2 - 2 q.p. The port keeps these exact
semantics at every N; the JAX package switches to ``ball_query_grid`` for
N >= 32768, which examines at most 512 candidates per query and so deviates
by design past that many.

The [Q, N] distance tile is computed in chunks of ``chunk`` points (at
2048 x 262144 one fp32 tile would be 2 GB), merging each chunk's hits into
a running set of the K smallest indices.
"""

from __future__ import annotations

import torch

_BIG = 2 ** 30


def ball_query(queries, points, q_valid, p_valid, radius: float, k: int,
               chunk: int = 8192):
    """queries [B, Q, 3], points [B, N, 3], q_valid [B, Q], p_valid [B, N]
    -> neighbour indices [B, Q, K] int32 and counts [B, Q] int32."""
    b, nq, _ = queries.shape
    n = points.shape[1]
    dev = queries.device
    r2 = (torch.tensor(radius, dtype=torch.float32) ** 2).to(dev)
    qq = (queries * queries).sum(-1)  # [B, Q]
    best = torch.full((b, nq, k), _BIG, dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        pts = points[:, s:s + chunk]
        pp = (pts * pts).sum(-1)
        d2 = qq[:, :, None] + pp[:, None, :] - 2.0 * torch.bmm(queries, pts.transpose(1, 2))
        within = (d2 <= r2) & p_valid[:, None, s:s + chunk]
        idx = torch.arange(s, s + pts.shape[1], dtype=torch.int32, device=dev)
        cand = torch.where(within, idx, _BIG)
        merged = torch.cat([best, cand], 2)
        best = torch.topk(merged, k, dim=2, largest=False, sorted=True).values
    found = best < _BIG
    counts = found.sum(2).int()
    first = torch.where(counts > 0, best[..., 0], 0)
    out = torch.where(found, best, first[..., None])
    out = torch.where(q_valid[..., None], out, 0)
    return out, torch.where(q_valid, counts, 0)
