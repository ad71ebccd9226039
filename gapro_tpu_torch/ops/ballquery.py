"""Ball query: fixed-K radius neighbours, masked, dense batch
(``gapro_tpu/ops/ballquery.py``).

For each query, the K lowest-index valid points within ``radius``; empty
slots repeat the first hit; a query with no hit, or an invalid query,
yields index 0. Two forms, as in the JAX package, chosen by
``ball_query_masked`` from the static point count:

* ``ball_query_tiled`` (N < 4 * chunk): exact. The [Q, N] distance tile,
  |q|^2 + |p|^2 - 2 q.p, is computed in chunks of ``chunk`` points (at
  2048 x 262144 one fp32 tile would be 2 GB), merging each chunk's hits
  into a running set of the K smallest indices.
* ``ball_query_grid`` (N >= 4 * chunk, every full-width stage 1): points
  sorted by radius-sized grid cell; a query's 27 neighbour cells are 9
  contiguous runs of the sorted keys (the 3 dz cells of one (dx, dy)
  column are consecutive keys), and at most 4 * ``cell_cap`` = 512 of their
  points, in (dx, dy)-column order, are examined. A query whose 9 runs hold
  more points than that may miss neighbours the tiled form finds: the JAX
  package's contract, which this form computes index for index.
"""

from __future__ import annotations

import torch

_BIG = 2 ** 30
_CELL_BITS = 10  # 1024 cells per axis; scene extent <= 1024 * radius
_AXIS_MAX = (1 << _CELL_BITS) - 1


def ball_query_masked(queries, points, q_valid, p_valid, radius: float, k: int,
                      chunk: int = 8192):
    """The grid form for large point sets, the tiled form for small
    (``gapro_tpu/ops/ballquery.py:ball_query_masked``)."""
    if points.shape[1] >= 4 * chunk:
        return ball_query_grid(queries, points, q_valid, p_valid, radius, k)
    return ball_query_tiled(queries, points, q_valid, p_valid, radius, k, chunk)


def _finish(best, q_valid):
    """K smallest hit indices (``_BIG`` where none) -> (indices, counts)."""
    found = best < _BIG
    counts = found.sum(2).int()
    first = torch.where(counts > 0, best[..., 0], 0)
    out = torch.where(found, best, first[..., None])
    out = torch.where(q_valid[..., None], out, 0)
    return out, torch.where(q_valid, counts, 0)


def ball_query_tiled(queries, points, q_valid, p_valid, radius: float, k: int,
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
    return _finish(best, q_valid)


def ball_query_grid(queries, points, q_valid, p_valid, radius: float, k: int,
                    cell_cap: int = 128):
    """The grid form (module docstring), with no host sync; the same
    arguments and results as ``ball_query_tiled``.

    Every step repeats ``gapro_tpu/ops/ballquery.py:ball_query_grid``'s
    float operations in its order, so that cell keys and hits are the same:
    the cell is floor((p - origin) * (1 / radius)), and the squared
    distance is dx*dx + dy*dy + dz*dz. The argsort there is stable, and so
    is the sort here: once the cap binds, the order inside a run decides
    which points are examined.
    """
    b, nq, _ = queries.shape
    n = points.shape[1]
    dev = queries.device
    total_cap = 4 * cell_cap
    radius32 = torch.tensor(radius, dtype=torch.float32, device=dev)
    r2 = radius32 ** 2
    inv_cell = 1.0 / radius32
    lo = torch.where(p_valid[..., None], points, torch.inf).amin(1, keepdim=True)  # [B, 1, 3]
    origin = torch.where(torch.isfinite(lo), lo, 0.0) - radius32

    def cell_coords(xyz):
        # clipped before the cast, so that no float is out of int32's range
        return torch.floor((xyz - origin) * inv_cell).clamp(0, _AXIS_MAX).int()

    c = cell_coords(points)
    key = (c[..., 0] << 2 * _CELL_BITS) | (c[..., 1] << _CELL_BITS) | c[..., 2]
    key = torch.where(p_valid, key, _BIG)
    skey, order = torch.sort(key, dim=1, stable=True)

    # 9 (dx, dy) columns per query, dx-major; each is one run of keys from
    # z_lo to z_hi, the dz range clamped at the grid border
    d = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    dxy = torch.stack(torch.meshgrid(d, d, indexing="ij"), -1).reshape(9, 2)
    col_offs = (dxy[:, 0] << 2 * _CELL_BITS) + (dxy[:, 1] << _CELL_BITS)
    qc = cell_coords(queries)  # [B, Q, 3]
    qcol = (qc[..., 0] << 2 * _CELL_BITS) | (qc[..., 1] << _CELL_BITS)
    z_lo = (qc[..., 2] - 1).clamp(min=0)
    z_hi = (qc[..., 2] + 1).clamp(max=_AXIS_MAX)
    run = qcol[..., None] + col_offs  # [B, Q, 9]
    # a column whose (x, y) cell lies outside the grid is dropped: its key
    # range would alias another column's or the invalid points' sentinel
    cxy = qc[..., None, :2] + dxy
    col_ok = ((cxy >= 0) & (cxy <= _AXIS_MAX)).all(-1)
    starts = torch.searchsorted(skey, (run + z_lo[..., None]).reshape(b, -1)).view(b, nq, 9)
    ends = torch.searchsorted(skey, (run + z_hi[..., None] + 1).reshape(b, -1)).view(b, nq, 9)

    # the 9 runs packed into one budget of total_cap slots per query: run
    # lengths clipped to the budget, slot s belongs to the first run whose
    # inclusive cumsum exceeds s (none past the total demand)
    length = torch.where(col_ok, (ends - starts).clamp(min=0), 0).clamp(max=total_cap)
    cum = length.cumsum(2)
    slot = torch.arange(total_cap, device=dev).expand(b, nq, total_cap).contiguous()
    r = torch.searchsorted(cum, slot, right=True)  # [B, Q, S] in 0..9
    slot_ok = r < 9
    r = r.clamp(max=8)
    pos = (starts - (cum - length)).gather(2, r) + slot
    pos = pos.clamp(0, n - 1).reshape(b, -1)

    cand = order.gather(1, pos)  # original indices
    g = points.gather(1, cand[..., None].expand(-1, -1, 3)).view(b, nq, total_cap, 3)
    cand = cand.view(b, nq, total_cap).int()
    dx, dy, dz = (g - queries[:, :, None, :]).unbind(-1)
    d2 = dx * dx + dy * dy + dz * dz
    hit = slot_ok & (d2 <= r2)
    prio = torch.where(hit, cand, _BIG)
    best = torch.topk(prio, k, dim=2, largest=False, sorted=True).values
    return _finish(best, q_valid)
