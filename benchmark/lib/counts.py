"""Operations and bytes of the port's kernels, counted from their shapes,
and the table of peaks.

``bound_ms``, ``tc_bounds``, ``dyco_ops``, ``dyco_bytes`` and
``fps_ops``/``fps_bytes`` are frozen copies of ``chip_smoke.py``'s
arithmetic (``bound_ms``, ``tc_bounds``, ``dyco_ops``, ``dyco_bytes``, the
count in ``k4_case``); they do not follow later changes there. A conv's
count is that of ``chip_smoke.py:k1_phase``: 2 operations for each
multiply-add over the (row, offset) pairs that hold a neighbour, each input
byte read once and each output byte written once. Every count is of what
the inputs need: rows past a plan's valid voxels (a capacity bucket's
padding) are not counted.
"""

from __future__ import annotations

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense, at the 700 W limit).
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flops": 67e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
}
HBM_BYTES_PER_S = PEAKS["hbm_bytes_per_s"]
FP32_FLOPS = PEAKS["fp32_flops"]
TF32_FLOPS = PEAKS["tf32_flops"]
TF32_PASSES = 3  # the conv kernels' split 3xTF32 form


def bound_ms(nbytes: float, ops: float, rate: float = FP32_FLOPS):
    """The least time of ``ops`` at ``rate`` on ``nbytes``, and which bounds it."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / rate * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def tc_bounds(nbytes: float, flops: float) -> dict:
    """A tensor-core kernel's bound (its operations at the TF32 rate), with
    the fp32 CUDA-core bound and the cost of the 3xTF32 form beside it."""
    bms, by = bound_ms(nbytes, flops, TF32_FLOPS)
    return dict(bound=bms, by=by, fp32=bound_ms(nbytes, flops)[0],
                x3=bound_ms(nbytes, TF32_PASSES * flops, TF32_FLOPS)[0])


def dyco_ops(pairs: int, m: int = 32) -> float:
    """K5's operations: 2 (M + 6) M + 2 M H + 2 H a (query, valid
    superpoint) pair, H = M / 2."""
    h = m // 2
    return float(pairs) * (2 * (m + 6) * m + 2 * m * h + 2 * h)


def dyco_bytes(b: int, q: int, s: int, m: int = 32) -> int:
    """K5's bytes: each query's weights and geometry, each superpoint's
    features, geometry and validity read once, the [B, Q, S] logits
    written once; ``s`` the valid superpoints a scene."""
    h = m // 2
    return (4 * (b * q * ((m + 6) * m + m * h + h + m + h + 6) + b * s * (m + 6) + b * q * s)
            + b * s)


def fps_ops(valid_points: int, n_sample: int) -> float:
    """K4's operations: 10 (3 sub, 3 mul, 2 add, min, compare) for each
    valid point and each step after the first."""
    return 10.0 * valid_points * (n_sample - 1)


def fps_bytes(valid_points: int, b: int, n_sample: int) -> int:
    """K4's bytes: the valid points and their validity read once, the
    indices written once."""
    return valid_points * (12 + 1) + b * n_sample * 4


def subm_counts(rows: int, pairs: int, cin: int, cout: int, backward: bool) -> list:
    """[(ops, bytes)] of a 3x3x3 submanifold conv over ``rows`` valid
    voxels (each with its table row of 27 indices and its validity byte)
    and ``pairs`` valid (row, offset) pairs; with ``backward`` also dfeats
    and dW."""
    ops = 2.0 * pairs * cin * cout
    table = rows * 27 * 4 + rows
    w = 27 * cin * cout * 4
    out = [(ops, table + rows * cin * 4 + w + rows * cout * 4)]
    if backward:
        out.append((ops, table + rows * cout * 4 + w + rows * cin * 4))
        out.append((ops, table + rows * cin * 4 + rows * cout * 4 + w))
    return out


def rule_counts(v_in: int, v_out: int, entries: int, pairs: int, cin: int, cout: int,
                backward: bool) -> list:
    """[(ops, bytes)] of a stride-2 conv or its inverse: ``v_out`` valid
    outputs from ``v_in`` valid inputs over ``entries`` rulebook entries
    read and ``pairs`` valid (output, input) pairs; with ``backward`` also
    the inputs' and weights' gradients."""
    ops = 2.0 * pairs * cin * cout
    table = entries * 4
    w = 8 * cin * cout * 4
    out = [(ops, table + v_in * cin * 4 + w + v_out * cout * 4)]
    if backward:
        out.append((ops, table + v_out * cout * 4 + w + v_in * cin * 4))
        out.append((ops, table + v_in * cin * 4 + v_out * cout * 4 + w))
    return out


def least_s(ops: float, nbytes: float, rate: float = TF32_FLOPS) -> float:
    """The least time in seconds: the larger of ops at ``rate`` and bytes
    at the HBM rate."""
    return max(ops / rate, nbytes / HBM_BYTES_PER_S)
