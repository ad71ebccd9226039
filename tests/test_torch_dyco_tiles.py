"""The precision of K5's products, and the bound ``chip_smoke.py`` holds K5 to.

K5 (``gapro_tpu_torch/csrc/dyco.cu``) takes the mask head's two products on
the TF32 tensor cores in the split form (3xTF32): each operand x = hi + lo
with hi = tf32(x) and lo = tf32(x - hi), each product a_lo.b_hi + a_hi.b_lo
+ a_hi.b_hi summed in fp32. A numpy emulation of that chain, layer by layer
as the kernel runs it (layer 0 over [features; geometry; 0, 0], relu(acc +
b0) in fp32 split again as layer 1's A, relu(acc + b1) . W2 in fp32), lands
within K5's gate (rtol 2e-5, atol 2e-4, ``chip_smoke.py:K5_RTOL``) of the
plain fp32 version, at unit scale (``tests/test_torch_dyco.py``'s inputs)
and at the model's (``chip_smoke.py:dyco_inputs``); one TF32 pass misses
it. The tensor cores' own fp32 sums, which truncate, are not emulated: a
layer's products are summed in float64 and rounded once (``chip_smoke.py``
holds the kernel against fp64 on the card).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (DYCO_SHAPES, FP32_FLOPS, K5_ATOL, K5_RTOL, TF32_FLOPS, dyco_bytes,
                        dyco_inputs, dyco_ops, tc_bounds)
from gapro_tpu_torch.models import dyco
from tests.test_torch_conv_tiles import _split, _tf32
from tests.test_torch_dyco import _problem


def _product(a, b, passes: int):
    """[..., K] x [..., K, N] as the kernel's wgmmas take it: the split form
    (passes 3) or one TF32 pass (passes 1), summed exactly, rounded to fp32."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    f64 = lambda x: x.astype(np.float64)
    mm = lambda x, y: np.einsum("bqsk,bqkn->bqsn", f64(x), f64(y))
    if passes == 1:
        return mm(a_hi, b_hi).astype(np.float32)
    return (mm(a_lo, b_hi) + mm(a_hi, b_lo) + mm(a_hi, b_hi)).astype(np.float32)


def _emulate(args, passes: int):
    """K5's chain in numpy on fp32 inputs -> logits [B, Q, S]."""
    w0, w1, w2, b0, b1, q_locs, q_dims, feats, coords, dims, valid = args
    b, q, s = w0.shape[0], w0.shape[1], feats.shape[1]
    m = feats.shape[2]
    geo = np.concatenate([q_locs[:, :, None] - coords[:, None],
                          np.abs(q_dims[:, :, None] - dims[:, None])], -1)  # fp32
    a0 = np.concatenate([np.broadcast_to(feats[:, None], (b, q, s, m)), geo,
                         np.zeros((b, q, s, 2), np.float32)], -1)
    w0k = np.concatenate([w0[:, :, 6:], w0[:, :, :6], np.zeros((b, q, 2, m), np.float32)], 2)
    x0 = np.maximum(_product(a0, w0k, passes) + b0[:, :, None], np.float32(0))
    x1 = np.maximum(_product(x0, w1, passes) + b1[:, :, None], np.float32(0))
    out = np.einsum("bqsh,bqh->bqs", x1, w2[..., 0]).astype(np.float32)  # the CUDA cores, fp32
    return np.where(valid[:, None], out, np.float32(-1e4))


def _inputs(kind):
    if kind == "unit":
        return [np.asarray(a) for a in _problem(np.random.default_rng(0), 2, 24, 300)]
    return [t.numpy() for t in dyco_inputs("cpu", 2, 24, 300, seed=3)]


@pytest.mark.parametrize("kind", ["unit", "model"])
def test_3xtf32_chain_meets_k5_gate_where_one_pass_does_not(kind):
    args = _inputs(kind)
    plain = dyco.dyco_mlp_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args)).numpy()
    three, one = _emulate(args, 3), _emulate(args, 1)
    gate = K5_ATOL + K5_RTOL * np.abs(plain)
    assert (np.abs(three - plain) <= gate).all()
    assert (np.abs(one - plain) > gate).any()
    assert (three[np.broadcast_to(~args[-1][:, None], three.shape)] == -1e4).all()


def test_tf32_emulation_rounds_as_cvt_rna():
    """10 mantissa bits, ties away from zero; a value of at most 22
    significant bits splits exactly (the fragment-mapping test's)."""
    assert _tf32(np.float32(1 + 2 ** -11)) == np.float32(1 + 2 ** -10)
    assert _tf32(np.float32(1 + 2 ** -12)) == np.float32(1)
    x = np.float32(599 + 31 / 64)
    hi, lo = _split(x)
    assert hi + lo == x and hi != x


@pytest.mark.parametrize("m", [8, 16, 32])
def test_k5_ops_count_the_functions_multiply_adds(m):
    """2 (M + 6) M + 2 M H + 2 H operations a (query, valid superpoint) pair,
    H = M / 2: the three layers' multiply-adds, nothing for the invalid
    pairs, the kernel's padding or the 3xTF32 form."""
    h = m // 2
    assert dyco_ops(1000, m) == 1000 * (2 * (m + 6) * m + 2 * m * h + 2 * h)
    assert dyco_ops(0, m) == 0


def test_k5_bound_is_the_tf32_rate_at_the_training_shape():
    """At the batch-4 training launch (B = 4, Q = 256, S = 4096, 80% valid)
    the bound is the function's operations at 495 TFLOP/s, about 0.024 ms;
    beside it 3xTF32 (three times those) about 0.071 ms and fp32 about
    0.175 ms, the rate the kernel before the tensor cores was capped at."""
    b, q, s, empty, _ = DYCO_SHAPES[0]
    assert empty == 0
    pairs = q * round(0.8 * b * s)
    ops, nbytes = dyco_ops(pairs), dyco_bytes(b, q, s)
    got = tc_bounds(nbytes, ops)
    assert got["by"] == "operations"
    assert got["bound"] == pytest.approx(ops / TF32_FLOPS * 1e3)
    assert got["x3"] == pytest.approx(3 * ops / TF32_FLOPS * 1e3)
    assert got["fp32"] == pytest.approx(ops / FP32_FLOPS * 1e3)
    assert (round(got["bound"], 3), round(got["x3"], 3), round(got["fp32"], 3)) == (
        0.024, 0.071, 0.175)
