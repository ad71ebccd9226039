"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so that it also runs on the machine with the
card, where the JAX package is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tests marked ``gpu`` decide in a fixture whether a card exists and skip
without one. The others check, on the CPU, that a wrapper handed CPU
tensors takes the plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

from gapro_tpu_torch.core.segment import segment_mean
from gapro_tpu_torch.models import dyco
from gapro_tpu_torch.ops import fps as fps_ops
from gapro_tpu_torch.ops.voxelize import voxelize
from gapro_tpu_torch.sparse import conv
from gapro_tpu_torch.sparse.plan import subm_neighbor_table
from gapro_tpu_torch.sparse.tensor import SparseGrid

CAP, EXTENTS = 1024, (24, 32, 32)


def _grid(device):
    rng = np.random.default_rng(3)
    coords = np.stack([np.zeros(900, int), rng.integers(0, 24, 900), rng.integers(0, 32, 900),
                       rng.integers(0, 32, 900)], 1).astype(np.int32)
    maps = voxelize(torch.as_tensor(coords, device=device), EXTENTS, CAP)
    return SparseGrid(coords=maps.voxel_coords, valid=maps.valid_voxel,
                      num_voxels=maps.num_voxels, spatial_shape=EXTENTS, batch_size=1)


def _dyco_args(device, B, Q, S, m=32, seed=0):
    """Mask-head inputs at the model's scales: controller weights of
    O(1/sqrt(fan_in)), unit features and geometry, a fifth of the
    superpoints invalid."""
    g = torch.Generator().manual_seed(seed)
    h = m // 2
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g) * scale).to(device)
    return (r(B, Q, m + 6, m, scale=(m + 6) ** -0.5), r(B, Q, m, h, scale=m ** -0.5),
            r(B, Q, h, 1, scale=h ** -0.5), r(B, Q, m, scale=0.1), r(B, Q, h, scale=0.1),
            r(B, Q, 3), r(B, Q, 3).abs(), r(B, S, m), r(B, S, 3), r(B, S, 3).abs(),
            (torch.rand(B, S, generator=g) > 0.2).to(device))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_wrappers_take_plain_versions_for_cpu_tensors():
    grid = _grid("cpu")
    nbr = subm_neighbor_table(grid)
    g = torch.Generator().manual_seed(0)
    feats = torch.randn(CAP, 6, generator=g)
    w = torch.randn(27, 6, 32, generator=g)
    xyz = torch.randn(2, 300, 3, generator=g)
    valid = torch.rand(2, 300, generator=g) > 0.3
    dout = torch.randn(CAP, 32, generator=g)
    w_rev = w.flip(0).transpose(1, 2).contiguous()
    counts = lambda: (conv.subm_conv_cuda.launches, conv.subm_conv_dfeats_cuda.launches,
                      conv.subm_conv_dw_cuda.launches, fps_ops.fps_cuda.launches,
                      dyco.dyco_cuda.launches)
    before = counts()
    assert torch.equal(conv.subm_conv_cuda(feats, nbr, w, grid.valid),
                       conv.subm_conv(feats, nbr, w, grid.valid))
    assert torch.equal(conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, grid.valid),
                       conv.subm_conv(dout, nbr, w_rev, grid.valid))
    assert torch.equal(conv.subm_conv_dw_cuda(feats, nbr, dout), conv.subm_conv_dw(feats, nbr, dout))
    got, want = fps_ops.fps(xyz, valid, 32), fps_ops.fps_masked(xyz, valid, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    dargs = _dyco_args(torch.device("cpu"), 2, 3, 50)
    assert torch.equal(dyco.dyco_cuda(*dargs), dyco.dyco_mlp_plain(*dargs))
    assert counts() == before


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(6, 32), (64, 32), (96, 64)])
def test_subm_conv_cuda_matches_plain(cuda_device, cin, cout):
    """K1 against the plain version on the same inputs (fp32; rtol = atol =
    1e-4 for another summation order); rows outside ``valid`` are exactly 0."""
    grid = _grid(cuda_device)
    nbr = subm_neighbor_table(grid)
    g = torch.Generator().manual_seed(cin)
    feats = torch.randn(CAP, cin, generator=g).to(cuda_device)
    w = torch.randn(27, cin, cout, generator=g).to(cuda_device)
    before = conv.subm_conv_cuda.launches
    got = conv.subm_conv_cuda(feats, nbr, w, grid.valid)
    torch.cuda.synchronize()
    assert conv.subm_conv_cuda.launches == before + 1
    want = conv.subm_conv(feats, nbr, w, grid.valid)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (got[~grid.valid] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(6, 32), (32, 32), (96, 64), (384, 192)])
def test_subm_conv_dw_cuda_matches_plain(cuda_device, cin, cout):
    """The dW kernel against the plain per-offset version (fp32; rtol =
    atol = 1e-4 of the output's scale, another summation order over up to
    V rows), bit-identical across two launches; and the backward of
    ``SubmConvFn`` on the card (dfeats by K1 on the reversed weights, dW by
    the kernel) against autograd of the plain forward."""
    grid = _grid(cuda_device)
    nbr = subm_neighbor_table(grid)
    g = torch.Generator().manual_seed(cin + cout)
    feats = (torch.randn(CAP, cin, generator=g).to(cuda_device) * grid.valid[:, None]).contiguous()
    dout = (torch.randn(CAP, cout, generator=g).to(cuda_device) * grid.valid[:, None]).contiguous()
    before = conv.subm_conv_dw_cuda.launches
    got = conv.subm_conv_dw_cuda(feats, nbr, dout)
    again = conv.subm_conv_dw_cuda(feats, nbr, dout)
    torch.cuda.synchronize()
    assert conv.subm_conv_dw_cuda.launches == before + 2
    want = conv.subm_conv_dw(feats, nbr, dout)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(got, again)

    w = torch.randn(27, cin, cout, generator=g).to(cuda_device)
    tf, tw = feats.clone().requires_grad_(), w.clone().requires_grad_()
    (conv.SubmConvFn.apply(tf, tw, nbr, grid.valid) * dout).sum().backward()
    pf, pw = feats.clone().requires_grad_(), w.clone().requires_grad_()
    (conv.subm_conv(pf, nbr, pw, grid.valid) * dout).sum().backward()
    for a, b in ((tf.grad, pf.grad), (tw.grad, pw.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    assert (tf.grad[~grid.valid] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(2048, 192), (40000, 256)])
def test_fps_cuda_matches_plain(cuda_device, n, k):
    """K4's indices equal the plain version's, bit for bit."""
    g = torch.Generator().manual_seed(n)
    xyz = torch.randn(2, n, 3, generator=g).to(cuda_device)
    valid = (torch.rand(2, n, generator=g) > 0.2).to(cuda_device)
    before = fps_ops.fps_cuda.launches
    got = fps_ops.fps_cuda(xyz, valid, k)
    torch.cuda.synchronize()
    assert fps_ops.fps_cuda.launches == before + 1
    want = fps_ops.fps_masked(xyz, valid, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_segment_mean_is_deterministic_on_card(cuda_device):
    """Superpoint pooling sums each segment in one fixed order on the card:
    two calls on the same inputs agree bit for bit."""
    g = torch.Generator().manual_seed(5)
    data = torch.randn(200000, 32, generator=g).to(cuda_device)
    seg = torch.randint(-1, 300, (200000,), generator=g).to(cuda_device)
    a, b = segment_mean(data, seg, 256), segment_mean(data, seg, 256)
    assert torch.equal(a, b)
    torch.testing.assert_close(a.cpu(), segment_mean(data.cpu(), seg.cpu(), 256),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Q,S", [(4, 256, 4096), (1, 12, 130)])
def test_dyco_cuda_matches_plain(cuda_device, B, Q, S):
    """K5 against the plain einsum version with TF32 off (rtol 2e-5, atol
    2e-4: another summation order); invalid superpoints are exactly -1e4;
    and the gradients of ``DycoFn`` on the card (the plain recompute)
    against ``torch.autograd.grad`` of the plain version: the same
    operations on the same inputs, within 1e-5 of each gradient's scale in
    case a reduction on the card orders its sum by timing."""
    args = _dyco_args(cuda_device, B, Q, S, seed=Q)
    before = dyco.dyco_cuda.launches
    got = dyco.dyco_cuda(*args)
    torch.cuda.synchronize()
    assert dyco.dyco_cuda.launches == before + 1
    want = dyco.dyco_mlp_plain(*args)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-4)
    assert (got.transpose(1, 2)[~args[-1]] == -1e4).all()

    xs = [a.clone().requires_grad_() for a in args[:-1]]
    ys = [a.clone().requires_grad_() for a in args[:-1]]
    ct = torch.randn(got.shape, device=cuda_device)
    gk = torch.autograd.grad(dyco.DycoFn.apply(*xs, args[-1]), xs, ct)
    gp = torch.autograd.grad(dyco.dyco_mlp_plain(*ys, args[-1]), ys, ct)
    for a, b in zip(gk, gp):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(b.abs().max()))
