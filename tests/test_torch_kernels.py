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
                      conv.subm_conv_dw_cuda.launches, fps_ops.fps_cuda.launches)
    before = counts()
    assert torch.equal(conv.subm_conv_cuda(feats, nbr, w, grid.valid),
                       conv.subm_conv(feats, nbr, w, grid.valid))
    assert torch.equal(conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, grid.valid),
                       conv.subm_conv(dout, nbr, w_rev, grid.valid))
    assert torch.equal(conv.subm_conv_dw_cuda(feats, nbr, dout), conv.subm_conv_dw(feats, nbr, dout))
    got, want = fps_ops.fps(xyz, valid, 32), fps_ops.fps_masked(xyz, valid, 32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
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
