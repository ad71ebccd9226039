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

from gapro_tpu_torch import data as port_data
from gapro_tpu_torch.core.segment import segment_mean
from gapro_tpu_torch.models import dyco, prepare
from gapro_tpu_torch.ops import fps as fps_ops
from gapro_tpu_torch.ops.voxelize import voxelize
from gapro_tpu_torch.sparse import conv
from gapro_tpu_torch.sparse.plan import TILE_ROWS, ConvTables, subm_neighbor_table
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
    tables = ConvTables(nbr, grid.valid)
    assert torch.equal(conv.subm_conv_cuda(feats, nbr, w, grid.valid, tables),
                       conv.subm_conv(feats, nbr, w, grid.valid))
    assert torch.equal(conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, grid.valid, tables),
                       conv.subm_conv(dout, nbr, w_rev, grid.valid))
    assert torch.equal(conv.subm_conv_dw_cuda(feats, nbr, dout, tables),
                       conv.subm_conv_dw(feats, nbr, dout))
    assert tables._rows is None and tables._pairs is None  # the plain versions read no table
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
    got = conv.subm_conv_cuda(feats, nbr, w, grid.valid, ConvTables(nbr, grid.valid))
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
    tables = ConvTables(nbr, grid.valid)
    got = conv.subm_conv_dw_cuda(feats, nbr, dout, tables)
    again = conv.subm_conv_dw_cuda(feats, nbr, dout, tables)
    torch.cuda.synchronize()
    assert conv.subm_conv_dw_cuda.launches == before + 2
    want = conv.subm_conv_dw(feats, nbr, dout)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(got, again)

    w = torch.randn(27, cin, cout, generator=g).to(cuda_device)
    tf, tw = feats.clone().requires_grad_(), w.clone().requires_grad_()
    (conv.SubmConvFn.apply(tf, tw, nbr, grid.valid, tables) * dout).sum().backward()
    pf, pw = feats.clone().requires_grad_(), w.clone().requires_grad_()
    (conv.subm_conv(pf, nbr, pw, grid.valid) * dout).sum().backward()
    for a, b in ((tf.grad, pf.grad), (tw.grad, pw.grad)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
    assert (tf.grad[~grid.valid] == 0).all()


@pytest.fixture(scope="module")
def batch2_plan():
    """The U-Net plan (two levels) of two synthetic scenes in one batch,
    prepared on the card: 21,000 points each at the bench's voxel scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    scenes = []
    for seed in (0, 1):
        s = port_data.make_synthetic_scene(seed=seed, n_objects=4, points_per_object=3000,
                                           n_floor=6000, n_wall=3000)
        scenes.append(dict(xyz=s.xyz, rgb=s.rgb, spp=s.spp))
    pb = prepare.points_to_batch_np(scenes, voxel_scale=50, n_cap=65536)
    return prepare.prepare_voxel_batch(prepare.upload_point_batch(pb, "cuda"), 65536, 2, 2, 1024,
                                       0.67).batch.plan


@pytest.mark.gpu
@pytest.mark.parametrize("lvl,cin,cout", [(0, 6, 32), (0, 32, 32), (1, 64, 64), (1, 96, 96),
                                          (1, 384, 192)])
def test_conv_kernels_on_a_batch2_plan(cuda_device, batch2_plan, lvl, cin, cout):
    """K1, dfeats and dW on the level's own tables (mask-sorted rows, so that
    tiles hold rows of both scenes; the pair lists) at the model's widths,
    the stem padded from 6 to 8 columns: K1 and dfeats within 1e-4 of the
    plain version's scale, invalid rows exactly 0, and equal bit for bit to
    a launch on tables built anew; dW within ``dw_rtol`` of
    ``chip_smoke.py`` (8 x 2^-23 sqrt(V), at least 1e-4, of the scale) and
    bit-identical across two launches."""
    lp = batch2_plan.levels[lvl]
    nbr, valid = lp.subm_nbr, lp.grid.valid
    v = nbr.shape[0]
    order, _ = lp.conv.rows()
    n_valid = int(valid.sum())
    scene = lp.grid.coords[order[:n_valid].long(), 0]
    scene = torch.cat([scene, scene[-1:].expand(-n_valid % TILE_ROWS)]).view(-1, TILE_ROWS)
    assert bool(((scene == 0).any(1) & (scene == 1).any(1)).any())

    g = torch.Generator().manual_seed(cin + cout)
    feats = (torch.randn(v, cin, generator=g).to(cuda_device) * valid[:, None]).contiguous()
    dout = (torch.randn(v, cout, generator=g).to(cuda_device) * valid[:, None]).contiguous()
    bound = (3.0 / (27 * cin)) ** 0.5
    w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * bound).to(cuda_device)
    w_rev = w.flip(0).transpose(1, 2)  # as SubmConvFn passes it
    launches = lambda: (conv.subm_conv_cuda.launches, conv.subm_conv_dfeats_cuda.launches,
                        conv.subm_conv_dw_cuda.launches)
    before = launches()
    out = conv.subm_conv_cuda(feats, nbr, w, valid, tables=lp.conv)
    dfeats = conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid, tables=lp.conv)
    dw = conv.subm_conv_dw_cuda(feats, nbr, dout, tables=lp.conv)
    dw_again = conv.subm_conv_dw_cuda(feats, nbr, dout, tables=lp.conv)
    torch.cuda.synchronize()
    assert launches() == (before[0] + 1, before[1] + 1, before[2] + 2)

    for got, want in ((out, conv.subm_conv(feats, nbr, w, valid)),
                      (dfeats, conv.subm_conv(dout, nbr, w_rev, valid))):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-4 * scale
        assert (got[~valid] == 0).all()
    fresh = ConvTables(nbr, valid)
    assert torch.equal(out, conv.subm_conv_cuda(feats, nbr, w, valid, fresh))
    assert torch.equal(dfeats, conv.subm_conv_dfeats_cuda(dout, nbr, w_rev, valid, fresh))

    want = conv.subm_conv_dw(feats, nbr, dout)
    rtol = max(1e-4, 8 * 2.0 ** -23 * v ** 0.5)
    assert float((dw - want).abs().max()) <= rtol * max(1.0, float(want.abs().max()))
    assert torch.equal(dw, dw_again)


def _fps_case(case):
    """(xyz [B, N, 3], valid [B, N], n_sample) on the CPU for K4's cases."""
    g = torch.Generator().manual_seed(len(case))
    shapes = {"random_2048": (2, 2048, 192), "random_40000": (2, 40000, 256),
              "duplicates": (2, 3000, 256), "few_valid": (1, 2048, 64),
              "no_valid_item": (2, 20000, 64), "ragged_counts": (3, 40000, 128),
              "past_on_chip": (2, 300000, 24)}
    b, n, k = shapes[case]
    xyz = torch.randn(b, n, 3, generator=g)
    valid = torch.rand(b, n, generator=g) > 0.2
    if case == "duplicates":  # a 6^3 lattice, every site many times: exact ties
        xyz = torch.randint(0, 6, (b, n, 3), generator=g).float()
    elif case == "few_valid":
        valid = torch.zeros(b, n, dtype=torch.bool)
        valid[0, 700:705] = True
    elif case == "no_valid_item":
        valid[1] = False
    elif case == "ragged_counts":
        valid[1, 600:] = False
        valid[2] = False
        valid[2, 39990:] = True
    elif case == "past_on_chip":  # item 0 holds more than the 262144 points on chip
        valid[0] = torch.rand(n, generator=g) > 0.03
        valid[1, 100000:] = False
    return xyz, valid, k


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random_2048", "random_40000", "duplicates", "few_valid",
                                  "no_valid_item", "ragged_counts", "past_on_chip"])
def test_fps_cuda_matches_plain(cuda_device, case):
    """K4's indices equal the plain version's, bit for bit."""
    xyz, valid, k = (a.to(cuda_device) if isinstance(a, torch.Tensor) else a
                     for a in _fps_case(case))
    if case == "past_on_chip":
        assert int(valid[0].sum()) > fps_ops.launch_shape(xyz.shape[1])["on_chip"]
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


def _dyco_check(got, args):
    """K5's logits against the plain version (rtol 2e-5, atol 2e-4),
    invalid superpoints exactly -1e4."""
    torch.testing.assert_close(got, dyco.dyco_mlp_plain(*args), rtol=2e-5, atol=2e-4)
    assert (got.transpose(1, 2)[~args[-1]] == -1e4).all()


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 16, 32])
def test_dyco_cuda_widths(cuda_device, m):
    """K5 at each mask width the kernel is built for (M = 8 pads layer 1's
    H = 4 columns to wgmma's 8), on a shape that spans two superpoint
    blocks and several query groups; two launches bit-identical."""
    args = _dyco_args(cuda_device, 2, 40, 700, m=m, seed=m)
    got, again = dyco.dyco_cuda(*args), dyco.dyco_cuda(*args)
    torch.cuda.synchronize()
    _dyco_check(got, args)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_dyco_cuda_item_with_no_valid_superpoint(cuda_device):
    """An item whose superpoints are all invalid (as items 2 and 3 of the
    batch-4 step) gets -1e4 everywhere; the other item is unchanged by it."""
    args = list(_dyco_args(cuda_device, 2, 24, 600, seed=4))
    args[-1] = args[-1].clone()
    args[-1][1] = False
    got = dyco.dyco_cuda(*args)
    torch.cuda.synchronize()
    assert (got[1] == -1e4).all()
    _dyco_check(got, args)
    alone = dyco.dyco_cuda(*(a[:1].contiguous() for a in args))
    assert torch.equal(got[:1], alone)


@pytest.mark.gpu
def test_dyco_cuda_takes_strided_controller_views(cuda_device):
    """The weights as the model hands them: views of one controller row
    (split, then reshaped), read through their strides, equal bit for bit to
    a launch on contiguous copies."""
    b, q, s, m, h = 2, 33, 300, 32, 16
    sizes = [(m + 6) * m, m * h, h, m, h]
    g = torch.Generator().manual_seed(9)
    ctrl = (torch.randn(b, q, sum(sizes), generator=g) * 0.15).to(cuda_device)
    parts = torch.split(ctrl, sizes, dim=-1)
    weights = (parts[0].reshape(b, q, m + 6, m), parts[1].reshape(b, q, m, h),
               parts[2].reshape(b, q, h, 1), parts[3], parts[4])
    rest = _dyco_args(cuda_device, b, q, s, seed=10)[5:]
    got = dyco.dyco_cuda(*weights, *rest)
    want = dyco.dyco_cuda(*(t.contiguous() for t in weights), *rest)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    _dyco_check(got, (*weights, *rest))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 16, 32])
def test_dyco_cuda_fragment_mapping(cuda_device, m):
    """Each logit routes one entry to the output through one-hot weights, so
    a mistake in the kernel's fragment layouts (rows, columns, the permuted
    reduction of layer 1, the padded columns at M = 8, the image's bias and
    query sections) shows as a wrong value. Every (superpoint, column) has
    its own value, s + c / 64 (at most 16 significant bits, so the split
    form carries it exactly): queries 0 .. M - 1 return feature q, the next
    6 geometry column q - M (q_loc - sp_coord, |q_dim - sp_dim|, integers),
    the last M the bias b0[c] + b1[c % H]. Rows 0 .. 599 cover three
    superpoint blocks; every 7th superpoint is invalid."""
    h, s = m // 2, 600
    q = 2 * m + 6
    w0, w1, w2 = torch.zeros(1, q, m + 6, m), torch.zeros(1, q, m, h), torch.zeros(1, q, h, 1)
    b0, b1 = torch.zeros(1, q, m), torch.zeros(1, q, h)
    want = torch.zeros(1, q, s, dtype=torch.float64)
    idx = torch.arange(s, dtype=torch.float64)
    feats = idx[:, None] + torch.arange(m, dtype=torch.float64)[None] / 64
    coords = torch.stack([idx % 7, idx % 11, idx % 13], 1)
    dims = (idx % 17)[:, None].expand(s, 3)
    q_loc, q_dim = torch.tensor([100.0, 200.0, 300.0]), torch.tensor([50.0, 40.0, 30.0])
    geo = torch.cat([q_loc - coords, (q_dim - dims).abs()], 1)
    for qi in range(q):
        c = qi % m
        w1[0, qi, c, c % h] = 1.0
        w2[0, qi, c % h, 0] = 1.0
        if qi < m:
            w0[0, qi, 6 + c, c] = 1.0
            want[0, qi] = feats[:, c]
        elif qi < m + 6:
            w0[0, qi, qi - m, c] = 1.0
            want[0, qi] = geo[:, qi - m]
        else:
            b0[0, qi, c] = 1.0 + c / 8
            b1[0, qi] = torch.arange(h) / 16
            want[0, qi] = b0[0, qi, c] + b1[0, qi, c % h]
    valid = torch.arange(s) % 7 != 3
    want[:, :, ~valid] = -1e4
    args = [t.float().to(cuda_device) for t in (w0, w1, w2, b0, b1, q_loc.expand(1, q, 3),
                                                q_dim.expand(1, q, 3), feats[None], coords[None],
                                                dims[None])] + [valid[None].to(cuda_device)]
    got = dyco.dyco_cuda(*args)
    torch.cuda.synchronize()
    wrong = got.double().cpu() != want
    assert not bool(wrong.any()), (
        f"{int(wrong.sum())} logits differ, first at (query, superpoint) "
        f"{wrong[0].nonzero()[0].tolist()}: {float(got[0][wrong[0]][0])} vs "
        f"{float(want[0][wrong[0]][0])}")


@pytest.mark.gpu
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("lvl,cin,cout", [(0, 6, 32), (0, 24, 16), (0, 32, 32), (1, 64, 64),
                                          (1, 96, 96), (1, 128, 128), (1, 160, 160),
                                          (1, 384, 192)])
def test_k1_bf16_on_a_batch2_plan(cuda_device, batch2_plan, lvl, cin, cout, window):
    """K1-bf16 on the level's own tables at the model's widths (the stem
    padded from 6 to 8 columns; at 24 a k-step holds the end of one tap and
    the start of the next), in both of its functions (``window``: each tap's
    sum rounded to bf16), against its plain version on the same inputs: the
    same exact products summed in another order, within 1e-4 of the scale;
    with ``window`` an entry where an fp32 difference flipped a tap's
    rounding lies one bf16 step of that tap away, within 2^-8 of the scale,
    in at most 1% of the entries. Invalid rows exactly 0, equal bit for bit
    to a launch on tables built anew; bf16 features refused."""
    lp = batch2_plan.levels[lvl]
    nbr, valid = lp.subm_nbr, lp.grid.valid
    g = torch.Generator().manual_seed(cin + cout)
    feats = (torch.randn(nbr.shape[0], cin, generator=g).to(cuda_device)
             * valid[:, None]).contiguous()
    bound = (3.0 / (27 * cin)) ** 0.5
    w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * bound).to(cuda_device)
    before = conv.subm_conv_bf16_cuda.launches
    out = conv.subm_conv_bf16_cuda(feats, nbr, w, valid, lp.conv, window)
    again = conv.subm_conv_bf16_cuda(feats, nbr, w, valid, ConvTables(nbr, valid), window)
    torch.cuda.synchronize()
    assert conv.subm_conv_bf16_cuda.launches == before + 2
    assert torch.equal(out, again)
    want = conv.subm_conv_bf16(feats, nbr, w, valid, window)
    scale = max(1.0, float(want.abs().max()))
    diff = (out - want).abs()
    if window:
        assert float(diff.max()) <= 2.0 ** -8 * scale
        assert float((diff > 1e-4 * scale).float().mean()) <= 1e-2
    else:
        assert float(diff.max()) <= 1e-4 * scale
    assert (out[~valid] == 0).all()
    with pytest.raises(TypeError):
        conv.subm_conv_bf16_cuda(feats.bfloat16(), nbr, w, valid, lp.conv, window)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("cin,cout", [(32, 32), (96, 96), (128, 128), (160, 160), (224, 224),
                                      (40, 24), (40, 96)])
def test_k1_bf16_split_over_a_cluster(cuda_device, cin, cout, window):
    """K1-bf16 on a grid of 1,024 rows, where the schedule splits each
    tile's reduction over a cluster (the partials added through distributed
    shared memory in split order), at each tile width, in both functions:
    against its plain version as on the batch-2 plan, invalid rows exactly
    0, two launches equal bit for bit. At 40 -> 24 and 40 -> 96 (K = 40, an
    odd multiple of 8) a k-step spans the end of one tap and the start of
    the next, in the unpaired and the paired form; at 224 with round_taps
    the Cout takes two column tiles."""
    grid = _grid(cuda_device)
    nbr, valid = subm_neighbor_table(grid), grid.valid
    sched = conv.k1_bf16_schedule(CAP, -(-cin // 8) * 8, cout,
                                  torch.cuda.get_device_properties(0).multi_processor_count,
                                  window)
    assert sched.splits > 1
    g = torch.Generator().manual_seed(cin + cout)
    feats = (torch.randn(CAP, cin, generator=g).to(cuda_device) * valid[:, None]).contiguous()
    bound = (3.0 / (27 * cin)) ** 0.5
    w = ((torch.rand(27, cin, cout, generator=g) * 2 - 1) * bound).to(cuda_device)
    tables = ConvTables(nbr, valid)
    out = conv.subm_conv_bf16_cuda(feats, nbr, w, valid, tables, window)
    again = conv.subm_conv_bf16_cuda(feats, nbr, w, valid, tables, window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    want = conv.subm_conv_bf16(feats, nbr, w, valid, window)
    scale = max(1.0, float(want.abs().max()))
    diff = (out - want).abs()
    if window:
        assert float(diff.max()) <= 2.0 ** -8 * scale
        assert float((diff > 1e-4 * scale).float().mean()) <= 1e-2
    else:
        assert float(diff.max()) <= 1e-4 * scale
    assert (out[~valid] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [False, True])
def test_bf16_mode_conv_on_the_card(cuda_device, monkeypatch, window):
    """Under ``GAPRO_CONV_DTYPE=bf16`` ``SubmConvFn`` takes its forward from
    K1-bf16 (never the fp32 K1) and its backward by the level: the fp32
    kernels (dfeats by K1, dW) on a window level; on another, autograd of
    the plain bf16 conv, within one bf16 step of the scale of it (its
    gradient rows are added in bf16, on the card in another order)."""
    monkeypatch.setenv("GAPRO_CONV_DTYPE", "bf16")
    grid = _grid(cuda_device)
    nbr = subm_neighbor_table(grid)
    g = torch.Generator().manual_seed(5)
    feats = (torch.randn(CAP, 32, generator=g).to(cuda_device) * grid.valid[:, None]).contiguous()
    w = (torch.randn(27, 32, 16, generator=g) / 16).to(cuda_device)
    dout = torch.randn(CAP, 16, generator=g).to(cuda_device)
    counts = lambda: (conv.subm_conv_cuda.launches, conv.subm_conv_bf16_cuda.launches,
                      conv.subm_conv_dfeats_cuda.launches, conv.subm_conv_dw_cuda.launches)
    before = counts()
    tf, tw = feats.clone().requires_grad_(), w.clone().requires_grad_()
    out = conv.SubmConvFn.apply(tf, tw, nbr, grid.valid, ConvTables(nbr, grid.valid), window)
    (out * dout).sum().backward()
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(counts(), before))
    assert moved == ((0, 1, 1, 1) if window else (0, 1, 0, 0))
    if not window:
        pf, pw = feats.clone().requires_grad_(), w.clone().requires_grad_()
        (conv.subm_conv(pf, nbr, pw, grid.valid, torch.bfloat16) * dout).sum().backward()
        for a, b in ((tf.grad, pf.grad), (tw.grad, pw.grad)):
            assert float((a - b).abs().max()) <= 2.0 ** -8 * float(b.abs().max())
