"""Sparse convolutions (``gapro_tpu/sparse/conv.py``).

* ``compute_dtype``: the convs' operand type, ``GAPRO_CONV_DTYPE`` read on
  every call as the JAX package's ``_compute_dtype`` reads it: bfloat16
  for ``bf16`` (the reference's AMP analog), float32 otherwise. In bf16
  every conv rounds its features and weights to bf16 (to nearest even, as
  XLA's convert) and sums the exact products in fp32; the output is fp32.
  A subm conv on a level with window tables on the TPU (``LevelPlan.window``)
  also rounds each tap's sum to bf16, as the TPU's window kernel does.
* ``subm_conv``: the 3x3x3 submanifold conv as one zero-sentinel gather
  plus one matmul. It is the plain PyTorch version of kernel K1,
  ``csrc/subm_conv.cu``; ``subm_conv_bf16`` that of K1-bf16,
  ``csrc/subm_conv_bf16.cu``.
* ``subm_conv_cuda``: K1's wrapper. For a CPU tensor it takes ``subm_conv``;
  for a CUDA tensor it launches the kernel or raises. It counts its launches
  in ``subm_conv_cuda.launches``. ``subm_conv_bf16_cuda`` is K1-bf16's, the
  forward of every subm conv in bf16.
* ``SubmConvFn``: the conv as a ``torch.autograd.Function`` whose backward
  mirrors ``_window_conv_bwd`` (``gapro_tpu/sparse/window_conv.py``), the
  TPU's backward kernels K2 and K3, with the incoming gradient masked to
  valid rows:

  - ``dfeats = subm_conv(dout, nbr, w_rev)`` with ``w_rev[k] = W[26 - k]^T``
    (``nbr[i, k] = j`` exactly when ``nbr[j, 26 - k] = i``). On the card
    this is K1 again, through ``subm_conv_dfeats_cuda``;
  - ``dW[k] = sum_i feats[nbr[i, k]]^T dout[i]``: ``subm_conv_dw`` plain,
    ``subm_conv_dw_cuda`` the kernel ``csrc/subm_conv_dw.cu``.

  It saves only ``feats``, ``weights``, the table and ``valid``, never the
  [V, 27 * Cin] gather. In bf16 the forward is K1-bf16; a level with
  window tables on the TPU (``LevelPlan.window``) keeps this fp32
  backward, as ``_window_conv_bwd`` casts dout to the saved fp32 input's
  type; another level takes autograd of the plain bf16 conv, which
  rounds where XLA's transpose of the JAX package's gather-GEMM rounds
  (the table's gradient rows in bf16, added in bf16; dW rounded to bf16).
* ``down_conv`` / ``inverse_conv``: the stride-2 kernel-2 pair sharing one
  rulebook. The JAX package computes them outside any Pallas kernel, and so
  does the port, in bf16 as ``subm_conv``'s plain version does.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
import os
from dataclasses import dataclass

import torch

from .. import cuda_build

# A missing entry (-1) reads one of this many zero rows appended to the
# table. Autograd's backward of a row gather adds each entry's gradient into
# the row it read, and on the card the entries of one row are added one
# after another: one shared zero row would serialise every missing entry
# (most of the [Vc, 8] child table, a fifth of the voxel capacity).
_ZERO_ROWS = 1024


def _zero_padded(feats):
    return torch.cat([feats, feats.new_zeros((_ZERO_ROWS, feats.shape[1]))], 0)


def _padded_index(idx, v: int):
    spread = torch.arange(idx.numel(), device=idx.device).reshape(idx.shape) % _ZERO_ROWS
    return torch.where(idx >= 0, idx.long(), v + spread)


def gather_rows(feats, idx):
    """feats [V, C], int idx [...] (-1 missing) -> [..., C], zeros for -1."""
    return _zero_padded(feats)[_padded_index(idx, feats.shape[0])]


def compute_dtype() -> torch.dtype:
    """torch.bfloat16 where ``GAPRO_CONV_DTYPE`` is ``bf16``, else
    torch.float32 (``gapro_tpu/sparse/conv.py:_compute_dtype``)."""
    return torch.bfloat16 if os.environ.get("GAPRO_CONV_DTYPE") == "bf16" else torch.float32


def _operands(feats, idx, weights, dtype):
    """The gathered rows ``feats[idx]`` and the weights as a conv multiplies
    them. In bf16 both are rounded to bf16 and held in ``feats``' type,
    where their products are exact: the JAX package's bf16 dot with an fp32
    result. The rows are gathered from the bf16 table, so that autograd
    adds their gradients in bf16, as XLA's transpose of the gather does."""
    if dtype == torch.float32:
        return gather_rows(feats, idx), weights
    return gather_rows(feats.to(dtype), idx).to(feats.dtype), weights.to(dtype).to(feats.dtype)


def subm_conv(feats, nbr_idx, weights, valid, dtype=None):
    """Plain version of K1 (fp32) and of K1-bf16.

    feats [V, Cin], nbr_idx [V, 27] int (-1 missing), weights [27, Cin,
    Cout], valid [V] bool -> [V, Cout]; invalid rows are 0. ``dtype`` is
    the operands' type, ``compute_dtype()`` if None.
    """
    v, cin = feats.shape
    k, _, cout = weights.shape
    g, w = _operands(feats, nbr_idx, weights, compute_dtype() if dtype is None else dtype)
    out = g.reshape(v, k * cin) @ w.reshape(k * cin, cout)
    return torch.where(valid[:, None], out, 0.0)


def subm_conv_bf16(feats, nbr_idx, weights, valid, window: bool):
    """Plain version of K1-bf16: the function the JAX package computes on a
    level in bf16. Without window tables, its XLA gather-GEMM's
    (``subm_conv`` in bf16). With them, its TPU kernel's
    (``window_conv.py:_fwd_kernel``), whose one-hot gather takes each tap's
    sum over the channels cast to the bf16 table's type: each tap
    ``x[nbr[i, k]] @ W[k]``, of the bf16 operands, rounded to bf16, the taps
    added in k order."""
    if not window:
        return subm_conv(feats, nbr_idx, weights, valid, torch.bfloat16)
    table = _zero_padded(feats.to(torch.bfloat16)).to(feats.dtype)
    idx = _padded_index(nbr_idx, feats.shape[0])
    w = weights.to(torch.bfloat16).to(feats.dtype)
    out = None
    for k in range(nbr_idx.shape[1]):
        tap = (table[idx[:, k]] @ w[k]).to(torch.bfloat16).to(feats.dtype)
        out = tap if out is None else out + tap
    return torch.where(valid[:, None], out, 0.0)


def subm_conv_dw(feats, nbr_idx, dout):
    """Plain version of the dW kernel: ``dW[k] = sum_i feats[nbr[i, k]]^T
    dout[i]`` -> [27, Cin, Cout]. One offset at a time, so that only one
    [V, Cin] gather is held."""
    table, idx = _zero_padded(feats), _padded_index(nbr_idx, feats.shape[0])
    return torch.stack([table[idx[:, k]].T @ dout for k in range(nbr_idx.shape[1])])


def _check_args(named, like, nbr_idx, valid=None):
    """Raise unless every tensor in ``named`` is fp32, the table int32 and
    ``valid`` bool, all contiguous on ``like``'s device, with V rows."""
    v = like.shape[0]
    if nbr_idx.shape != (v, 27) or (valid is not None and valid.shape != (v,)):
        raise ValueError(f"nbr_idx must be [{v}, 27] and valid [{v}], got "
                         f"{tuple(nbr_idx.shape)} and "
                         f"{None if valid is None else tuple(valid.shape)}")
    checks = [(name, t, torch.float32) for name, t in named]
    checks.append(("nbr_idx", nbr_idx, torch.int32))
    if valid is not None:
        checks.append(("valid", valid, torch.bool))
    for name, t, dt in checks:
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != like.device:
            raise ValueError(f"{name} is on {t.device}, not on {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_cuda_args(feats, nbr_idx, weights, valid):
    cin = feats.shape[1]
    if weights.dim() != 3 or weights.shape[:2] != (27, cin):
        raise ValueError(f"weights must be [27, {cin}, Cout], got {tuple(weights.shape)}")
    _check_args((("feats", feats), ("weights", weights)), feats, nbr_idx, valid)


def _pad8(x, dim: int):
    """``x`` with zeros appended along ``dim`` up to a multiple of 8 columns:
    the kernels take rows of whole 16-byte pieces and TF32's k of 8."""
    pad = (-x.shape[dim]) % 8
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def subm_conv_cuda(feats, nbr_idx, weights, valid, tables):
    """K1: ``subm_conv`` as a hand-written CUDA kernel (3xTF32 on the tensor
    cores). ``tables`` is the level's ``ConvTables`` (``sparse/plan.py``),
    built from ``nbr_idx`` and ``valid``; it gives the row order and tile
    masks. The plain version reads no table."""
    if feats.device.type == "cpu":
        return subm_conv(feats, nbr_idx, weights, valid, torch.float32)
    _check_cuda_args(feats, nbr_idx, weights, valid)
    out = _launch_k1(feats, nbr_idx, weights.transpose(1, 2), valid, tables)
    subm_conv_cuda.launches += 1
    return out


subm_conv_cuda.launches = 0


def subm_conv_bf16_cuda(feats, nbr_idx, weights, valid, tables, window: bool):
    """K1-bf16 (``csrc/subm_conv_bf16.cu``, bf16 on the tensor cores):
    ``subm_conv_bf16`` (``window``: the level's ``LevelPlan.window``). Takes
    fp32 features and weights, as ``subm_conv_cuda`` does, and rounds them
    to bf16 itself. Counts its launches in ``subm_conv_bf16_cuda.launches``."""
    if feats.device.type == "cpu":
        return subm_conv_bf16(feats, nbr_idx, weights, valid, window)
    _check_cuda_args(feats, nbr_idx, weights, valid)
    out = _launch_k1_bf16(feats, nbr_idx, weights.transpose(1, 2), valid, tables, window)
    subm_conv_bf16_cuda.launches += 1
    return out


subm_conv_bf16_cuda.launches = 0


def subm_conv_dfeats_cuda(dout, nbr_idx, w_rev, valid, tables):
    """The dfeats half of the backward: K1 on (dout, nbr, w_rev), counted in
    ``subm_conv_dfeats_cuda.launches`` apart from the forward's launches.
    ``w_rev[k] = W[26 - k]^T``; the kernel reads its transpose, ``W[26 - k]``,
    which is K-major for this product."""
    if dout.device.type == "cpu":
        return subm_conv(dout, nbr_idx, w_rev, valid, torch.float32)
    if w_rev.dim() != 3 or w_rev.shape[:2] != (27, dout.shape[1]):
        raise ValueError(f"w_rev must be [27, {dout.shape[1]}, Cin], got {tuple(w_rev.shape)}")
    _check_args((("dout", dout),), dout, nbr_idx, valid)
    out = _launch_k1(dout, nbr_idx, w_rev.transpose(1, 2), valid, tables)
    subm_conv_dfeats_cuda.launches += 1
    return out


subm_conv_dfeats_cuda.launches = 0


def _launch_k1(a, nbr_idx, b, valid, tables):
    """out [V, N] = K1 over a [V, K] and b [27, N, K], a view read through
    its strides (so W and its transpose need no copy)."""
    if b.dtype != torch.float32 or b.device != a.device:
        raise TypeError(f"weights must be float32 on {a.device}")
    order, masks = tables.rows()
    v, n, k_real = a.shape[0], b.shape[1], b.shape[2]
    a = _pad8(a, 1).contiguous()
    k = a.shape[1]
    lib = cuda_build.load("subm_conv")
    lib.gapro_subm_conv_splits.argtypes = [ctypes.c_int] * 3
    lib.gapro_subm_conv_splits.restype = ctypes.c_int
    lib.gapro_subm_conv_b_floats.argtypes = [ctypes.c_int] * 2
    lib.gapro_subm_conv_b_floats.restype = ctypes.c_longlong
    fn = lib.gapro_subm_conv_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        splits = lib.gapro_subm_conv_splits(v, k, n)
        if splits < 1:
            raise RuntimeError("subm_conv_cuda: the device query failed")
        out = torch.empty((v, n), dtype=torch.float32, device=a.device)
        # per-split partial sums of the deep levels (see csrc/subm_conv.cu)
        partial = (torch.empty((splits, v, n), dtype=torch.float32, device=a.device)
                   if splits > 1 else None)
        bt = torch.empty(lib.gapro_subm_conv_b_floats(k, n), dtype=torch.float32,
                         device=a.device)
        err = fn(
            a.data_ptr(), nbr_idx.data_ptr(), b.data_ptr(), *b.stride(), k_real,
            valid.data_ptr(), order.data_ptr(), masks.data_ptr(), out.data_ptr(),
            0 if partial is None else partial.data_ptr(), bt.data_ptr(), v, k, n, splits,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "subm_conv_cuda")
    return out


# K1-bf16's schedule (csrc/subm_conv_bf16.cu). A block is two warpgroups:
# with wgn 1 each takes its own 64 rows by bn columns, with wgn 2 both take
# the same 64 rows side by side on 2 bn columns. A paired tile takes the
# k-steps of a chunk in turn on two accumulators, with a ring of stages; an
# unpaired one a wait after each k-step, one accumulator and one stage. The
# reduction over the flattened (offset, Cin) axis runs in chunks of
# K1_BF16_CHUNK columns; the chunks of a tile may be split over the blocks
# of a cluster (at most K1_BF16_MAX_SPLITS), each split whole taps, until
# the grid holds about K1_BF16_BLOCKS_PER_SM blocks an SM, keeping at least
# K1_BF16_MIN_CHUNKS chunks a split.
K1_BF16_CHUNK = 64
K1_BF16_MAX_SPLITS = 8
K1_BF16_BLOCKS_PER_SM = 4
K1_BF16_MIN_CHUNKS = 2
K1_BF16_MAX_STAGES = 3
# The instantiated tiles, (wgn, bn, round_taps, paired):
# csrc/subm_conv_bf16.cu:launcher.
K1_BF16_TILES = frozenset(
    [(1, 32, True, False), (1, 32, False, False), (1, 64, True, False), (1, 64, False, True)]
    + [(2, bn, r, True) for bn in (48, 64, 80, 96, 112) for r in (False, True)
       if (bn, r) != (112, True)])
K1_BF16_SHARED = 233472  # an SM's shared memory, 1 KB of it a block's


@dataclass(frozen=True)
class K1Bf16Schedule:
    bn: int  # columns a warpgroup: the wgmma's N
    wgn: int  # warpgroups side by side on the columns
    paired: bool  # two accumulators in turn, a ring of stages
    splits: int  # blocks (a cluster) a tile's reduction is split over
    chunks_per_split: int
    n_chunks: int
    round_taps: bool

    @property
    def rows(self) -> int:
        return 128 // self.wgn

    @property
    def cols(self) -> int:
        return self.bn * self.wgn

    @property
    def regs(self) -> int:
        return k1_bf16_regs(self.bn, self.round_taps, self.paired)

    @property
    def blocks(self) -> int:
        """The blocks an SM a paired tile asks for (the launch bound)."""
        return 2 if self.paired and self.regs <= 128 else 1

    def _bytes(self, stages: int) -> int:
        stage = self.cols * 128 + self.rows * 36 * 4
        red = self.rows * self.cols * 4
        return max(stages * stage + self.rows * 27 * 4, red) + self.rows * 4 + 1024

    @property
    def stages(self) -> int:
        """The shared-memory stages: up to K1_BF16_MAX_STAGES where paired,
        as many as let ``blocks`` blocks share an SM; else 1."""
        if not self.paired:
            return 1
        s = K1_BF16_MAX_STAGES
        while s > 1 and self.blocks * (self._bytes(s) + 1024) > K1_BF16_SHARED:
            s -= 1
        return s

    @property
    def shared_bytes(self) -> int:
        """The dynamic shared memory a block takes."""
        return self._bytes(self.stages)

    def split_chunks(self, z: int) -> range:
        """The chunks split ``z`` takes."""
        lo = z * self.chunks_per_split
        return range(lo, min(self.n_chunks, lo + self.chunks_per_split))


def k1_bf16_regs(bn: int, round_taps: bool, paired: bool) -> int:
    """The registers a thread of K1-bf16 needs, estimated: the k-step
    accumulators (two where paired), the running sum and with
    ``round_taps`` the tap's sum, bn / 2 each, and about 32 more."""
    return ((2 if paired else 1) + (2 if round_taps else 1)) * bn // 2 + 32


def _ceil8(x: int) -> int:
    return -(-x // 8) * 8


@functools.lru_cache(maxsize=4096)
def k1_bf16_schedule(v: int, k: int, n: int, sms: int, round_taps: bool) -> K1Bf16Schedule:
    """K1-bf16's tile and split for V rows, K (padded) input and N output
    channels on a card of ``sms`` SMs (measured on the H100, PERF.md §6):
    - Cout up to 32, or up to 64 with ``round_taps``: two 64-row tiles by
      the Cout, unpaired, the fewest registers and the most blocks an SM;
    - Cout up to 64 otherwise: the same tile, paired;
    - wider: one 64-row tile by 2 bn columns, paired, bn the narrowest
      instantiated width that covers the Cout within 255 registers, in as
      few column tiles as that allows, so that a block gathers each
      neighbour row once."""
    if _ceil8(n) <= 64:
        wgn, bn = 1, (32 if _ceil8(n) <= 32 else 64)
        paired = bn == 64 and not round_taps
    else:
        wgn, paired = 2, True
        widths = sorted(b for w, b, r, p in K1_BF16_TILES
                        if w == 2 and r == round_taps and k1_bf16_regs(b, r, p) <= 255)
        n_tiles = 1
        while True:
            fits = [b for b in widths if b >= _ceil8(-(-n // (2 * n_tiles)))]
            if fits:
                bn = fits[0]
                break
            n_tiles += 1
    kf = 27 * k
    n_chunks = -(-kf // K1_BF16_CHUNK)
    tiles = -(-v // (128 // wgn)) * -(-n // (bn * wgn))
    s = min(K1_BF16_MAX_SPLITS, K1_BF16_BLOCKS_PER_SM * sms // max(tiles, 1),
            n_chunks // K1_BF16_MIN_CHUNKS)
    if s <= 1:
        return K1Bf16Schedule(bn, wgn, paired, 1, n_chunks, n_chunks, round_taps)
    # splits of whole groups of taps: the chunks of lcm(chunk, K) columns
    group = k // math.gcd(K1_BF16_CHUNK, k)
    groups = -(-n_chunks // group)
    per = group * -(-groups // s)
    return K1Bf16Schedule(bn, wgn, paired, -(-n_chunks // per), per, n_chunks, round_taps)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _k1_bf16_lib():
    """K1-bf16's library, its launcher's signature set at the first call."""
    lib = cuda_build.load("subm_conv_bf16")
    if not getattr(lib, "gapro_ready", False):
        fn = lib.gapro_subm_conv_bf16_fwd
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                       + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.gapro_ready = True
    return lib


def _launch_k1_bf16(feats, nbr_idx, b, valid, tables, window):
    """out [V, N] = K1-bf16 over bf16(feats) [V, K] and b [27, N, K], fp32,
    a view read through its strides; the kernel's prologue rounds both to
    bf16 (the features padded to a multiple of 8 columns); each tap rounded
    to bf16 where ``window``."""
    order, masks = tables.rows()
    v, k_real = feats.shape
    n, k = b.shape[1], _ceil8(k_real)
    dev = feats.device
    sched = k1_bf16_schedule(v, k, n, _sm_count(dev.index), bool(window))
    lib = _k1_bf16_lib()
    a = torch.empty((v, k), dtype=torch.bfloat16, device=dev)  # the bf16 table
    out = torch.empty((v, n), dtype=torch.float32, device=dev)
    bt = torch.empty(sched.n_chunks * -(-n // sched.cols) * sched.cols * K1_BF16_CHUNK,
                     dtype=torch.bfloat16, device=dev)
    with _on_device(dev):
        err = lib.gapro_subm_conv_bf16_fwd(
            feats.data_ptr(), k_real, a.data_ptr(), nbr_idx.data_ptr(), b.data_ptr(),
            *b.stride(), bt.data_ptr(), valid.data_ptr(), order.data_ptr(), masks.data_ptr(),
            out.data_ptr(), v, k, n, sched.bn, sched.wgn, int(sched.paired), sched.splits,
            sched.chunks_per_split, int(window), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "subm_conv_bf16_cuda")
    return out


def _on_device(dev):
    """A guard making ``dev`` the current device, or nothing where it is."""
    return (contextlib.nullcontext() if dev.index == torch.cuda.current_device()
            else torch.cuda.device(dev))


def subm_conv_dw_cuda(feats, nbr_idx, dout, tables):
    """dW kernel (``csrc/subm_conv_dw.cu``, 3xTF32 on the tensor cores):
    ``subm_conv_dw`` on the card, deterministic. ``tables`` is the level's
    ``ConvTables``, built from ``nbr_idx``; it gives the pair lists. Counts
    its launches in ``subm_conv_dw_cuda.launches``."""
    if feats.device.type == "cpu":
        return subm_conv_dw(feats, nbr_idx, dout)
    _check_args((("feats", feats), ("dout", dout)), feats, nbr_idx)
    pair_i, pair_j, counts = tables.pairs()
    v, cin = feats.shape
    a, b = _pad8(feats, 1).contiguous(), _pad8(dout, 1).contiguous()
    k, n = a.shape[1], b.shape[1]
    lib = cuda_build.load("subm_conv_dw")
    lib.gapro_subm_conv_dw_splits.argtypes = [ctypes.c_int] * 3
    lib.gapro_subm_conv_dw_splits.restype = ctypes.c_int
    fn = lib.gapro_subm_conv_dw
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(feats.device):
        splits = lib.gapro_subm_conv_dw_splits(v, k, n)
        if splits < 1:
            raise RuntimeError("subm_conv_dw_cuda: the device query failed")
        dw = torch.empty((27, k, n), dtype=torch.float32, device=feats.device)
        # per-range partial dW of the levels with many rows (see csrc/subm_conv_dw.cu)
        partial = (torch.empty((splits, 27, k, n), dtype=torch.float32, device=feats.device)
                   if splits > 1 else None)
        err = fn(a.data_ptr(), b.data_ptr(), pair_i.data_ptr(), pair_j.data_ptr(),
                 counts.data_ptr(), dw.data_ptr(), 0 if partial is None else partial.data_ptr(),
                 v, k, n, splits, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "subm_conv_dw_cuda")
    subm_conv_dw_cuda.launches += 1
    return dw if (k, n) == (cin, dout.shape[1]) else dw[:, :cin, :dout.shape[1]].contiguous()


subm_conv_dw_cuda.launches = 0


class SubmConvFn(torch.autograd.Function):
    """``subm_conv`` with the backward of ``_window_conv_bwd``. The wrappers
    are looked up at call time, so a caller may swap in the plain versions.
    ``tables`` is the level's ``ConvTables``, shared by the three kernels;
    ``window`` the level's ``LevelPlan.window``, read in bf16 only."""

    @staticmethod
    def forward(ctx, feats, weights, nbr_idx, valid, tables, window=True):
        ctx.save_for_backward(feats, weights, nbr_idx, valid)
        ctx.tables = tables
        bf16 = compute_dtype() == torch.bfloat16
        ctx.plain_bf16 = bf16 and not window
        if bf16:
            return subm_conv_bf16_cuda(feats, nbr_idx, weights, valid, tables=tables,
                                       window=window)
        return subm_conv_cuda(feats, nbr_idx, weights, valid, tables=tables)

    @staticmethod
    def backward(ctx, dout):
        feats, weights, nbr_idx, valid = ctx.saved_tensors
        if ctx.plain_bf16:
            return (*_plain_bf16_grads(feats, weights, nbr_idx, valid, dout,
                                       ctx.needs_input_grad[:2]), None, None, None, None)
        dout = torch.where(valid[:, None], dout, 0.0).contiguous()
        dfeats = dw = None
        if ctx.needs_input_grad[0]:
            w_rev = weights.flip(0).transpose(1, 2)  # [27, Cout, Cin], a view of W[26 - k]
            dfeats = subm_conv_dfeats_cuda(dout, nbr_idx, w_rev, valid, tables=ctx.tables)
        if ctx.needs_input_grad[1]:
            dw = subm_conv_dw_cuda(feats, nbr_idx, dout, tables=ctx.tables)
        return dfeats, dw, None, None, None, None


def _plain_bf16_grads(feats, weights, nbr_idx, valid, dout, needs):
    """(dfeats, dW) of a level without window tables in bf16: autograd of
    the plain bf16 conv, the JAX package's ``jax.grad`` of its XLA
    ``subm_conv`` there. None where ``needs`` says no gradient."""
    with torch.enable_grad():
        f = feats.detach().requires_grad_(needs[0])
        w = weights.detach().requires_grad_(needs[1])
        out = subm_conv(f, nbr_idx, w, valid, torch.bfloat16)
        wrt = [t for t in (f, w) if t.requires_grad]
        grads = iter(torch.autograd.grad(out, wrt, dout))
    return tuple(next(grads) if need else None for need in needs)


def subm_conv_auto(feats, level_plan, weights):
    """The subm conv of one U-Net level: K1 on every level (the TPU's
    8192-capacity floor existed only for its window tables), K1-bf16 in
    bf16, with the backward of ``SubmConvFn``."""
    return SubmConvFn.apply(feats.contiguous(), weights.contiguous(), level_plan.subm_nbr,
                            level_plan.grid.valid, level_plan.conv, level_plan.window)


def down_conv(feats, child_idx, weights, out_valid=None):
    """Stride-2 kernel-2 conv: out[p] = sum_kk feats[child_idx[p, kk]] @ W[kk],
    with the operands of ``compute_dtype()``."""
    k, cin, cout = weights.shape
    vc = child_idx.shape[0]
    g, w = _operands(feats, child_idx, weights, compute_dtype())
    out = g.reshape(vc, k * cin) @ w.reshape(k * cin, cout)
    if out_valid is not None:
        out = torch.where(out_valid[:, None], out, 0.0)
    return out


def inverse_conv(coarse_feats, parent, offset_id, weights, valid):
    """Transpose of ``down_conv`` on the shared rulebook:
    fine[i] = coarse[parent(i)] @ W[offset(i)], with the operands of
    ``compute_dtype()``."""
    gathered, weights = _operands(coarse_feats, parent, weights, compute_dtype())
    out = None
    for kk in range(8):
        sel = (offset_id == kk)[:, None]
        yk = torch.where(sel, gathered, 0.0) @ weights[kk]
        out = yk if out is None else out + yk
    return torch.where(valid[:, None], out, 0.0)
