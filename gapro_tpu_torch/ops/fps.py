"""Furthest point sampling, masked, dense batch (``gapro_tpu/ops/fps.py``).

Semantics: start at the first valid point, keep each point's minimum
squared distance to the chosen set, take the argmax each step (first index
on ties). Invalid points are never chosen while a valid one remains; slots
past the number of valid points repeat the first index and are marked
invalid.

* ``fps_masked``: the plain PyTorch version of kernel K4.
* ``fps_cuda``: K4's wrapper (``csrc/fps.cu``). For a CPU tensor it takes
  ``fps_masked``; for a CUDA tensor it compacts each item's valid points
  (``compact_valid``), launches the kernel on them and maps the indices
  back, or raises. It counts its launches in ``fps_cuda.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build


def _finish(idx, valid, n_sample):
    n_valid = valid.sum(1)
    sample_valid = torch.arange(n_sample, device=valid.device)[None, :] < n_valid[:, None]
    first = valid.int().argmax(1).int()
    return torch.where(sample_valid, idx, first[:, None]), sample_valid


def fps_masked(xyz, valid, n_sample: int):
    """Plain version of K4: [B, N, 3] + [B, N] bool -> (indices [B, n_sample]
    int32, sample_valid [B, n_sample]).

    The squared distance is written as three products and two adds in this
    order, each rounded on its own, so that the kernel can match it bit for
    bit.
    """
    b = xyz.shape[0]
    rows = torch.arange(b, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    dist = torch.where(valid, torch.tensor(1e10, device=xyz.device), -1.0)
    last = valid.int().argmax(1)
    out = torch.empty((b, n_sample), dtype=torch.int32, device=xyz.device)
    for i in range(n_sample):
        out[:, i] = last
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = dx * dx + dy * dy + dz * dz
        dist = torch.where(valid, torch.minimum(dist, d), -1.0)
        last = dist.argmax(1)
    return _finish(out, valid, n_sample)


# K4's launch shape (csrc/fps.cu): a block of BLOCK_THREADS threads holds
# up to BLOCK_POINTS points on chip, a cluster up to MAX_CLUSTER blocks.
BLOCK_THREADS = 1024
BLOCK_POINTS = 16 * BLOCK_THREADS
MAX_CLUSTER = 16


def compact_valid(xyz, valid):
    """Each item's valid points moved to the front, in their order, with no
    host sync: a stable prefix sum, then a scatter. The invalid points
    follow, also in their order, so every point has a slot of its own (one
    shared slot made the scatter's writes queue on one address). Returns
    (compacted xyz [B, N, 3], its original index [B, N] int32, count [B]
    int32)."""
    b, n, _ = xyz.shape
    dev = xyz.device
    # one inclusive scan over all items, then each item's start taken off:
    # a scan along dim 1 of [4, 1048576] took 1.8 ms more on the H100
    # (PERF.md §6)
    flat = valid.reshape(-1).cumsum(0).view(b, n)
    ends = flat[:, -1:]
    start = torch.cat([ends.new_zeros(1, 1), ends[:-1]])
    pos, count = flat - start, ends - start  # the count: the last column
    idx = torch.arange(n, device=dev)
    # a valid point goes to pos - 1; an invalid one past the count, by the
    # number of invalid points before it (idx - pos)
    dest = (torch.where(valid, pos - 1, count + idx - pos)
            + torch.arange(0, b * n, n, device=dev)[:, None]).view(-1)
    table = torch.empty(b * n, dtype=torch.int32, device=dev)
    table[dest] = idx.int().repeat(b)
    cxyz = torch.empty_like(xyz).view(-1, 3)
    cxyz[dest] = xyz.reshape(-1, 3)
    return cxyz.view(b, n, 3), table.view(b, n), count[:, 0].int()


def launch_shape(n: int) -> dict:
    """K4's cluster for N points an item: enough blocks (a power of two, at
    most MAX_CLUSTER) to hold N points on chip, each block's shared memory
    sized for its share (a multiple of 4 points); ``on_chip`` points an
    item, the rest read from global memory each step."""
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * BLOCK_POINTS < n:
        cluster *= 2
    share = -(-n // cluster)
    cap = min(BLOCK_POINTS, -(-share // 4) * 4)
    return dict(cluster=cluster, cap=cap, on_chip=cluster * cap)


def _lib():
    lib = cuda_build.load("fps")
    lib.gapro_fps.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                              + [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p])
    lib.gapro_fps.restype = ctypes.c_int
    lib.gapro_fps_max_active_clusters.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.gapro_fps_max_active_clusters.restype = ctypes.c_int
    return lib


def _max_active_clusters(n: int) -> int:
    """How many of ``launch_shape(n)``'s clusters the current card runs at
    once (``cudaOccupancyMaxActiveClusters``)."""
    shape = launch_shape(n)
    out = ctypes.c_int(0)
    cuda_build.check(_lib().gapro_fps_max_active_clusters(shape["cluster"], shape["cap"],
                                                          ctypes.byref(out)),
                     "fps max_active_clusters")
    return out.value


def fps_cuda(xyz, valid, n_sample: int):
    """K4: ``fps_masked`` as one CUDA launch of one thread-block cluster per
    batch item, on the item's valid points compacted by ``compact_valid``."""
    if xyz.device.type == "cpu":
        return fps_masked(xyz, valid, n_sample)
    b, n, three = xyz.shape
    if three != 3 or valid.shape != (b, n):
        raise ValueError(f"xyz must be [B, N, 3] and valid [B, N], got "
                         f"{tuple(xyz.shape)} and {tuple(valid.shape)}")
    if xyz.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"xyz must be float32 and valid bool, got {xyz.dtype}, {valid.dtype}")
    if valid.device != xyz.device:
        raise ValueError(f"valid is on {valid.device}, xyz on {xyz.device}")
    if n == 0 or n >= 2 ** 30 or b * launch_shape(n)["cluster"] >= 2 ** 31:
        raise ValueError(f"fps_cuda takes 1 <= N < 2**30 points an item, got B={b}, N={n}")
    cxyz, table, count = compact_valid(xyz, valid)
    out = _launch_compacted(cxyz, count, n_sample)
    fps_cuda.launches += 1
    # No step past an item's count finds a distance above 0, so the kernel
    # already emits the first valid point there, as ``_finish`` would.
    return (table.gather(1, out.long()),
            torch.arange(n_sample, device=xyz.device)[None, :] < count[:, None])


def _launch_compacted(cxyz, count, n_sample: int):
    """The kernel alone, on ``compact_valid``'s points and counts (CUDA
    tensors, checked by ``fps_cuda``): compacted indices [B, n_sample]."""
    b, n, _ = cxyz.shape
    shape = launch_shape(n)
    spill = max(n - shape["on_chip"], 1)
    gdist = torch.empty((b, spill), dtype=torch.float32, device=cxyz.device)
    out = torch.empty((b, n_sample), dtype=torch.int32, device=cxyz.device)
    with torch.cuda.device(cxyz.device):
        err = _lib().gapro_fps(cxyz.data_ptr(), count.data_ptr(), b, n, n_sample,
                               shape["cluster"], shape["cap"], out.data_ptr(), gdist.data_ptr(),
                               spill, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(err, "fps_cuda")
    return out


fps_cuda.launches = 0


def fps(xyz, valid, n_sample: int):
    """Dispatching FPS used by the model: K4 on the card, the plain version
    for CPU tensors."""
    return fps_cuda(xyz, valid, n_sample)
