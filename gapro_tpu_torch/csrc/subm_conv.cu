// 3x3x3 submanifold sparse convolution, forward, fp32 (kernel K1).
//
//   out[i, :] = valid[i] ? sum_k feats[nbr[i, k], :] @ W[k] : 0
//   (a neighbour index of -1 contributes nothing)
//
// Replaces the TPU kernel gapro_tpu/sparse/window_conv.py:_fwd_kernel
// (launched by _pallas_gather_gemm, wrapped by subm_conv_window) and its
// interpret-only sibling gapro_tpu/sparse/pallas_conv.py:_kernel. Those
// exist in their windowed, one-hot form only because Mosaic cannot gather
// rows; CUDA can, so this kernel gathers neighbour rows straight from the
// [V, 27] table and keeps no windows, row packing or escapee fix-up.
//
// Bound on the H100 (level 0 of the full-width model, V = 262144, C = 32):
//   bytes: nbr table 27 * 4 * V = 28.3 MB, feats 33.5 MB, out 33.5 MB
//          -> 95 MB / 3.35 TB/s = 0.028 ms;
//   FLOPs: 2 * V * 27 * Cin * Cout = 14.5 GFLOP (every neighbour present)
//          -> 0.22 ms at 67 TFLOP/s fp32 on the CUDA cores.
// So the conv is bound by fp32 operations, not bytes, at every level
// (FLOPs/byte grows with the channel count).
//
// Design: one block computes a BM x BN tile of outputs (rows x Cout). The
// reduction runs over the flattened (offset, Cin) axis of length 27 * Cin
// in chunks of BK, so the stem's Cin = 6 wastes no work on padding. Per
// chunk the block gathers BM neighbour rows into shared memory (zero for
// -1) and stages the matching BK x BN slice of W, which is contiguous
// because W is [27 * Cin, Cout] in row-major order; W cannot stay resident
// (27 * 384 * 224 * 4 B = 9 MB at the widest conv). Each thread gathers one
// column of the chunk (one (offset, channel) pair, so one division a chunk)
// for 16 rows; the loads are scalar, as the stem's Cin = 6 rules out
// 16-byte vectors. The next chunk's loads are issued into registers before
// the current chunk's math, so their latency hides behind it. Each thread
// owns a 4 x 4 register tile. Most offsets of a 3x3x3 window are empty on a
// scanned surface (a fifth of the 27 x V pairs hold a neighbour at level 0
// of the bench scene), and 64 consecutive voxels of a floor or a wall often
// share the empty ones: a block skips every chunk whose offsets no row of
// its tile has.
//
// The deep levels have too few output tiles to fill 132 SMs (V = 256,
// Cout = 224 gives 28 blocks), so the reduction may be split over
// gridDim.z blocks per tile (gapro_subm_conv_splits picks how many). Split
// blocks write partial sums; a second kernel adds them in split order. Every
// output is summed in a fixed order with no atomics, so the result is
// deterministic. Invalid rows are written as exact zeros.
// A faster kernel (tensor cores via wgmma/TF32 or bf16, TMA) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 32;   // output channels per block (every Cout is a multiple of 32)
constexpr int BK = 32;   // reduction chunk over the flattened (offset, Cin) axis
constexpr int NT = 128;  // threads: 16 row groups x 8 column groups, 4 x 4 outputs each
constexpr int KOFF = 27;
// Row stride of the transposed A tile: a multiple of 4 keeps the float4
// reads aligned; the extra 4 spreads the transposed stores over 8 banks.
constexpr int AS = BM + 4;
constexpr int A_ROWS = BM * BK / NT;  // gathered rows per thread and chunk
constexpr int B_ROWS = BK * BN / NT;  // W rows per thread and chunk
// Split the reduction until the grid has about this many blocks per SM,
// keeping at least MIN_CHUNKS chunks of the reduction in each split.
constexpr int BLOCKS_PER_SM = 8;
constexpr int MIN_CHUNKS = 4;

__global__ void __launch_bounds__(NT)
subm_conv_fwd_kernel(const float* __restrict__ feats, const int32_t* __restrict__ nbr,
                     const float* __restrict__ w, const uint8_t* __restrict__ valid,
                     float* __restrict__ out, float* __restrict__ partial, int V, int Cin,
                     int Cout, int chunks_per_split) {
  __shared__ int32_t nbs[BM * KOFF];
  __shared__ __align__(16) float As[BK][AS];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int K = KOFF * Cin;
  const int n_chunks = (K + BK - 1) / BK;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  __shared__ int present[KOFF];  // offset k has a neighbour in some row of the tile
  if (tid < KOFF) present[tid] = 0;
  for (int e = tid; e < BM * KOFF; e += NT) {
    const int r = e / KOFF;
    nbs[e] = (row0 + r < V) ? nbr[(size_t)row0 * KOFF + e] : -1;
  }
  __syncthreads();
  for (int e = tid; e < BM * KOFF; e += NT)
    if (nbs[e] >= 0) present[e % KOFF] = 1;
  __syncthreads();

  // A chunk whose offsets have no neighbour in any row of the tile gathers
  // only zeros: skipping it leaves every sum as it was (finite weights).
  auto live = [&](int chunk) {
    const int k_hi = min(KOFF - 1, (chunk * BK + BK - 1) / Cin);
    for (int k = chunk * BK / Cin; k <= k_hi; ++k)
      if (present[k]) return true;
    return false;
  };
  auto next_live = [&](int chunk) {
    while (chunk < c_end && !live(chunk)) ++chunk;
    return chunk;
  };

  // gather roles: column a_kk of the A chunk for rows a_r0, a_r0 + 4, ...;
  // column b_n of the W chunk for its rows b_k0, b_k0 + 4, ...
  const int a_kk = tid % BK, a_r0 = tid / BK;
  const int b_n = tid % BN, b_k0 = tid / BN;
  float ra[A_ROWS], rb[B_ROWS];

  auto load = [&](int chunk) {
    const int kc = chunk * BK + a_kk;
    const bool in = kc < K;
    const int k = in ? kc / Cin : 0;
    const int c = kc - k * Cin;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int j = in ? nbs[(a_r0 + i * (NT / BK)) * KOFF + k] : -1;
      ra[i] = j >= 0 ? __ldg(&feats[(size_t)j * Cin + c]) : 0.f;
    }
    const int col = col0 + b_n;
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i) {
      const int kr = chunk * BK + b_k0 + i * (NT / BN);
      rb[i] = (kr < K && col < Cout) ? __ldg(&w[(size_t)kr * Cout + col]) : 0.f;
    }
  };

  const int tx = tid % 8;
  const int ty = tid / 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  int chunk = next_live(c_begin);
  if (chunk < c_end) load(chunk);
  while (chunk < c_end) {
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) As[a_kk][a_r0 + i * (NT / BK)] = ra[i];
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i) Bs[b_k0 + i * (NT / BN)][b_n] = rb[i];
    __syncthreads();
    const int next = next_live(chunk + 1);
    if (next < c_end) load(next);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
    chunk = next;
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= V) continue;
    const bool ok = valid[row] != 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col >= Cout) continue;
      if (split)
        partial[((size_t)blockIdx.z * V + row) * Cout + col] = acc[i][j];
      else
        out[(size_t)row * Cout + col] = ok ? acc[i][j] : 0.f;
    }
  }
}

// out[i] = valid[row] ? sum over z = 0, 1, ... of partial[z][i] : 0
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  const uint8_t* __restrict__ valid, float* __restrict__ out,
                                  int V, int Cout, int splits) {
  const size_t n = (size_t)V * Cout;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
  out[i] = valid[i / Cout] ? s : 0.f;
}

}  // namespace

// The number of blocks gapro_subm_conv_fwd splits the reduction of each
// output tile over; the caller gives it a [splits, V, Cout] fp32 scratch
// buffer when this is more than 1. Returns -1 when the device query fails.
extern "C" int gapro_subm_conv_splits(int V, int Cin, int Cout) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const long long tiles = (long long)((V + BM - 1) / BM) * ((Cout + BN - 1) / BN);
  const int n_chunks = (KOFF * Cin + BK - 1) / BK;
  long long s = tiles > 0 ? (long long)BLOCKS_PER_SM * sms / tiles : 1;
  if (s > n_chunks / MIN_CHUNKS) s = n_chunks / MIN_CHUNKS;
  return s < 1 ? 1 : static_cast<int>(s);
}

// feats [V, Cin] f32, nbr [V, 27] i32, w [27, Cin, Cout] f32, valid [V] u8,
// out [V, Cout] f32, partial [splits, V, Cout] f32 (unused when splits is
// 1); all contiguous on the current device. Returns the cudaError_t of the
// launches.
extern "C" int gapro_subm_conv_fwd(const float* feats, const int32_t* nbr, const float* w,
                                   const uint8_t* valid, float* out, float* partial, int V,
                                   int Cin, int Cout, int splits, void* stream) {
  if (V == 0) return 0;
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (KOFF * Cin + BK - 1) / BK;
  const int per_split = (n_chunks + splits - 1) / splits;
  const dim3 grid((V + BM - 1) / BM, (Cout + BN - 1) / BN, splits);
  subm_conv_fwd_kernel<<<grid, NT, 0, st>>>(feats, nbr, w, valid, out, partial, V, Cin, Cout,
                                            per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)V * Cout;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partial, valid, out, V, Cout,
                                                                 splits);
  return static_cast<int>(cudaGetLastError());
}
