// 3x3x3 submanifold sparse convolution on the tensor cores (kernel K1).
//
//   out[i, :] = valid[i] ? sum_k a[nbr[i, k], :] @ B[k]^T : 0
//   (a neighbour index of -1 contributes nothing; B is [27, N, K], K-major)
//
// The forward is a = feats [V, Cin], B[k] = W[k]^T (N = Cout, K = Cin); the
// dfeats half of the backward is a = dout [V, Cout], B[k] = W[26 - k]
// (N = Cin, K = Cout), since nbr[i, k] = j exactly when nbr[j, 26 - k] = i.
//
// Replaces the TPU kernel gapro_tpu/sparse/window_conv.py:_fwd_kernel
// (launched by _pallas_gather_gemm, wrapped by subm_conv_window), the dfeats
// half of window_conv.py:_bwd_fused_kernel, and the interpret-only sibling
// gapro_tpu/sparse/pallas_conv.py:_kernel. Those exist in their windowed,
// one-hot form only because Mosaic cannot gather rows; CUDA can, so this
// kernel gathers neighbour rows straight from the [V, 27] table.
//
// Bounds on the H100 (bench scene 0 of the full-width model; nnz is the
// (row, offset) pairs that hold a neighbour):
//   level 0, V = 262144, 32 -> 32, nnz = 1.41 M: 2.89 GFLOP, 95.8 MB moved
//     fp32 on the CUDA cores (67 TFLOP/s): 0.043 ms, bound by operations;
//     TF32 tensor cores (495 TFLOP/s):      0.0058 ms, so bytes bound it:
//     95.8 MB / 3.35 TB/s = 0.029 ms (0.0175 ms of 3xTF32 operations).
//   level 1, V = 176128, 64 -> 64, nnz = 1.70 M: 13.9 GFLOP, 110 MB moved
//     fp32: 0.208 ms; TF32: 0.028 ms of operations, 0.033 ms of bytes;
//     3xTF32 operations: 0.084 ms.
//
// Design. A block is two warpgroups (256 threads), each computing a 64-row
// tile (wgmma's M) by BN = 32 or 64 output columns. The rows are taken in
// the order `order` gives (valid rows first, stably sorted by their 27-bit
// neighbour mask; see sparse/plan.py): rows that share their empty offsets
// share a tile. The reduction runs over the flattened (offset, K) axis in
// chunks of 32 columns, so K = 8 (the stem, padded from 6) packs four
// offsets into a chunk and needs no scalar path. The block loads a chunk
// when either tile's OR-mask `tile_mask` holds one of its offsets; each
// warpgroup multiplies only the chunks its own tile needs.
//
// One stage of shared memory is filled by cp.async, 16 bytes a thread: the
// gathered A rows (a -1 neighbour zero-fills) into a [128][36] tile, and
// the B slices into two [BN][32] tiles, already split into their TF32 high
// and low parts by a prologue kernel, in the 128-byte swizzled K-major
// layout a wgmma descriptor names. Gathered rows rule out TMA's tiled
// copies. The copy of chunk c + 1 is issued once both warpgroups are done
// with chunk c; while it is in flight, the SM's other blocks (two at
// BN = 64, four at BN = 32, as the registers allow) keep its tensor cores
// busy. A second stage, filled while chunk c's products ran, was no faster
// on the H100 (PERF.md), and keeping two chunks' A fragments in registers
// to overlap them within the block was slower: more registers, fewer
// blocks an SM.
//
// Tensor cores: wgmma.m64n32k8 or m64n64k8, TF32, A from registers. wgmma
// takes 32-bit operands only K-major; here both are: a gathered A row is
// one neighbour's K channels, and the wrapper passes B as [27, N, K]. So
// this kernel runs on wgmma (the dW kernel, whose operands arrive with K as
// their rows, runs on mma.sync). TF32 keeps 10 mantissa bits, too few for
// the conv's 1e-4 tolerance, so each product is taken in the split form
// (3xTF32): x = hi + lo, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and
// a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, summed in fp32; the lo.lo term
// is below fp32's rounding. Each thread loads its own A fragment from the
// padded tile (a stride of 36 floats makes the loads conflict-free) and
// splits it in registers.
//
// The tensor cores do not round their fp32 sums to nearest: they truncate
// towards zero. A sum kept in the wgmma accumulator over the whole
// reduction (up to 2268 accumulating wgmmas, at Cin = 224) drifted towards
// zero, further from the exact sum than fp32 adds in any order, and enough
// to move a training step's gradients (PERF.md §6); a 32-column chunk's 12
// wgmmas summed there still drifted by -0.13 to -0.25 ulp along the
// output's sign, and a k-step's three by -0.03 to -0.05. So each k-step's
// three wgmmas start from a zero accumulator (a wgmma.wait_group a k-step,
// as the dW kernel and K5 have), each k-step's sum gets back the half ulp
// its truncation takes on average (untruncate), and the k-step sums are
// added in fp32 on the CUDA cores (round to nearest), in k order.
//
// The deep levels have too few tiles to fill 132 SMs, so the chunks of a
// tile may be split over gridDim.z blocks (gapro_subm_conv_splits picks
// how many); split blocks write partial sums and a second kernel adds them
// in split order. Every output is summed in a fixed order with no atomics,
// so the result is deterministic. Every row is written once; invalid rows
// as exact zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KOFF = 27;
constexpr int WG = 2;           // warpgroups per block, each with its own 64 rows
constexpr int BM = 64 * WG;     // output rows per block
constexpr int BK = 32;          // chunk of the flattened (offset, K) axis: 128 bytes
constexpr int NT = 128 * WG;
constexpr int AS = BK + 4;      // A tile row stride in floats
constexpr int A_BYTES = BM * AS * 4;
constexpr int A_ROWS = BM * 8 / NT;  // gathered rows per thread and chunk (8 pieces a row)
// Split the reduction until the grid has about this many blocks per SM,
// keeping at least MIN_CHUNKS chunks of the reduction in each split.
constexpr int BLOCKS_PER_SM = 4;
constexpr int MIN_CHUNKS = 4;

int block_cols(int N) { return N > 32 ? 64 : 32; }

template <int BN>
struct Layout {
  static constexpr int B_BYTES = BN * 256;                 // [BN][32] hi, then lo
  static constexpr int NBS = B_BYTES + A_BYTES;            // [BM][27] neighbour rows
  static constexpr int ROWS = NBS + BM * KOFF * 4;         // [BM] output rows
  static constexpr int BYTES = ROWS + BM * 4 + 1024;       // + alignment slack
};

#include "conv_common.cuh"

// Shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 32] = a[64 x 8] (registers, TF32) * b[8 x 32] (shared, TF32, K-major)
// + (keep ? d : 0)
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                      int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

// d[64 x 64] = a[64 x 8] (registers, TF32) * b[8 x 64] (shared, TF32, K-major)
// + (keep ? d : 0)
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                      int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

// The B operand, split and laid out as the main kernel's shared memory
// wants it: for chunk c and column tile t, a [BN][32] tile of the TF32
// high parts, then one of the low parts, rows 128 bytes with their 16-byte
// pieces swizzled (piece q of row n at q ^ (n % 8)). Element (n, col) is
// B[k][t * BN + n][ch] with (k, ch) = divmod(c * 32 + col, K), read through
// the strides (sk, sn, sc), and 0 past the K real columns or the N rows.
__global__ void tile_b_kernel(const float* __restrict__ b, long long sk, long long sn,
                              long long sc, uint32_t* __restrict__ bt, int K, int k_real, int N,
                              int BN, size_t n_elems) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const int col = static_cast<int>(e % BK);
  const int n = static_cast<int>((e / BK) % BN);
  const size_t tile = e / ((size_t)BK * BN);
  const int n_tiles = (N + BN - 1) / BN;
  const int c = static_cast<int>(tile / n_tiles), t = static_cast<int>(tile % n_tiles);
  const int flat = c * BK + col, k = flat / K, ch = flat - k * K, nn = t * BN + n;
  const float x = flat < KOFF * K && ch < k_real && nn < N ? b[k * sk + nn * sn + ch * sc] : 0.f;
  uint32_t hi, lo;
  split_tf32(x, hi, lo);
  uint32_t* dst = bt + tile * 2 * BN * BK + n * BK + ((((col >> 2) ^ (n & 7)) << 2) | (col & 3));
  dst[0] = hi;
  dst[BN * BK] = lo;
}

template <int BN>
__global__ void __launch_bounds__(NT)
subm_conv_kernel(const float* __restrict__ a, const int32_t* __restrict__ nbr,
                 const uint32_t* __restrict__ bt, const uint8_t* __restrict__ valid,
                 const int32_t* __restrict__ order, const int32_t* __restrict__ tile_mask,
                 float* __restrict__ out, float* __restrict__ partial, int V, int K, int N,
                 int chunks_per_split) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int32_t* nbs = reinterpret_cast<int32_t*>(smem + L::NBS);
  int32_t* rows = reinterpret_cast<int32_t*>(smem + L::ROWS);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * BM;
  const int KF = KOFF * K;
  const int n_chunks = (KF + BK - 1) / BK;
  const int c_begin = blockIdx.z * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);
  // the OR-masks of the block's two 64-row tiles: the block loads a chunk
  // either needs, each warpgroup multiplies only what its own tile needs
  const int n_masks = (V + 63) / 64;
  uint32_t mask = 0;
#pragma unroll
  for (int w = 0; w < WG; ++w) {
    const int idx = blockIdx.x * WG + w;
    mask |= idx < n_masks ? static_cast<uint32_t>(tile_mask[idx]) : 0u;
  }
  const int my_idx = blockIdx.x * WG + wg;
  const uint32_t my_mask = my_idx < n_masks ? static_cast<uint32_t>(tile_mask[my_idx]) : 0u;

  for (int r = tid; r < BM; r += NT) rows[r] = row0 + r < V ? order[row0 + r] : -1;
  __syncthreads();
  for (int e = tid; e < BM * KOFF; e += NT) {
    const int i = rows[e / KOFF];
    nbs[e] = i >= 0 ? nbr[(size_t)i * KOFF + e % KOFF] : -1;
  }
  __syncthreads();

  // the offsets chunk c reads: bits k_lo .. k_hi
  auto span = [&](int c) {
    const int k_lo = c * BK / K, k_hi = min(KOFF - 1, (c * BK + BK - 1) / K);
    return ((2u << k_hi) - 1u) & ~((1u << k_lo) - 1u);
  };
  // A chunk whose offsets no row of the tile has gathers only zeros:
  // skipping it leaves every sum as it was (finite weights).
  auto next_live = [&](int c) {
    while (c < c_end && !(mask & span(c))) ++c;
    return c;
  };

  // this thread's 16-byte piece of each gathered row, and its rows
  const int p = tid & 7, r0 = tid >> 3;
  const size_t b_tile = (size_t)2 * BN * BK;
  const uint32_t* b_src = bt + (size_t)blockIdx.y * b_tile;
  const size_t b_chunk = (size_t)gridDim.y * b_tile;
  const uint32_t b_s = smem_u32(smem), a_s = b_s + L::B_BYTES;
  auto load = [&](int c) {
    const int col = c * BK + p * 4;
    const int k = col / K, ch = col - k * K;
    const bool in = col < KF;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int r = r0 + i * (NT / 8);
      const int j = in ? nbs[r * KOFF + k] : -1;
      cp_async16(a_s + (r * AS + p * 4) * 4, a + (size_t)max(j, 0) * K + ch, j >= 0);
    }
    const uint32_t* src = b_src + c * b_chunk;
#pragma unroll
    for (int e = tid; e < BN * 8 * 2; e += NT) cp_async16(b_s + 16 * e, src + 4 * e, true);
  };

  float acc[BN / 2], sum[BN / 2];  // one k-step's sum (tensor cores), the running sum
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;

  const int ar = 64 * wg + 16 * ((tid >> 5) & 3) + g;  // this thread's A rows: ar, ar + 8
  const float* as = reinterpret_cast<const float*>(smem + L::B_BYTES);
  const uint32_t b_hi = b_s, b_lo = b_hi + BN * 128;
  for (int c = next_live(c_begin); c < c_end; c = next_live(c + 1)) {
    load(c);
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (my_mask & span(c)) {  // warpgroup-uniform
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float x[4] = {as[ar * AS + 8 * s + t4], as[(ar + 8) * AS + 8 * s + t4],
                            as[ar * AS + 8 * s + t4 + 4], as[(ar + 8) * AS + 8 * s + t4 + 4]};
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(x[q], ahi[q], alo[q]);
        wgmma_fence();
        wgmma(acc, alo, desc_sw128(b_hi + s * 32), 0);  // the k-step's sum starts at 0
        wgmma(acc, ahi, desc_sw128(b_lo + s * 32), 1);
        wgmma(acc, ahi, desc_sw128(b_hi + s * 32), 1);
        wgmma_commit();
        wgmma_wait<0>();  // the A registers (and after the last k-step the stage) are free
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          asm volatile("" : "+f"(acc[i])::"memory");  // read acc only after the wait
          sum[i] = __fadd_rn(sum[i], untruncate(acc[i]));
        }
      }
    }
    __syncthreads();  // ... in both warpgroups
  }

  // sum[4i + 2h + e] = D[ar - 64 wg + 8h][8i + 2 t4 + e] of the warpgroup's 64 x BN tile
  const bool split = gridDim.z > 1;
  const int n0 = blockIdx.y * BN;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[ar + 8 * h];
    if (row < 0) continue;
    const bool ok = valid[row] != 0;
    float* dst = split ? partial + ((size_t)blockIdx.z * V + row) * N : out + (size_t)row * N;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * i + 2 * t4 + e;
        if (col < N) dst[col] = split || ok ? sum[4 * i + 2 * h + e] : 0.f;
      }
  }
}

// out[i] = valid[row] ? sum over z = 0, 1, ... of partial[z][i] : 0
__global__ void subm_conv_sum_splits_kernel(const float* __restrict__ partial,
                                            const uint8_t* __restrict__ valid,
                                            float* __restrict__ out, int V, int N, int splits) {
  const size_t n = (size_t)V * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
  out[i] = valid[i / N] ? s : 0.f;
}

template <int BN>
cudaError_t launch(const float* a, const int32_t* nbr, const uint32_t* bt, const uint8_t* valid,
                   const int32_t* order, const int32_t* tile_mask, float* out, float* partial,
                   int V, int K, int N, int splits, cudaStream_t st) {
  const int n_chunks = (KOFF * K + BK - 1) / BK;
  const int per_split = (n_chunks + splits - 1) / splits;
  const int bytes = Layout<BN>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(subm_conv_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((V + BM - 1) / BM, (N + BN - 1) / BN, splits);
  subm_conv_kernel<BN><<<grid, NT, bytes, st>>>(a, nbr, bt, valid, order, tile_mask, out, partial,
                                                V, K, N, per_split);
  return cudaGetLastError();
}

}  // namespace

// The number of blocks gapro_subm_conv_fwd splits the reduction of each
// output tile over; the caller gives it a [splits, V, N] fp32 scratch
// buffer when this is more than 1. Returns -1 when the device query fails.
extern "C" int gapro_subm_conv_splits(int V, int K, int N) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int bn = block_cols(N);
  const long long tiles = (long long)((V + BM - 1) / BM) * ((N + bn - 1) / bn);
  const int n_chunks = (KOFF * K + BK - 1) / BK;
  long long s = tiles > 0 ? (long long)BLOCKS_PER_SM * sms / tiles : 1;
  if (s > n_chunks / MIN_CHUNKS) s = n_chunks / MIN_CHUNKS;
  return s < 1 ? 1 : static_cast<int>(s);
}

// The floats of the tiled-B scratch buffer gapro_subm_conv_fwd needs.
extern "C" long long gapro_subm_conv_b_floats(int K, int N) {
  const int bn = block_cols(N);
  const long long n_chunks = (KOFF * K + BK - 1) / BK;
  return n_chunks * ((N + bn - 1) / bn) * 2 * bn * BK;
}

// a [V, K] f32 (K a multiple of 4), nbr [V, 27] i32, b: B[k][n][c] at
// b[k * sk + n * sn + c * sc] for c < k_real <= K (columns past k_real
// read as 0), valid [V] u8, order [V] i32 (a permutation of the rows),
// tile_mask [ceil(V / 64)] i32 (the OR of each 64-row tile's neighbour
// masks under order), out [V, N] f32, partial [splits, V, N] f32 (unused
// when splits is 1), bt [gapro_subm_conv_b_floats(K, N)] f32 scratch; all
// on the current device, a, nbr, valid, order, tile_mask and out
// contiguous. Returns the cudaError_t of the launches.
extern "C" int gapro_subm_conv_fwd(const float* a, const int32_t* nbr, const float* b,
                                   long long sk, long long sn, long long sc, int k_real,
                                   const uint8_t* valid, const int32_t* order,
                                   const int32_t* tile_mask, float* out, float* partial,
                                   float* bt, int V, int K, int N, int splits, void* stream) {
  if (V == 0) return 0;
  if (splits < 1 || K % 4 != 0 || k_real > K) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bn = block_cols(N);
  const size_t n_elems = static_cast<size_t>(gapro_subm_conv_b_floats(K, N) / 2);
  uint32_t* btu = reinterpret_cast<uint32_t*>(bt);
  tile_b_kernel<<<(unsigned)((n_elems + 255) / 256), 256, 0, st>>>(b, sk, sn, sc, btu, K, k_real,
                                                                   N, bn, n_elems);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = bn == 64
            ? launch<64>(a, nbr, btu, valid, order, tile_mask, out, partial, V, K, N, splits, st)
            : launch<32>(a, nbr, btu, valid, order, tile_mask, out, partial, V, K, N, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)V * N;
  subm_conv_sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partial, valid, out,
                                                                           V, N, splits);
  return static_cast<int>(cudaGetLastError());
}
