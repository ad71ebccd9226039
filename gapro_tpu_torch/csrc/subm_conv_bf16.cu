// 3x3x3 submanifold sparse convolution in bf16 on the tensor cores
// (kernel K1-bf16), the forward of every subm conv under
// GAPRO_CONV_DTYPE=bf16.
//
//   out[i, :] = valid[i] ? sum_k a[nbr[i, k], :] @ bf16(B[k])^T : 0
//
// a = bf16(feats) [V, K] (the wrapper rounds the features in one
// elementwise pass, as the JAX package writes a bf16 table); B[k] = W[k]^T
// [N, K] in fp32, read through its strides and rounded to bf16 (to nearest
// even) by a prologue kernel. The products of two bf16 values are exact in
// fp32; they are summed in fp32 and the output is fp32. Two functions, as
// the JAX package computes one or the other on a level (round_taps):
// - round_taps 0: the XLA gather-GEMM of gapro_tpu/sparse/conv.py:subm_conv,
//   on a level without window tables: every product summed in fp32;
// - round_taps 1: the TPU kernel gapro_tpu/sparse/window_conv.py:_fwd_kernel
//   as _apply launches it under GAPRO_CONV_DTYPE=bf16 (its table cast to
//   bf16 at window_conv.py:768, its weights at :652), on a level with
//   window tables: each tap's sum over the K channels,
//   t[i, k] = a[nbr[i, k], :] @ bf16(B[k])^T in fp32, is rounded to bf16
//   (its one-hot gather takes the tap's sums cast to the table's type,
//   window_conv.py:357, :327) before the taps are added in fp32 in k
//   order. The TPU adds its escapees' taps unrounded (_escape_correction);
//   here no tap escapes, and every tap is rounded.
// The dfeats half of the backward stays the fp32 K1 (subm_conv.cu) on
// window levels, as _window_conv_bwd casts dout to the saved fp32 input's
// type; sparse/conv.py:SubmConvFn says which level takes which.
//
// Bounds on the H100 (bench scene 0 of the full-width model): the operations
// are those of K1 (2 nnz Cin Cout), at 989 TFLOP/s of bf16, half K1's TF32
// time; the bytes are K1's with the features read as bf16 (2 bytes an entry)
// and the output written in fp32. Level 0, V = 262144, 32 -> 32:
// 2.89 GFLOP, 0.0029 ms of operations; 17 MB of bf16 features, 28 MB of
// table, 34 MB of output: bytes bound it, as they bound K1.
//
// Design: K1's (csrc/subm_conv.cu), with bf16 operands. A block is two
// warpgroups, each a 64-row tile of the rows in the order `order` gives, by
// BN = 32 or 64 output columns; split-K over gridDim.z on the deep levels;
// a block loads a chunk when either tile's OR-mask holds one of its offsets.
// What bf16 changes:
// - A chunk is 64 columns of the flattened (offset, K) axis, 128 bytes of a
//   gathered row as in K1, so the shared-memory tiles, the cp.async copies
//   (16 bytes, 8 values, a thread) and the 128-byte swizzle of B are K1's
//   byte for byte. K must be a multiple of 8 (the wrapper pads the stem's 6
//   to 8), so that no 16-byte piece straddles two offsets; a chunk then
//   spans 8 offsets at K = 8, 2 at 32, 1 at 64.
// - wgmma.m64nNk16.f32.bf16.bf16 takes 16 values (32 bytes) a k-step: four
//   k-steps a chunk, at descriptor offsets of 32 bytes as in K1. A k-step
//   whose 16 columns hold no offset of the warpgroup's tile is skipped: its
//   A columns are all zero (at K = 8, two offsets a k-step).
// - The A fragment is bf16 pairs packed in 32-bit registers, loaded one
//   32-bit word at a time from the [128][36-word] tile: row g, words
//   8s + t4 and 8s + t4 + 4 (rows g + 8 likewise), the words K1 loads, so
//   the padded stride stays conflict-free.
// - The inputs are exact in bf16: one wgmma a k-step, no split form.
// The tensor cores truncate their fp32 sums (csrc/subm_conv.cu). As in K1,
// each k-step's wgmma starts from a zero accumulator and the k-step sums are
// added on the CUDA cores in fp32 (round to nearest), in k order. Unlike
// K1, a k-step's sum is not given back half an ulp (untruncate): in bf16
// the tensor cores' sum of 16 exact products loses about a quarter of an
// ulp, and on the H100 the mean error along the output's sign against fp64
// read -0.008 to -0.014 ulp of the output's largest entry as it is, and
// +0.010 to +0.016 with untruncate, which cost 11-27% of a launch at
// levels 0-3 (PERF.md §6); both lie within K1's gate of 0.06. With
// round_taps, the k-step sums of one tap are added apart, rounded to bf16
// when the tap's channels end, then added to the output's sum; a k-step
// that holds the last 8 channels of one tap and the first 8 of the next
// (K = 8, or K an odd multiple of 8) is taken as two wgmmas, each with the
// other half of its A fragment zeroed. A split of the reduction holds whole
// taps. Every output is summed in a fixed order with no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KOFF = 27;
constexpr int WG = 2;           // warpgroups per block, each with its own 64 rows
constexpr int BM = 64 * WG;     // output rows per block
constexpr int BK = 64;          // chunk of the flattened (offset, K) axis: 128 bytes of bf16
constexpr int KS = 16;          // bf16 values a wgmma k-step
constexpr int NT = 128 * WG;
constexpr int AS = 36;          // A tile row stride in 32-bit words (32 words of data)
constexpr int A_BYTES = BM * AS * 4;
constexpr int A_ROWS = BM * 8 / NT;  // gathered rows per thread and chunk (8 pieces a row)
// Split the reduction until the grid has about this many blocks per SM,
// keeping at least MIN_CHUNKS chunks of the reduction in each split.
constexpr int BLOCKS_PER_SM = 4;
constexpr int MIN_CHUNKS = 2;

int block_cols(int N) { return N > 32 ? 64 : 32; }

template <int BN>
struct Layout {
  static constexpr int B_BYTES = BN * 128;                 // [BN][64] bf16
  static constexpr int NBS = B_BYTES + A_BYTES;            // [BM][27] neighbour rows
  static constexpr int ROWS = NBS + BM * KOFF * 4;         // [BM] output rows
  static constexpr int BYTES = ROWS + BM * 4 + 1024;       // + alignment slack
};

#include "conv_common.cuh"

// d[64 x 32] = a[64 x 16] (registers, bf16 pairs) * b[16 x 32] (shared, bf16,
// K-major) + (keep ? d : 0)
__device__ __forceinline__ void wgmma(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                      int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

// d[64 x 64] = a[64 x 16] (registers, bf16 pairs) * b[16 x 64] (shared, bf16,
// K-major) + (keep ? d : 0)
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                      int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}

// The B operand in bf16, laid out as the main kernel's shared memory wants
// it: for chunk c and column tile t, a [BN][64] tile, rows 128 bytes with
// their 16-byte pieces (8 values) swizzled (piece q of row n at
// q ^ (n % 8)). Element (n, col) is bf16(B[k][t * BN + n][ch]) with
// (k, ch) = divmod(c * 64 + col, K), read through the strides (sk, sn, sc),
// and 0 past the K real columns or the N rows.
__global__ void tile_b_bf16_kernel(const float* __restrict__ b, long long sk, long long sn,
                                   long long sc, __nv_bfloat16* __restrict__ bt, int K,
                                   int k_real, int N, int BN, size_t n_elems) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_elems) return;
  const int col = static_cast<int>(e % BK);
  const int n = static_cast<int>((e / BK) % BN);
  const size_t tile = e / ((size_t)BK * BN);
  const int n_tiles = (N + BN - 1) / BN;
  const int c = static_cast<int>(tile / n_tiles), t = static_cast<int>(tile % n_tiles);
  const int flat = c * BK + col, k = flat / K, ch = flat - k * K, nn = t * BN + n;
  const float x = flat < KOFF * K && ch < k_real && nn < N ? b[k * sk + nn * sn + ch * sc] : 0.f;
  bt[tile * BN * BK + n * BK + ((((col >> 3) ^ (n & 7)) << 3) | (col & 7))] =
      __float2bfloat16_rn(x);
}

template <int BN, bool ROUND>
__global__ void __launch_bounds__(NT)
subm_conv_bf16_kernel(const __nv_bfloat16* __restrict__ a, const int32_t* __restrict__ nbr,
                      const __nv_bfloat16* __restrict__ bt, const uint8_t* __restrict__ valid,
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

  // the offsets the columns [lo, lo + width) of the flattened axis read
  auto span = [&](int lo, int width) {
    const int k_lo = lo / K, k_hi = min(KOFF - 1, (lo + width - 1) / K);
    return ((2u << k_hi) - 1u) & ~((1u << k_lo) - 1u);
  };
  // A chunk whose offsets no row of the tile has gathers only zeros:
  // skipping it leaves every sum as it was (finite weights).
  auto next_live = [&](int c) {
    while (c < c_end && !(mask & span(c * BK, BK))) ++c;
    return c;
  };

  // this thread's 16-byte piece (8 values) of each gathered row, and its rows
  const int p = tid & 7, r0 = tid >> 3;
  const size_t b_tile = (size_t)BN * BK;
  const __nv_bfloat16* b_src = bt + (size_t)blockIdx.y * b_tile;
  const size_t b_chunk = (size_t)gridDim.y * b_tile;
  const uint32_t b_s = smem_u32(smem), a_s = b_s + L::B_BYTES;
  auto load = [&](int c) {
    const int col = c * BK + p * 8;
    const int k = col / K, ch = col - k * K;
    const bool in = col < KF;
#pragma unroll
    for (int i = 0; i < A_ROWS; ++i) {
      const int r = r0 + i * (NT / 8);
      const int j = in ? nbs[r * KOFF + k] : -1;
      cp_async16(a_s + r * AS * 4 + p * 16, a + (size_t)max(j, 0) * K + ch, j >= 0);
    }
    const __nv_bfloat16* src = b_src + c * b_chunk;
#pragma unroll
    for (int e = tid; e < BN * 8; e += NT) cp_async16(b_s + 16 * e, src + 8 * e, true);
  };

  // one k-step's sum (tensor cores), the running sum, the current tap's sum (ROUND)
  float acc[BN / 2], sum[BN / 2], tap[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = tap[i] = 0.f;

  const int ar = 64 * wg + 16 * ((tid >> 5) & 3) + g;  // this thread's A rows: ar, ar + 8
  const uint32_t* as = reinterpret_cast<const uint32_t*>(smem + L::B_BYTES);
  // one wgmma of k-step s on the A fragment x; its sum goes to the tap's sum
  // (ROUND) or the running sum
  auto kstep = [&](const uint32_t (&x)[4], int s) {
    wgmma_fence();
    wgmma(acc, x, desc_sw128(b_s + s * 32), 0);  // the k-step's sum starts at 0
    wgmma_commit();
    wgmma_wait<0>();  // the A registers (and after the last k-step the stage) are free
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      asm volatile("" : "+f"(acc[i])::"memory");  // read acc only after the wait
      if (ROUND)
        tap[i] = __fadd_rn(tap[i], acc[i]);
      else
        sum[i] = __fadd_rn(sum[i], acc[i]);
    }
  };
  // the tap's channels end: its sum, rounded to bf16, joins the running sum
  auto end_tap = [&]() {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sum[i] = __fadd_rn(sum[i], __bfloat162float(__float2bfloat16_rn(tap[i])));
      tap[i] = 0.f;
    }
  };
  for (int c = next_live(c_begin); c < c_end; c = next_live(c + 1)) {
    load(c);
    cp_async_commit();
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll
    for (int s = 0; s < BK / KS; ++s) {
      const int col = c * BK + s * KS;
      if (col >= KF || !(my_mask & span(col, KS)))
        continue;  // warpgroup-uniform: the tile's A columns here are all zero
      // bf16 pairs: columns (2 t4, 2 t4 + 1) and (2 t4 + 8, 2 t4 + 9) of the k-step
      const uint32_t x[4] = {as[ar * AS + 8 * s + t4], as[(ar + 8) * AS + 8 * s + t4],
                             as[ar * AS + 8 * s + t4 + 4], as[(ar + 8) * AS + 8 * s + t4 + 4]};
      if (ROUND && (col + 8) % K == 0 && col + 8 < KF) {
        // a tap ends after the first 8 columns: each half on its own
        const uint32_t lo[4] = {x[0], x[1], 0u, 0u}, hi[4] = {0u, 0u, x[2], x[3]};
        kstep(lo, s);
        end_tap();
        kstep(hi, s);
      } else {
        kstep(x, s);
      }
      if (ROUND && ((col + KS) % K == 0 || col + KS >= KF)) end_tap();
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
__global__ void subm_conv_bf16_sum_splits_kernel(const float* __restrict__ partial,
                                                 const uint8_t* __restrict__ valid,
                                                 float* __restrict__ out, int V, int N,
                                                 int splits) {
  const size_t n = (size_t)V * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + i];
  out[i] = valid[i / N] ? s : 0.f;
}

// Chunks a split of the reduction takes come in groups of whole taps: the
// chunks of lcm(BK, K) columns.
int chunks_per_group(int K) {
  int a = BK, b = K;
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return K / a;  // lcm(BK, K) / BK
}

// The chunks each of `splits` splits takes: whole groups.
int chunks_per_split(int K, int splits) {
  const int q = chunks_per_group(K);
  const int groups = ((KOFF * K + BK - 1) / BK + q - 1) / q;
  return q * ((groups + splits - 1) / splits);
}

template <int BN, bool ROUND>
cudaError_t launch(const __nv_bfloat16* a, const int32_t* nbr, const __nv_bfloat16* bt,
                   const uint8_t* valid, const int32_t* order, const int32_t* tile_mask,
                   float* out, float* partial, int V, int K, int N, int splits, cudaStream_t st) {
  const int bytes = Layout<BN>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(subm_conv_bf16_kernel<BN, ROUND>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((V + BM - 1) / BM, (N + BN - 1) / BN, splits);
  subm_conv_bf16_kernel<BN, ROUND><<<grid, NT, bytes, st>>>(
      a, nbr, bt, valid, order, tile_mask, out, partial, V, K, N, chunks_per_split(K, splits));
  return cudaGetLastError();
}

}  // namespace

// The number of blocks gapro_subm_conv_bf16_fwd splits the reduction of each
// output tile over; the caller gives it a [splits, V, N] fp32 scratch
// buffer when this is more than 1. Returns -1 when the device query fails.
extern "C" int gapro_subm_conv_bf16_splits(int V, int K, int N) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const int bn = block_cols(N);
  const long long tiles = (long long)((V + BM - 1) / BM) * ((N + bn - 1) / bn);
  const int n_chunks = (KOFF * K + BK - 1) / BK;
  long long s = tiles > 0 ? (long long)BLOCKS_PER_SM * sms / tiles : 1;
  if (s > n_chunks / MIN_CHUNKS) s = n_chunks / MIN_CHUNKS;
  if (s <= 1) return 1;
  // as many splits as whole groups of taps fill: no split is empty
  const int per = chunks_per_split(K, static_cast<int>(s));
  return (n_chunks + per - 1) / per;
}

// The bf16 elements of the tiled-B scratch buffer gapro_subm_conv_bf16_fwd
// needs.
extern "C" long long gapro_subm_conv_bf16_b_elems(int K, int N) {
  const int bn = block_cols(N);
  const long long n_chunks = (KOFF * K + BK - 1) / BK;
  return n_chunks * ((N + bn - 1) / bn) * bn * BK;
}

// a [V, K] bf16 (K a multiple of 8), nbr [V, 27] i32, b: B[k][n][c] fp32 at
// b[k * sk + n * sn + c * sc] for c < k_real <= K (columns past k_real read
// as 0), valid [V] u8, order [V] i32 (a permutation of the rows), tile_mask
// [ceil(V / 64)] i32 (the OR of each 64-row tile's neighbour masks under
// order), out [V, N] f32, partial [splits, V, N] f32 (unused when splits is
// 1), bt [gapro_subm_conv_bf16_b_elems(K, N)] bf16 scratch; all on the
// current device, a, nbr, valid, order, tile_mask and out contiguous;
// round_taps 1 rounds each tap's sum to bf16 (the window kernel's function).
// Returns the cudaError_t of the launches.
extern "C" int gapro_subm_conv_bf16_fwd(const void* a, const int32_t* nbr, const float* b,
                                        long long sk, long long sn, long long sc, int k_real,
                                        const uint8_t* valid, const int32_t* order,
                                        const int32_t* tile_mask, float* out, float* partial,
                                        void* bt, int V, int K, int N, int splits,
                                        int round_taps, void* stream) {
  if (V == 0) return 0;
  if (splits < 1 || K % 8 != 0 || k_real > K) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bn = block_cols(N);
  const size_t n_elems = static_cast<size_t>(gapro_subm_conv_bf16_b_elems(K, N));
  __nv_bfloat16* btb = static_cast<__nv_bfloat16*>(bt);
  const __nv_bfloat16* ab = static_cast<const __nv_bfloat16*>(a);
  tile_b_bf16_kernel<<<(unsigned)((n_elems + 255) / 256), 256, 0, st>>>(b, sk, sn, sc, btb, K,
                                                                         k_real, N, bn, n_elems);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto run = bn == 64 ? (round_taps ? launch<64, true> : launch<64, false>)
                      : (round_taps ? launch<32, true> : launch<32, false>);
  err = run(ab, nbr, btb, valid, order, tile_mask, out, partial, V, K, N, splits, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)V * N;
  subm_conv_bf16_sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partial, valid, out, V, N, splits);
  return static_cast<int>(cudaGetLastError());
}
