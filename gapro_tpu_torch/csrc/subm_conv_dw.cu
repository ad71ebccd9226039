// Weight gradient of the 3x3x3 submanifold convolution on the tensor cores.
//
//   dW[k, c, d] = sum over rows i with nbr[i, k] >= 0 of feats[nbr[i, k], c] * dout[i, d]
//
// (dout is already zero on invalid rows.) Replaces the dW half of the TPU
// kernel gapro_tpu/sparse/window_conv.py:_bwd_fused_kernel (launched by
// _pallas_bwd_fused) and all of window_conv.py:_dw_kernel (launched by
// _pallas_dw on the GAPRO_WINDOW_FUSED=0 path). The other half of the fused
// TPU kernel, dfeats, is the forward conv of dout with the offsets reversed,
// which the port runs through K1 (subm_conv.cu). The TPU fused the two
// halves to share one chain of window DMAs per tile; Hopper gathers rows
// directly and has no such chain to share.
//
// Bounds on the H100 (bench scene 0 of the full-width model; nnz is the
// (row, offset) pairs that hold a neighbour):
//   level 0, V = 262144, 32 x 32, nnz = 1.41 M: 2.89 GFLOP; bytes nbr
//     28.3 MB + feats 33.5 MB + dout 33.5 MB + dW 0.1 MB = 95.8 MB
//     fp32 (67 TFLOP/s): 0.043 ms, bound by operations; TF32 (495 TFLOP/s):
//     0.0058 ms, so bytes bound it at 0.029 ms (3xTF32 operations 0.0175 ms).
//   level 1, V = 176128, 64 x 64, nnz = 1.70 M: 13.9 GFLOP, 110 MB:
//     fp32 0.208 ms; TF32 0.028 ms of operations, 0.033 ms of bytes;
//     3xTF32 operations 0.084 ms.
//
// Design. dW[k] = A_k^T B_k, where A_k holds the gathered feats rows
// feats[j] and B_k the dout rows dout[i] of the pairs (i, j = nbr[i, k]);
// the reduction runs over offset k's pair list, built once per level by
// sparse/plan.py:pair_lists (rows and neighbours in increasing row order,
// per-offset counts on the device). A block owns one TM x TN tile of dW[k]
// (TM, TN = 32 or 64) and a fixed range of the list, and reads it
// coalesced; blocks whose range starts past the count exit at once, so the
// grid needs no host sync. A ring of 3 stages of 32 pairs is filled by
// cp.async, 16 bytes a thread (rows past the count zero-fill): the A rows
// into a [32][TM + 8] tile, the B rows into [32][TN + 8]. Here the pair
// list is the reduction (K) dimension, and the tiles arrive with K as their
// rows, while wgmma takes 32-bit (TF32) operands only K-major; so the
// product runs on mma.sync.m16n8k8 TF32, whose fragments each thread loads
// itself from a [K][M] tile (the stride of TM + 8 floats makes the loads
// conflict-free). Four warps each own a (TM / 2) x (TN / 2) quarter.
//
// Precision: TF32 keeps 10 mantissa bits, so each product is taken in the
// split form (3xTF32): x = hi + lo with hi = tf32(x), lo = tf32(x - hi)
// (cvt.rna), and a.b = a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, summed in fp32.
// The tensor cores do not round their fp32 sums to nearest: a range's sum
// kept in the mma accumulator (up to about 700 accumulating mmas) drifted
// towards zero, many times further from fp64 than the plain fp32 version
// (PERF.md §6). So each k-step's three mmas (8 pairs) start from a zero
// accumulator, each k-step's sum gets back the half ulp its truncation
// takes on average (untruncate, conv_common.cuh, as in K1: without it dW read
// -0.03 to -0.05 ulp along the output's sign against fp64 on random inputs
// and down to -0.08 on a training step's own), and the k-step sums are
// added in fp32 on the CUDA cores (round to nearest), in pair order.
//
// The levels with many rows and few channels have too few (tile, k) pairs
// to fill 132 SMs, so each list is split into ranges of `per` pairs over
// gridDim.z blocks (gapro_subm_conv_dw_splits picks how many); each writes
// a partial dW and a second kernel adds, for each offset, the partials of
// the ranges its count reaches, in split order. Every sum runs in a fixed
// order with no atomics, so two launches give bit-identical dW.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KOFF = 27;
constexpr int NT = 128;     // four warps, 2 x 2 over the tile
constexpr int P = 32;       // pairs per stage: four k = 8 steps
constexpr int STAGES = 3;
// Aim for about this many blocks per SM that have pairs to reduce.
constexpr int BUSY_PER_SM = 6;
// A rough share of the 27 x V (row, offset) slots that hold a pair (a fifth
// to a third on the bench scene's levels); it only sizes the ranges.
constexpr int FILL_DIV = 5;
constexpr int MIN_PER = 8 * P;

#include "conv_common.cuh"

// d[16 x 8] += a[16 x 8] * b[8 x 8], TF32 in, fp32 sum
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int TM, int TN>
__global__ void __launch_bounds__(NT)
subm_conv_dw_kernel(const float* __restrict__ feats, const float* __restrict__ dout,
                    const int32_t* __restrict__ pair_i, const int32_t* __restrict__ pair_j,
                    const int32_t* __restrict__ counts, float* __restrict__ out, int V, int Cin,
                    int Cout, int per) {
  constexpr int AS = TM + 8, BS = TN + 8;  // tile strides in floats
  constexpr int MT = TM / 32, NB = TN / 16;  // m16 and n8 tiles of a warp
  extern __shared__ __align__(16) float smem[];
  float(*As)[P][AS] = reinterpret_cast<float(*)[P][AS]>(smem);
  float(*Bs)[P][BS] = reinterpret_cast<float(*)[P][BS]>(smem + STAGES * P * AS);

  const int tiles_d = (Cout + TN - 1) / TN;
  const int c0 = (blockIdx.x / tiles_d) * TM;
  const int d0 = (blockIdx.x % tiles_d) * TN;
  const int k = blockIdx.y;
  const int n_k = counts[k];
  const int p_begin = blockIdx.z * per;
  if (gridDim.z > 1 && p_begin >= n_k) return;  // the second pass skips this range
  const int p_end = min(n_k, p_begin + per);
  const int32_t* li = pair_i + (size_t)k * V;
  const int32_t* lj = pair_j + (size_t)k * V;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * (TM / 2), wn = (warp & 1) * (TN / 2);

  auto load = [&](int base, int s) {
    for (int e = tid; e < P * (TM / 4); e += NT) {
      const int r = e / (TM / 4), q = e % (TM / 4);
      const int pos = base + r;
      const bool ok = pos < p_end && c0 + 4 * q < Cin;
      const int j = ok ? lj[pos] : 0;
      cp_async16(smem_u32(&As[s][r][4 * q]), feats + (size_t)j * Cin + (ok ? c0 + 4 * q : 0), ok);
    }
    for (int e = tid; e < P * (TN / 4); e += NT) {
      const int r = e / (TN / 4), q = e % (TN / 4);
      const int pos = base + r;
      const bool ok = pos < p_end && d0 + 4 * q < Cout;
      const int i = ok ? li[pos] : 0;
      cp_async16(smem_u32(&Bs[s][r][4 * q]), dout + (size_t)i * Cout + (ok ? d0 + 4 * q : 0), ok);
    }
  };

  float acc[MT][NB][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  const int n_steps = p_end > p_begin ? (p_end - p_begin + P - 1) / P : 0;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(p_begin + s * P, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_steps; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (it + STAGES - 1 < n_steps) load(p_begin + (it + STAGES - 1) * P, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const int s = it % STAGES;
#pragma unroll
    for (int kk = 0; kk < P; kk += 8) {
      uint32_t ahi[MT][4], alo[MT][4], bhi[NB][2], blo[NB][2];
#pragma unroll
      for (int a = 0; a < MT; ++a) {
        const int m = wm + 16 * a + g;
        const float x[4] = {As[s][kk + t4][m], As[s][kk + t4][m + 8], As[s][kk + t4 + 4][m],
                            As[s][kk + t4 + 4][m + 8]};
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(x[q], ahi[a][q], alo[a][q]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int n = wn + 8 * b + g;
        split_tf32(Bs[s][kk + t4][n], bhi[b][0], blo[b][0]);
        split_tf32(Bs[s][kk + t4 + 4][n], bhi[b][1], blo[b][1]);
      }
      // this k-step's products start from zero on the tensor cores, and
      // are added, untruncated, to the running sum in fp32 on the CUDA cores
#pragma unroll
      for (int a = 0; a < MT; ++a)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float part[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(part, alo[a], bhi[b]);
          mma_tf32(part, ahi[a], blo[b]);
          mma_tf32(part, ahi[a], bhi[b]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[a][b][e] = __fadd_rn(acc[a][b][e], untruncate(part[e]));
        }
    }
  }
  cp_async_wait<0>();

  // acc[a][b] = D[wm + 16 a + g + 8 h][wn + 8 b + 2 t4 + e] at index 2 h + e
  float* dst = out + ((size_t)blockIdx.z * KOFF + k) * Cin * Cout;
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm + 16 * a + g + 8 * h;
      if (c >= Cin) continue;
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = d0 + wn + 8 * b + 2 * t4 + e;
          if (d < Cout) dst[(size_t)c * Cout + d] = acc[a][b][2 * h + e];
        }
    }
}

// out[k, c, d] = sum over the ranges z that offset k's count reaches, in
// order, of partial[z][k, c, d]
__global__ void subm_conv_dw_sum_splits_kernel(const float* __restrict__ partial,
                                               const int32_t* __restrict__ counts,
                                               float* __restrict__ out, int Cin, int Cout,
                                               int per, int splits) {
  const size_t n = (size_t)KOFF * Cin * Cout;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int k = static_cast<int>(e / ((size_t)Cin * Cout));
  const int used = min(splits, (counts[k] + per - 1) / per);
  float s = 0.f;
  for (int z = 0; z < used; ++z) s += partial[(size_t)z * n + e];
  out[e] = s;
}

int tile(int c) { return c > 32 ? 64 : 32; }

int pairs_per_split(int V, int splits) {
  const int per = (V + splits - 1) / splits;
  return (per + P - 1) / P * P;
}

template <int TM, int TN>
cudaError_t launch(const float* feats, const float* dout, const int32_t* pi, const int32_t* pj,
                   const int32_t* counts, float* out, int V, int Cin, int Cout, int per,
                   int splits, cudaStream_t st) {
  const int bytes = STAGES * P * (TM + 8 + TN + 8) * 4;
  cudaError_t err = cudaFuncSetAttribute(subm_conv_dw_kernel<TM, TN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(((Cin + TM - 1) / TM) * ((Cout + TN - 1) / TN), KOFF, splits);
  subm_conv_dw_kernel<TM, TN><<<grid, NT, bytes, st>>>(feats, dout, pi, pj, counts, out, V, Cin,
                                                       Cout, per);
  return cudaGetLastError();
}

}  // namespace

// The number of ranges gapro_subm_conv_dw splits each offset's pair list
// into; the caller gives it a [splits, 27, Cin, Cout] fp32 scratch buffer
// when this is more than 1. Returns -1 when the device query fails.
extern "C" int gapro_subm_conv_dw_splits(int V, int Cin, int Cout) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const long long tiles = (long long)((Cin + tile(Cin) - 1) / tile(Cin)) *
                          ((Cout + tile(Cout) - 1) / tile(Cout));
  // busy blocks ~ (27 V / FILL_DIV) / per * tiles = BUSY_PER_SM * sms
  long long per = (long long)KOFF * V * tiles / ((long long)FILL_DIV * BUSY_PER_SM * sms);
  if (per < MIN_PER) per = MIN_PER;
  const long long s = ((long long)V + per - 1) / per;
  return s < 1 ? 1 : static_cast<int>(s);
}

// feats [V, Cin] f32 and dout [V, Cout] f32 (Cin, Cout multiples of 4),
// pair_i and pair_j [27, V] i32 and counts [27] i32 (sparse/plan.py:
// pair_lists), dw [27, Cin, Cout] f32, partial [splits, 27, Cin, Cout] f32
// (unused when splits is 1); all contiguous on the current device. Every
// entry of dw is written. Returns the cudaError_t of the launches.
extern "C" int gapro_subm_conv_dw(const float* feats, const float* dout, const int32_t* pair_i,
                                  const int32_t* pair_j, const int32_t* counts, float* dw,
                                  float* partial, int V, int Cin, int Cout, int splits,
                                  void* stream) {
  if (splits < 1 || Cin < 1 || Cout < 1 || Cin % 4 || Cout % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per = pairs_per_split(V, splits);
  float* dst = splits > 1 ? partial : dw;
  const bool wide_m = tile(Cin) == 64, wide_n = tile(Cout) == 64;
  cudaError_t err =
      wide_m ? (wide_n ? launch<64, 64>(feats, dout, pair_i, pair_j, counts, dst, V, Cin, Cout, per, splits, st)
                       : launch<64, 32>(feats, dout, pair_i, pair_j, counts, dst, V, Cin, Cout, per, splits, st))
             : (wide_n ? launch<32, 64>(feats, dout, pair_i, pair_j, counts, dst, V, Cin, Cout, per, splits, st)
                       : launch<32, 32>(feats, dout, pair_i, pair_j, counts, dst, V, Cin, Cout, per, splits, st));
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)KOFF * Cin * Cout;
  subm_conv_dw_sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      partial, counts, dw, Cin, Cout, per, splits);
  return static_cast<int>(cudaGetLastError());
}
