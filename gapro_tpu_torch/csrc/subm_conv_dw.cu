// Weight gradient of the 3x3x3 submanifold convolution, fp32.
//
//   dW[k, c, d] = sum over rows i with nbr[i, k] >= 0 of feats[nbr[i, k], c] * dout[i, d]
//
// (dout is already zero on invalid rows.) Replaces the dW half of the TPU
// kernel gapro_tpu/sparse/window_conv.py:_bwd_fused_kernel (launched by
// _pallas_bwd_fused) and all of window_conv.py:_dw_kernel (launched by
// _pallas_dw on the GAPRO_WINDOW_FUSED=0 path). The other half of the fused
// TPU kernel, dfeats, is the forward conv of dout with the offsets reversed
// and the weights transposed, which the port runs through K1 (subm_conv.cu).
// The TPU fused the two halves to share one chain of window DMAs per tile;
// Hopper gathers rows directly and has no such chain to share.
//
// Bound on the H100 (level 0 of the full-width model, V = 262144, C = 32,
// about a fifth of the 27 x V (row, offset) pairs hold a neighbour):
//   bytes: nbr 28.3 MB + feats 33.5 MB + dout 33.5 MB + dW 0.1 MB
//          -> 95 MB / 3.35 TB/s = 0.028 ms;
//   FLOPs: 2 * nnz * Cin * Cout = 2.9 GFLOP -> 0.043 ms at 67 TFLOP/s fp32.
// Deeper levels have more channels and fewer rows, so operations bound them.
//
// Design: block (tile, k, split) owns one 32 x 32 tile of dW[k] (Cin x Cout)
// and a fixed range of rows. It scans the range in chunks of CAND rows: each
// thread reads the neighbour of its four rows at offset k, and a block-wide
// prefix sum packs the rows that have one into a list in shared memory, in
// row order. The rows without a neighbour (most of them at level 0) cost
// only that read. For every R listed rows the block gathers feats[j, c-tile]
// and dout[i, d-tile] into shared memory and each thread adds their product
// to a 2 x 4 register tile. The levels with many rows and few channels have
// too few (tile, k) pairs to fill 132 SMs, so their rows are split over
// gridDim.z blocks (gapro_subm_conv_dw_splits picks how many); each writes a
// partial dW and a second kernel adds the partials in split order. Every sum
// runs in a fixed order with no atomics, so two launches give bit-identical
// dW. Tensor cores (wgmma, TF32 or bf16) and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KOFF = 27;
constexpr int T = 32;              // Cin and Cout per block tile
constexpr int NT = 128;            // threads: 16 Cin pairs x 8 Cout quads
constexpr int PER_T = 4;           // rows each thread scans per chunk
constexpr int CAND = NT * PER_T;   // rows scanned per chunk
constexpr int R = 32;              // listed rows per reduction step
// Split the rows until the grid has about this many blocks per SM.
constexpr int BLOCKS_PER_SM = 8;

// Exclusive prefix sum of v over the block; *total gets the sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_base, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_base[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < NT / 32; ++w) {
      const int t = warp_base[w];
      warp_base[w] = run;
      run += t;
    }
    *total = run;
  }
  __syncthreads();
  return warp_base[warp] + x - v;
}

__global__ void __launch_bounds__(NT)
subm_conv_dw_kernel(const float* __restrict__ feats, const int32_t* __restrict__ nbr,
                    const float* __restrict__ dout, float* __restrict__ out, int V, int Cin,
                    int Cout, int rows_per_split) {
  __shared__ int32_t li[CAND];  // output row i of each listed pair
  __shared__ int32_t lj[CAND];  // its neighbour j = nbr[i, k]
  __shared__ __align__(16) float As[R][T];  // feats[j, c0 + c]
  __shared__ __align__(16) float Bs[R][T];  // dout[i, d0 + d]
  __shared__ int warp_base[NT / 32];
  __shared__ int n_listed;

  const int tiles_d = (Cout + T - 1) / T;
  const int c0 = (blockIdx.x / tiles_d) * T;
  const int d0 = (blockIdx.x % tiles_d) * T;
  const int k = blockIdx.y;
  const long long r_begin = (long long)blockIdx.z * rows_per_split;
  const long long r_end = min((long long)V, r_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int tx = tid % 8;  // Cout columns tx * 4 .. tx * 4 + 3
  const int ty = tid / 8;  // Cin rows ty * 2, ty * 2 + 1

  float acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (long long base = r_begin; base < r_end; base += CAND) {
    int js[PER_T];
    int cnt = 0;
#pragma unroll
    for (int q = 0; q < PER_T; ++q) {
      const long long i = base + tid * PER_T + q;
      js[q] = i < r_end ? nbr[i * KOFF + k] : -1;
      cnt += js[q] >= 0;
    }
    int pos = block_exclusive_scan(cnt, warp_base, &n_listed);
#pragma unroll
    for (int q = 0; q < PER_T; ++q) {
      if (js[q] >= 0) {
        li[pos] = static_cast<int32_t>(base + tid * PER_T + q);
        lj[pos] = js[q];
        ++pos;
      }
    }
    __syncthreads();
    const int n = n_listed;
    for (int s0 = 0; s0 < n; s0 += R) {
      // gather R listed rows: column e % T of row e / T, for both tiles
      for (int e = tid; e < R * T; e += NT) {
        const int r = e / T, c = e % T;
        float a = 0.f, b = 0.f;
        if (s0 + r < n) {
          if (c0 + c < Cin) a = __ldg(&feats[(size_t)lj[s0 + r] * Cin + c0 + c]);
          if (d0 + c < Cout) b = __ldg(&dout[(size_t)li[s0 + r] * Cout + d0 + c]);
        }
        As[r][c] = a;
        Bs[r][c] = b;
      }
      __syncthreads();
#pragma unroll 8
      for (int r = 0; r < R; ++r) {
        const float2 a = *reinterpret_cast<const float2*>(&As[r][ty * 2]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[r][tx * 4]);
        const float av[2] = {a.x, a.y};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
      }
      __syncthreads();
    }
  }

  float* dst = out + ((size_t)blockIdx.z * KOFF + k) * Cin * Cout;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int c = c0 + ty * 2 + p;
    if (c >= Cin) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = d0 + tx * 4 + q;
      if (d < Cout) dst[(size_t)c * Cout + d] = acc[p][q];
    }
  }
}

// out[e] = sum over z = 0, 1, ... of partial[z][e]
__global__ void sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  size_t n, int splits) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * n + e];
  out[e] = s;
}

}  // namespace

// The number of blocks gapro_subm_conv_dw splits the rows of each
// (tile, offset) over; the caller gives it a [splits, 27, Cin, Cout] fp32
// scratch buffer when this is more than 1. Returns -1 when the device query
// fails.
extern "C" int gapro_subm_conv_dw_splits(int V, int Cin, int Cout) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const long long pairs = (long long)((Cin + T - 1) / T) * ((Cout + T - 1) / T) * KOFF;
  long long s = (long long)BLOCKS_PER_SM * sms / pairs;
  const long long chunks = ((long long)V + CAND - 1) / CAND;  // keep a chunk per split
  if (s > chunks) s = chunks;
  return s < 1 ? 1 : static_cast<int>(s);
}

// feats [V, Cin] f32, nbr [V, 27] i32, dout [V, Cout] f32, dw [27, Cin, Cout]
// f32, partial [splits, 27, Cin, Cout] f32 (unused when splits is 1); all
// contiguous on the current device. Every entry of dw is written. Returns
// the cudaError_t of the launches.
extern "C" int gapro_subm_conv_dw(const float* feats, const int32_t* nbr, const float* dout,
                                  float* dw, float* partial, int V, int Cin, int Cout,
                                  int splits, void* stream) {
  if (splits < 1 || Cin < 1 || Cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows_per_split = (V + splits - 1) / splits;
  const dim3 grid(((Cin + T - 1) / T) * ((Cout + T - 1) / T), KOFF, splits);
  subm_conv_dw_kernel<<<grid, NT, 0, st>>>(feats, nbr, dout, splits > 1 ? partial : dw, V, Cin,
                                           Cout, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = (size_t)KOFF * Cin * Cout;
  sum_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(partial, dw, n, splits);
  return static_cast<int>(cudaGetLastError());
}
