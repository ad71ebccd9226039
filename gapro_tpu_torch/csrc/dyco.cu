// Dynamic-conv mask head, forward, fp32 (kernel K5).
//
//   for each batch item b, query q and superpoint s:
//     g    = [q_loc[b,q] - sp_coord[b,s]; |q_dim[b,q] - sp_dim[b,s]|]     (6)
//     x0   = relu(W0[b,q]^T [g; sp_feat[b,s]] + b0[b,q])                    (M)
//     x1   = relu(W1[b,q]^T x0 + b1[b,q])                                   (H = M / 2)
//     out[b,q,s] = sp_valid[b,s] ? W2[b,q]^T x1 : -1e4
//   W0 [M + 6, M] (rows 0-5 geometry, 6.. features), W1 [M, H], W2 [H, 1].
//
// Replaces the TPU kernel gapro_tpu/models/dyco.py:_dyco_kernel (launched by
// _pallas_forward). That kernel works transposed, superpoints on lanes, and
// applies 8 queries at once through block-diagonal weights so that every
// product fills the MXU, at about 8x the useful FLOPs. Neither trick helps
// here: the CUDA cores take a per-query product as it is.
//
// Bound on the H100 (the batch-4 training launch, B = 4, Q = 256, S = 4096,
// M = 32): 2 * (38 * 32 + 32 * 16 + 16) FLOPs, about 3.5 kFLOP, per (query,
// superpoint) pair, 14.7 GFLOP in all -> 0.22 ms at 67 TFLOP/s fp32; bytes
// (the weights, 7 KiB a query, the superpoint inputs and the 16.8 MB
// output) take 0.006 ms at 3.35 TB/s. So it is bound by operations.
//
// Design: the grid is (superpoint tiles, query groups, B). A block stages
// the weights, biases and geometry of its QB queries in shared memory
// (1,798 floats a query at M = 32). Each thread owns one superpoint: it
// keeps the superpoint's M features and 6 geometric inputs in registers and
// evaluates M + 6 -> M -> H -> 1 for each query of the block, as outer
// products, so that each weight row is a warp-uniform float4 broadcast from
// shared memory feeding four FMAs. Invalid superpoints skip the arithmetic
// and get -1e4. Q and S need not be multiples of anything: the edges are
// bounds checks. Every output is summed in one fixed order (geometry rows,
// then feature rows, then the bias), so the result is deterministic.
// Tensor cores (wgmma on [superpoints, M + 6] x [M + 6, M] tiles), bf16 and
// TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads a block = superpoints a block
constexpr int QB = 4;    // queries a block
constexpr float NEG = -1e4f;

template <int N>
__device__ __forceinline__ void axpy_row(float a, const float* __restrict__ row, float* acc) {
  // acc[0..N) += a * row[0..N); row is 16-byte aligned shared memory
#pragma unroll
  for (int d = 0; d < N; d += 4) {
    const float4 w = *reinterpret_cast<const float4*>(row + d);
    acc[d] = fmaf(a, w.x, acc[d]);
    acc[d + 1] = fmaf(a, w.y, acc[d + 1]);
    acc[d + 2] = fmaf(a, w.z, acc[d + 2]);
    acc[d + 3] = fmaf(a, w.w, acc[d + 3]);
  }
}

struct Weights {
  const float* w0;
  const float* w1;
  const float* w2;
  const float* b0;
  const float* b1;
  // element strides of the batch and query axes; the rest of each tensor
  // is contiguous
  long long w0_sb, w0_sq, w1_sb, w1_sq, w2_sb, w2_sq, b0_sb, b0_sq, b1_sb, b1_sq;
};

template <int M>
__global__ void __launch_bounds__(NT)
dyco_fwd_kernel(Weights p, const float* __restrict__ q_locs, const float* __restrict__ q_dims,
                const float* __restrict__ sp_feats, const float* __restrict__ sp_coords,
                const float* __restrict__ sp_dims, const uint8_t* __restrict__ sp_valid,
                float* __restrict__ out, int Q, int S) {
  constexpr int H = M / 2;
  constexpr int W0N = (M + 6) * M;
  __shared__ __align__(16) float w0s[QB][W0N];
  __shared__ __align__(16) float w1s[QB][M * H];
  __shared__ __align__(16) float w2s[QB][H];
  __shared__ __align__(16) float b0s[QB][M];
  __shared__ __align__(16) float b1s[QB][H];
  __shared__ float qgs[QB][6];

  const int b = blockIdx.z;
  const int q0 = blockIdx.y * QB;
  const int nq = min(QB, Q - q0);
  const int tid = threadIdx.x;

  for (int qi = 0; qi < nq; ++qi) {
    const long long q = q0 + qi;
    const float* src0 = p.w0 + b * p.w0_sb + q * p.w0_sq;
    for (int i = tid; i < W0N; i += NT) w0s[qi][i] = src0[i];
    const float* src1 = p.w1 + b * p.w1_sb + q * p.w1_sq;
    for (int i = tid; i < M * H; i += NT) w1s[qi][i] = src1[i];
    if (tid < H) {
      w2s[qi][tid] = p.w2[b * p.w2_sb + q * p.w2_sq + tid];
      b1s[qi][tid] = p.b1[b * p.b1_sb + q * p.b1_sq + tid];
    }
    if (tid < M) b0s[qi][tid] = p.b0[b * p.b0_sb + q * p.b0_sq + tid];
    if (tid < 3) {
      const size_t o = ((size_t)b * Q + q) * 3 + tid;
      qgs[qi][tid] = q_locs[o];
      qgs[qi][3 + tid] = q_dims[o];
    }
  }
  __syncthreads();

  const int s = blockIdx.x * NT + tid;
  if (s >= S) return;
  const size_t bs = (size_t)b * S + s;
  float* orow = out + ((size_t)b * Q + q0) * S + s;
  if (!sp_valid[bs]) {
    for (int qi = 0; qi < nq; ++qi) orow[(size_t)qi * S] = NEG;
    return;
  }

  float f[M];
#pragma unroll
  for (int c = 0; c < M; ++c) f[c] = sp_feats[bs * M + c];
  float sc[3], sd[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    sc[j] = sp_coords[bs * 3 + j];
    sd[j] = sp_dims[bs * 3 + j];
  }

  for (int qi = 0; qi < nq; ++qi) {
    float g[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g[j] = qgs[qi][j] - sc[j];
      g[3 + j] = fabsf(qgs[qi][3 + j] - sd[j]);
    }
    float x0[M];
#pragma unroll
    for (int d = 0; d < M; ++d) x0[d] = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) axpy_row<M>(g[c], &w0s[qi][c * M], x0);
#pragma unroll
    for (int c = 0; c < M; ++c) axpy_row<M>(f[c], &w0s[qi][(6 + c) * M], x0);
#pragma unroll
    for (int d = 0; d < M; ++d) x0[d] = fmaxf(x0[d] + b0s[qi][d], 0.f);

    float x1[H];
#pragma unroll
    for (int e = 0; e < H; ++e) x1[e] = 0.f;
#pragma unroll
    for (int c = 0; c < M; ++c) axpy_row<H>(x0[c], &w1s[qi][c * H], x1);
    float o = 0.f;
#pragma unroll
    for (int e = 0; e < H; ++e) o = fmaf(fmaxf(x1[e] + b1s[qi][e], 0.f), w2s[qi][e], o);
    orow[(size_t)qi * S] = o;
  }
}

template <int M>
int launch(const Weights& p, const float* q_locs, const float* q_dims, const float* sp_feats,
           const float* sp_coords, const float* sp_dims, const uint8_t* sp_valid, float* out,
           int B, int Q, int S, cudaStream_t st) {
  const dim3 grid((S + NT - 1) / NT, (Q + QB - 1) / QB, B);
  dyco_fwd_kernel<M><<<grid, NT, 0, st>>>(p, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                                          sp_valid, out, Q, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w0 [B, Q, M + 6, M], w1 [B, Q, M, M / 2], w2 [B, Q, M / 2, 1], b0 [B, Q, M],
// b1 [B, Q, M / 2], each with the given element strides of its batch and
// query axes and its trailing axes contiguous; q_locs, q_dims [B, Q, 3];
// sp_feats [B, S, M]; sp_coords, sp_dims [B, S, 3]; sp_valid [B, S] u8;
// out [B, Q, S]; all fp32 unless noted, contiguous unless noted, on the
// current device. M is 8, 16 or 32. Returns the cudaError_t of the launch.
extern "C" int gapro_dyco_fwd(const float* w0, long long w0_sb, long long w0_sq,
                              const float* w1, long long w1_sb, long long w1_sq,
                              const float* w2, long long w2_sb, long long w2_sq,
                              const float* b0, long long b0_sb, long long b0_sq,
                              const float* b1, long long b1_sb, long long b1_sq,
                              const float* q_locs, const float* q_dims, const float* sp_feats,
                              const float* sp_coords, const float* sp_dims,
                              const uint8_t* sp_valid, float* out, int B, int Q, int S, int M,
                              void* stream) {
  if (B == 0 || Q == 0 || S == 0) return 0;
  if (B > 65535 || (Q + QB - 1) / QB > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Weights p{w0, w1, w2, b0, b1, w0_sb, w0_sq, w1_sb, w1_sq, w2_sb,
                  w2_sq, b0_sb, b0_sq, b1_sb, b1_sq};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 8:
      return launch<8>(p, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid, out, B, Q, S,
                       st);
    case 16:
      return launch<16>(p, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid, out, B, Q,
                        S, st);
    case 32:
      return launch<32>(p, q_locs, q_dims, sp_feats, sp_coords, sp_dims, sp_valid, out, B, Q,
                        S, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
