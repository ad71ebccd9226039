// Dynamic-conv mask head, forward, on the tensor cores (kernel K5).
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
// product fills the MXU, at about 8x the useful FLOPs. Neither trick is
// carried over: here each query is a chain of two small GEMMs over a tile
// of superpoints, [64, M + 8] x [M + 8, M] and [64, M] x [M, H].
//
// Bound on the H100 (the batch-4 training launch, B = 4, Q = 256,
// S = 4096, M = 32, 80% of the superpoints valid): 2 * (38 * 32 + 32 * 16
// + 16) = 3488 FLOPs a (query, valid superpoint) pair, 11.7 GFLOP in all:
// 0.024 ms at the TF32 tensor-core rate (495 TFLOP/s), 0.071 ms for the
// three TF32 products a product takes here (below), 0.175 ms at the fp32
// CUDA-core rate, which bounded the kernel this one replaced (one thread a
// superpoint, four FMAs a float4 of weights). Bytes (the weights, 7 KiB a
// query, the superpoints and the 16.8 MB output) take 0.007 ms at 3.35
// TB/s, so operations bound it.
//
// Design. Two kernels. image_kernel writes each query's weights once as a
// contiguous "image" laid out as the main kernel's shared memory wants it:
// W0 and W1 split into TF32 high and low parts (below), K-major, rows of
// 128 bytes with their 16-byte pieces swizzled (piece p of row n at
// p ^ (n % 8)), as a wgmma descriptor with the 128-byte swizzle names it;
// then b0, b1, W2 and the query's location and size in fp32. It reads the
// weights through their batch and query strides, so the controller's views
// need no copy. Layer 0's reduction runs over [features; geometry; 0, 0]
// (M + 8 columns, k-steps of 8), so its B is chunks of 32 columns:
// one at M = 8 and 16, two at M = 32 (the second holds the geometry).
//
// dyco_kernel: a block is four warpgroups, each owning 64 superpoints of
// one item (256 a block), and a group of queries of that item. Each thread
// loads its rows' features once, straight into the registers of wgmma's A
// fragment (rows g and g + 8 of its warp's 16, columns t and t + 4 of each
// k-step), split into high and low parts, and keeps them there while the
// queries stream past: a fifth, producer warp issues cp.async.bulk (TMA)
// copies of the next images into a ring of 4 stages in shared memory, each
// completing bytes on its slot's "full" mbarrier; each consumer warp
// releases a slot on its "empty" mbarrier, so the warpgroups never wait
// for each other. Per query:
//   layer 0: the geometry k-step is built in registers from the row's
//     sp_coord / sp_dim and the query's q_loc / q_dim; then wgmma
//     m64nMk8 over the M / 8 feature k-steps and the geometry one;
//   layer 1: x0 = relu(acc + b0) is split again and becomes layer 1's A.
//     The accumulator holds columns 2t, 2t + 1 of each 8-column tile where
//     the A fragment wants columns t and t + 4; instead of shuffling, the
//     reduction index of layer 1 is permuted: its k-step j takes columns
//     8j + (0, 2, 4, 6, 1, 3, 5, 7) of x0, and the image holds W1's rows in
//     that order, so each thread's accumulator registers are its A fragment
//     as they are. wgmma m64nNk8 with N = max(H, 8): at M = 8, H = 4 is
//     padded with zero weight columns (zero bias, zero W2), which add 0;
//   layer 2: relu(x1 + b1) . W2 on the CUDA cores, each thread over its
//     columns, then two shuffles across the quad that shares a row, in a
//     fixed order.
// wgmma and not mma.sync: B is read by the tensor cores straight from the
// image in shared memory, once per warpgroup of 64 rows, where mma.sync
// would load every B fragment into each warp's registers (the weights are
// the operand that changes with each query). An mma.sync form (B
// fragments from shared memory, 32 rows a warp) was slower on the H100.
// These wgmmas are narrow (N = 32 and 16), and the kernel keeps the tensor
// cores busy for about a third of its time on its 3xTF32 work (PERF.md §6).
//
// Precision: TF32 keeps 10 mantissa bits, too few for K5's 2e-5 gate, so
// each product is taken in the split form (3xTF32): x = hi + lo with
// hi = tf32(x), lo = tf32(x - hi) (cvt.rna), and a.b = a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi, summed in fp32 (lo.lo is below fp32's rounding).
// The tensor cores do not round their fp32 sums to nearest: with each
// layer's 15 and 12 wgmmas accumulating in one register set, the logits
// drifted towards zero, past twice the plain fp32 version's rms error
// against fp64 (PERF.md §6). So each k-step's three wgmmas start from a
// zero accumulator, and the k-step sums are added in fp32 on the CUDA
// cores (gemm_split).
//
// Invalid superpoints get -1e4; a warpgroup whose 64 rows hold no valid
// superpoint writes -1e4 and skips every product, and a block with none
// loads nothing. Q and S need not be multiples of anything. Every output is
// summed in one fixed order with no atomics, so two launches give
// bit-identical logits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG = 4;         // consumer warpgroups a block, 64 superpoints each
constexpr int CW = 4 * WG;    // consumer warps
constexpr int NT = 32 * CW + 32;  // and one producer warp
constexpr int SB = 64 * WG;   // superpoints a block
constexpr int STAGES = 4;     // query images in flight
constexpr float NEG = -1e4f;
// 4 to 32 queries a block, as many as keep about 4 blocks a SM in the grid
constexpr int MIN_QG = 4, MAX_QG = 32, BLOCKS_PER_SM = 4;

// A query's image: byte offsets of its sections, each 1024-byte aligned.
template <int M>
struct Img {
  static constexpr int H = M / 2;
  static constexpr int N0 = M;                  // layer 0's columns
  static constexpr int N1 = H < 8 ? 8 : H;      // layer 1's, at least wgmma's 8
  static constexpr int S1 = M / 8;              // k-steps of layer 1 (layer 0: S1 + 1)
  static constexpr int C0 = (M + 8 + 31) / 32;  // layer 0's 32-column chunks
  static constexpr int W0B = N0 * 128;          // a chunk's high (or low) part
  static constexpr int W1B = N1 * 128;
  static constexpr int W0 = 0;                  // chunk c: high at W0 + 2 c W0B, low W0B on
  static constexpr int W1 = 2 * C0 * W0B;       // high, then low
  static constexpr int EX = W1 + 2 * W1B;       // fp32 b0 [N0], b1 [N1], w2 [N1], q [8]
  static constexpr int B1 = N0, W2 = N0 + N1, QGEO = N0 + 2 * N1;
  static constexpr int BYTES = (EX + 4 * (QGEO + 8) + 1023) / 1024 * 1024;
};

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mbar_init(uint32_t mbar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(mbar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mbar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t mbar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(mbar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(mbar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from global src to shared dst, completing on mbar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(mbar)
      : "memory");
}

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

// d[64 x N] = a[64 x 8] (registers, TF32) * b[8 x N] (shared, TF32, K-major)
// + (keep ? d : 0), for N = 8, 16, 32 (4, 8, 16 accumulators a thread)
__device__ __forceinline__ void wgmma(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                      int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}
__device__ __forceinline__ void wgmma(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                      int keep) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(keep));
}
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

// acc += a (TF32-split A fragment) times the split B at b_hi / b_lo:
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, the first starting from 0 if !keep
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N], const uint32_t (&ahi)[4],
                                       const uint32_t (&alo)[4], uint32_t b_hi, uint32_t b_lo,
                                       int keep) {
  wgmma(d, alo, desc_sw128(b_hi), keep);
  wgmma(d, ahi, desc_sw128(b_lo), 1);
  wgmma(d, ahi, desc_sw128(b_hi), 1);
}

// sum = A . B over K k-steps, A from registers (split), k-step s's B at
// b_hi(s) (high part) and b_hi(s) + lo (low part). Each k-step's three
// wgmmas start from a zero accumulator, and the k-step sums are added in
// fp32 on the CUDA cores, in k order.
template <int W, int K, typename BAddr>
__device__ __forceinline__ void gemm_split(float (&sum)[W], const uint32_t (&ahi)[K][4],
                                           const uint32_t (&alo)[K][4], BAddr b_hi,
                                           uint32_t lo) {
  float part[W];
#pragma unroll
  for (int i = 0; i < W; ++i) sum[i] = part[i] = 0.f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    wgmma_fence();
    const uint32_t bh = b_hi(s);
    wgmma3(part, ahi[s], alo[s], bh, bh + lo, 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < W; ++i) {
      asm volatile("" : "+f"(part[i])::"memory");
      sum[i] = __fadd_rn(sum[i], part[i]);
    }
  }
}

// The column of a B row's float at swizzled position pos (inverse of
// piece p of row n stored at p ^ (n % 8)).
__device__ __forceinline__ int unswizzle(int pos, int n) {
  return ((((pos >> 2) ^ (n & 7))) << 2) | (pos & 3);
}

// One block a query: its image (see the note at the top).
template <int M>
__global__ void image_kernel(Weights p, const float* __restrict__ q_locs,
                             const float* __restrict__ q_dims, uint32_t* __restrict__ img,
                             int Q) {
  using I = Img<M>;
  constexpr int H = I::H;
  const long long q = blockIdx.x, b = blockIdx.y;
  const float* w0 = p.w0 + b * p.w0_sb + q * p.w0_sq;
  const float* w1 = p.w1 + b * p.w1_sb + q * p.w1_sq;
  const float* w2 = p.w2 + b * p.w2_sb + q * p.w2_sq;
  const float* b0 = p.b0 + b * p.b0_sb + q * p.b0_sq;
  const float* b1 = p.b1 + b * p.b1_sb + q * p.b1_sq;
  uint32_t* dst = img + (size_t)(b * Q + q) * (I::BYTES / 4);
  for (int e = threadIdx.x; e < I::BYTES / 4; e += blockDim.x) {
    const int byte = 4 * e;
    uint32_t v = 0;
    if (byte < I::EX) {
      const bool l0 = byte < I::W1;
      const int rel = l0 ? byte : byte - I::W1, part = l0 ? I::W0B : I::W1B;
      const int off = (rel % part) / 4, n = off / 32;
      int k = unswizzle(off % 32, n);  // the reduction index within the chunk
      float x = 0.f;
      if (l0) {
        k += 32 * (rel / (2 * part));
        // [features; geometry; 0, 0]; W0's rows are [geometry; features]
        x = k < M ? w0[(6 + k) * M + n] : k < M + 6 ? w0[(k - M) * M + n] : 0.f;
      } else if (k < M && n < H) {
        // k-step j takes x0's columns 8j + (0, 2, 4, 6, 1, 3, 5, 7)
        const int r = k & 7, col = (k & ~7) + (r < 4 ? 2 * r : 2 * r - 7);
        x = w1[col * H + n];
      }
      uint32_t hi, lo;
      split_tf32(x, hi, lo);
      v = (rel / part) & 1 ? lo : hi;
    } else {
      const int i = (byte - I::EX) / 4;
      float x = 0.f;
      if (i < I::B1) x = b0[i];
      else if (i < I::W2) x = i - I::B1 < H ? b1[i - I::B1] : 0.f;
      else if (i < I::QGEO) x = i - I::W2 < H ? w2[i - I::W2] : 0.f;
      else if (i < I::QGEO + 3) x = q_locs[(b * Q + q) * 3 + i - I::QGEO];
      else if (i < I::QGEO + 6) x = q_dims[(b * Q + q) * 3 + i - I::QGEO - 3];
      v = __float_as_uint(x);
    }
    dst[e] = v;
  }
}

template <int M>
__global__ void __launch_bounds__(NT, 1)
dyco_kernel(const uint8_t* __restrict__ img, const float* __restrict__ sp_feats,
            const float* __restrict__ sp_coords, const float* __restrict__ sp_dims,
            const uint8_t* __restrict__ sp_valid, float* __restrict__ out, int Q, int S, int qg) {
  using I = Img<M>;
  constexpr int S1 = I::S1, N0 = I::N0, N1 = I::N1;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // full[s]: slot s holds its next image; empty[s]: every consumer warp is
  // done with it
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  __shared__ int live_warp[CW];

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool producer = warp == CW;
  const int b = blockIdx.z, s0 = blockIdx.x * SB;
  const int q0 = blockIdx.y * qg, nq = min(qg, Q - q0);
  const int row = s0 + 16 * warp + g;  // a consumer's rows: row, row + 8
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    valid[h] = !producer && r < S && sp_valid[(size_t)b * S + r] != 0;
  }
  const int any = __any_sync(0xffffffffu, valid[0] || valid[1]);
  if (lane == 0 && !producer) live_warp[warp] = any;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  bool block_live = false;
#pragma unroll
  for (int w = 0; w < CW; ++w) block_live |= live_warp[w] != 0;
  float* orow = out + ((size_t)b * Q + q0) * S;
  if (!block_live) {  // no valid superpoint: nothing to load or multiply
    for (int e = tid; e < nq * SB; e += NT) {
      const int r = s0 + e % SB;
      if (r < S) orow[(size_t)(e / SB) * S + r] = NEG;
    }
    return;
  }

  const uint32_t ring = smem_u32(smem);
  if (producer) {  // one thread streams the queries' images through the ring
    if (lane == 0) {
      const uint8_t* src = img + ((size_t)b * Q + q0) * I::BYTES;
      for (int i = 0; i < nq; ++i) {
        const int slot = i % STAGES;
        if (i >= STAGES) mbar_wait(smem_u32(&empty[slot]), (i / STAGES - 1) & 1);
        mbar_expect_tx(smem_u32(&full[slot]), I::BYTES);
        bulk_copy(ring + slot * I::BYTES, src + (size_t)i * I::BYTES, I::BYTES,
                  smem_u32(&full[slot]));
      }
    }
    return;
  }
  const bool live = live_warp[4 * wg] | live_warp[4 * wg + 1] | live_warp[4 * wg + 2] |
                    live_warp[4 * wg + 3];  // warpgroup-uniform

  // The rows' features as layer 0's A fragments (invalid rows as 0), and
  // the superpoint's side of the geometry columns t4 and t4 + 4: column
  // j < 3 is q_loc[j] - sp_coord[j], 3 + j is |q_dim[j] - sp_dim[j]|, 6 and
  // 7 are 0.
  uint32_t fhi[S1][4], flo[S1][4];
  float sg[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t r = (size_t)b * S + row + 8 * h;
    sg[h][0] = !valid[h] ? 0.f : t4 < 3 ? sp_coords[r * 3 + t4] : sp_dims[r * 3];
    sg[h][1] = valid[h] && t4 < 2 ? sp_dims[r * 3 + t4 + 1] : 0.f;
  }
#pragma unroll
  for (int s = 0; s < S1; ++s) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // (row, col): (g, t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4)
      const int h = i & 1, c = 8 * s + t4 + 4 * (i >> 1);
      x[i] = valid[h] ? sp_feats[((size_t)b * S + row + 8 * h) * M + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(x[i], fhi[s][i], flo[s][i]);
  }

  for (int i = 0; i < nq; ++i) {
    const int slot = i % STAGES;
    const uint32_t im = ring + slot * I::BYTES;
    float o[2] = {0.f, 0.f};
    // every consumer waits, so that no warp arrives on empty[slot] twice
    // in one phase
    mbar_wait(smem_u32(&full[slot]), (i / STAGES) & 1);
    if (live) {
      const float* ex = reinterpret_cast<const float*>(smem + slot * I::BYTES + I::EX);
      // layer 0: the feature k-steps, then the geometry one
      const float qa = ex[I::QGEO + t4], qb = ex[I::QGEO + 4 + t4];
      uint32_t ahi[S1 + 1][4], alo[S1 + 1][4];
#pragma unroll
      for (int s = 0; s < S1; ++s)
#pragma unroll
        for (int a = 0; a < 4; ++a) ahi[s][a] = fhi[s][a], alo[s][a] = flo[s][a];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d = qa - sg[h][0];
        split_tf32(t4 < 3 ? d : fabsf(d), ahi[S1][h], alo[S1][h]);
        split_tf32(t4 < 2 ? fabsf(qb - sg[h][1]) : 0.f, ahi[S1][2 + h], alo[S1][2 + h]);
      }
      float acc0[N0 / 2];
      gemm_split(acc0, ahi, alo,
                 [&](int s) { return im + I::W0 + (s / 4) * 2 * I::W0B + (s % 4) * 32; }, I::W0B);
      // x0 = relu(acc0 + b0); acc0[4j + 2h + e] is x0[row + 8h][8j + 2 t4 + e],
      // which layer 1's permuted k-step j takes as A fragment (e h): index
      // 0 -> 4j, 1 -> 4j + 2, 2 -> 4j + 1, 3 -> 4j + 3
      uint32_t xhi[S1][4], xlo[S1][4];
#pragma unroll
      for (int j = 0; j < S1; ++j)
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int idx = 4 * j + ((a & 1) << 1) + (a >> 1);
          const float x = fmaxf(acc0[idx] + ex[8 * j + 2 * t4 + (a >> 1)], 0.f);
          split_tf32(x, xhi[j][a], xlo[j][a]);
        }
      float acc1[N1 / 2];
      gemm_split(acc1, xhi, xlo, [&](int s) { return im + I::W1 + s * 32; }, I::W1B);
      // layer 2: acc1[4j + 2h + e] is x1's pre-activation at row + 8h,
      // column 8j + 2 t4 + e
#pragma unroll
      for (int j = 0; j < N1 / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * j + 2 * h + e, c = 8 * j + 2 * t4 + e;
            o[h] = fmaf(fmaxf(acc1[idx] + ex[I::B1 + c], 0.f), ex[I::W2 + c], o[h]);
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[h] += __shfl_xor_sync(0xffffffffu, o[h], 1);
        o[h] += __shfl_xor_sync(0xffffffffu, o[h], 2);
      }
    }
    if (t4 < 2) {  // lane t4 = h writes row + 8h
      const int r = row + 8 * t4;
      if (r < S) orow[(size_t)i * S + r] = (t4 ? valid[1] : valid[0]) ? (t4 ? o[1] : o[0]) : NEG;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[slot]));  // the warp is done with the slot
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return sms;
}

int image_bytes(int M) {
  switch (M) {
    case 8: return Img<8>::BYTES;
    case 16: return Img<16>::BYTES;
    case 32: return Img<32>::BYTES;
    default: return -1;
  }
}

template <int M>
cudaError_t launch(const Weights& p, const float* q_locs, const float* q_dims,
                   const float* sp_feats, const float* sp_coords, const float* sp_dims,
                   const uint8_t* sp_valid, float* out, uint32_t* img, int B, int Q, int S,
                   int sms, cudaStream_t st) {
  image_kernel<M><<<dim3(Q, B), 256, 0, st>>>(p, q_locs, q_dims, img, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * ((S + SB - 1) / SB);
  long long qg = ((long long)Q * tiles + (long long)BLOCKS_PER_SM * sms - 1) /
                 ((long long)BLOCKS_PER_SM * sms);
  qg = qg < MIN_QG ? MIN_QG : qg > MAX_QG ? MAX_QG : qg;
  const long long groups = (Q + qg - 1) / qg;
  qg = (Q + groups - 1) / groups;  // even groups
  const int bytes = STAGES * Img<M>::BYTES + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(dyco_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + SB - 1) / SB, static_cast<unsigned>(groups), B);
  dyco_kernel<M><<<grid, NT, bytes, st>>>(reinterpret_cast<const uint8_t*>(img), sp_feats,
                                          sp_coords, sp_dims, sp_valid, out, Q, S,
                                          static_cast<int>(qg));
  return cudaGetLastError();
}

}  // namespace

// The floats of the image scratch buffer gapro_dyco_fwd needs for B x Q
// queries of width M; -1 for a width it does not take.
extern "C" long long gapro_dyco_image_floats(int B, int Q, int M) {
  const int bytes = image_bytes(M);
  return bytes < 0 ? -1 : (long long)B * Q * (bytes / 4);
}

// w0 [B, Q, M + 6, M], w1 [B, Q, M, M / 2], w2 [B, Q, M / 2, 1], b0 [B, Q, M],
// b1 [B, Q, M / 2], each with the given element strides of its batch and
// query axes and its trailing axes contiguous; q_locs, q_dims [B, Q, 3];
// sp_feats [B, S, M]; sp_coords, sp_dims [B, S, 3]; sp_valid [B, S] u8;
// out [B, Q, S]; img [gapro_dyco_image_floats(B, Q, M)] scratch, 16-byte
// aligned; all fp32 unless noted, contiguous unless noted, on the current
// device. M is 8, 16 or 32. Returns the cudaError_t of the launches.
extern "C" int gapro_dyco_fwd(const float* w0, long long w0_sb, long long w0_sq,
                              const float* w1, long long w1_sb, long long w1_sq,
                              const float* w2, long long w2_sb, long long w2_sq,
                              const float* b0, long long b0_sb, long long b0_sq,
                              const float* b1, long long b1_sb, long long b1_sq,
                              const float* q_locs, const float* q_dims, const float* sp_feats,
                              const float* sp_coords, const float* sp_dims,
                              const uint8_t* sp_valid, float* out, float* img, int B, int Q,
                              int S, int M, void* stream) {
  if (B == 0 || Q == 0 || S == 0) return 0;
  if (B > 65535 || Q > 65535 || reinterpret_cast<uintptr_t>(img) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const Weights p{w0, w1, w2, b0, b1, w0_sb, w0_sq, w1_sb, w1_sq, w2_sb,
                  w2_sq, b0_sb, b0_sq, b1_sb, b1_sq};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t* im = reinterpret_cast<uint32_t*>(img);
  switch (M) {
    case 8:
      return static_cast<int>(launch<8>(p, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                                        sp_valid, out, im, B, Q, S, sms, st));
    case 16:
      return static_cast<int>(launch<16>(p, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                                         sp_valid, out, im, B, Q, S, sms, st));
    case 32:
      return static_cast<int>(launch<32>(p, q_locs, q_dims, sp_feats, sp_coords, sp_dims,
                                         sp_valid, out, im, B, Q, S, sms, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
