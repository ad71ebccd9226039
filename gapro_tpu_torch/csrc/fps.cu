// Masked furthest-point sampling (kernel K4).
//
// Per batch item, over n_sample sequential steps: emit the last index;
// update each valid point's minimum squared distance to it; take the
// argmax as the next index, the first index on ties. The walk starts at
// the first valid point; invalid points never win.
//
// Replaces the TPU kernel gapro_tpu/ops/fps_pallas.py:_fps_kernel
// (launched by fps_masked_pallas), which keeps one item's points and
// distances in VMEM for the whole walk.
//
// Input contract (ops/fps.py:fps_cuda): the wrapper first compacts each
// item's valid points to the front of a [B, N, 3] buffer, in their order,
// with the count on the device. The kernel walks the compacted points and
// emits compacted indices, which the wrapper maps back. Compaction keeps
// the order, so the smallest compacted index on a tie is the smallest
// original index, and compacted index 0 is the first valid point.
//
// Bound on the H100: the bytes (xyz 12 B + valid 1 B a point, read once,
// 3.4 MB at N = 262144) and the arithmetic (about 10 operations a point and
// step: 2048 x 262144 x 10 = 5.4 GOP, 0.08 ms at 67 TFLOP/s) are both
// tiny. What bounds this kernel is the n_sample dependent steps, each of
// which needs one reduction across the item's points: latency.
//
// Design: one thread-block cluster per batch item, all items at once.
// - The cluster holds the item's compacted points on chip: each block a
//   contiguous share, its coordinates in shared memory (x, y, z arrays,
//   read four points at a time), each point's running minimum distance in
//   the registers of the thread that owns it (-1 for a slot past the
//   block's points, which never wins). A block holds up to NT x PPT =
//   16384 points (192 KB), a cluster of 16 up to 262144.
// - Compacted points past that capacity (an item with more valid points
//   than the cluster holds) are read from global memory (L2) each step,
//   their distances kept in global memory: the same step, after the
//   on-chip points.
// - A step's argmax is the maximum of the 64-bit key (float bits of the
//   distance) << 32 | ~index: largest distance, then smallest index
//   (distances are >= 0, so their bits order like the floats). Each half
//   is reduced with redux.sync (the index among the lanes holding the
//   largest distance), per warp, then per block through shared memory.
// - Across the cluster, each block's warp 0 pushes the block's winner (key
//   and coordinates, read from its own shared memory or, past the
//   capacity, from global memory) into a slot of every block's shared
//   memory with st.async, which completes bytes on that block's mbarrier.
//   Every warp waits on its own block's mbarrier, then reduces the
//   cluster's slots: the next point and its coordinates, with no global
//   atomic, no grid barrier and no re-read from global memory. Slots and
//   mbarriers are double-buffered by step parity: a block sends step
//   s + 2's winner only after it has every block's step s + 1 winner, so
//   after every block has read step s's slots and re-armed its barrier.
//   A barrier.cluster a step (arrive.release, wait.acquire) would do the
//   same job, but its release compiles to a GPU-scope memory barrier
//   (MEMBAR.ALL.GPU); the kernel keeps one at the start, after the
//   mbarriers are set, and one at the end, so that no block leaves while
//   another may still write to its shared memory.
// The cluster size is chosen by the wrapper from the static N: 1 block for
// N <= 16384 (the N = 2048 rounds), up to 16 (non-portable size).
//
// The squared distance is dx*dx + dy*dy + dz*dz, rounded after every
// multiply and add in that order (__fmul_rn / __fadd_rn, and the file is
// built with -fmad=false): a fused multiply-add rounds differently and
// flips near-tied argmaxes, and the indices must equal the plain version's
// bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;                     // threads per block
constexpr int VEC = 4;                       // points per shared-memory vector read
constexpr int GROUPS = 4;                    // vector reads per thread
constexpr int PPT = VEC * GROUPS;            // most on-chip points a thread owns
constexpr int BLOCK_POINTS = NT * PPT;       // 16384
constexpr int MAX_CLUSTER = 16;
constexpr unsigned NONE = 0xffffffffu;       // "no point" index; its distance bits are 0

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void st_async_v4(uint32_t addr, uint32_t a, uint32_t b, uint32_t c,
                                            uint32_t d, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(addr), "r"(a), "r"(b), "r"(c), "r"(d), "r"(mbar) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t mbar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(mbar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(mbar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  } while (!done);
}

// (bits, idx) of the lanes' largest key: the largest distance bits, then
// the smallest index among the lanes that hold them.
__device__ __forceinline__ void warp_argmax(unsigned& bits, unsigned& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, bits);
  idx = __reduce_min_sync(0xffffffffu, bits == top ? idx : NONE);
  bits = top;
}

__global__ void __launch_bounds__(NT, 1)
fps_cluster_kernel(const float* __restrict__ cxyz, const int32_t* __restrict__ count, int N,
                   int n_sample, int cs, int cap, int32_t* __restrict__ out,
                   float* __restrict__ gdist, long long spill_stride) {
  cg::cluster_group cluster = cg::this_cluster();  // cs blocks along x: one batch item
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / cs;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);
  float* sy = sx + cap;
  float* sz = sy + cap;
  __shared__ unsigned warp_bits[NT / 32], warp_idx[NT / 32];
  __shared__ __align__(16) uint4 slots[2][MAX_CLUSTER][2];
  __shared__ __align__(8) unsigned long long mbar[2];

  const float* X = cxyz + (size_t)b * N * 3;
  const int cnt = count[b];
  const int on_cap = cs * cap;                       // points the cluster holds on chip
  const int on_cnt = cnt < on_cap ? cnt : on_cap;
  const int per = ((on_cnt + cs - 1) / cs + VEC - 1) / VEC * VEC;  // <= cap
  const int base = rank * per;
  int nloc = on_cnt - base;
  nloc = nloc < 0 ? 0 : (nloc > per ? per : nloc);
  const int gtid = rank * NT + t;
  float* gd = gdist + (size_t)b * spill_stride;  // gd[i - on_cap] for i >= on_cap

  for (int l = t; l < nloc; l += NT) {
    sx[l] = X[(size_t)(base + l) * 3 + 0];
    sy[l] = X[(size_t)(base + l) * 3 + 1];
    sz[l] = X[(size_t)(base + l) * 3 + 2];
  }
  for (int i = on_cap + gtid; i < cnt; i += cs * NT) gd[i - on_cap] = 1e10f;
  // a slot past the block's points starts at -1, which never wins
  float dist[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
    dist[p] = (p / VEC) * VEC * NT + VEC * t + p % VEC < nloc ? 1e10f : -1.f;
  const uint32_t tx = static_cast<uint32_t>(cs) * 32u;
  if (t == 0) {
    mbar_init(smem_u32(&mbar[0]), 1);
    mbar_init(smem_u32(&mbar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(smem_u32(&mbar[0]), tx);
    mbar_expect_tx(smem_u32(&mbar[1]), tx);
  }
  cluster.sync();  // every block's barriers are set before any block sends

  int last = 0;  // the first valid point (or 0 where the item has none)
  float lx = X[0], ly = X[1], lz = X[2];
  int par = 0;
  for (int s = 0; s < n_sample; ++s) {
    if (rank == 0 && t == 0) out[(size_t)b * n_sample + s] = last;
    if (s == n_sample - 1) break;  // the last argmax is never emitted

    // this thread's points in increasing index order; a strict > keeps
    // the first index on ties
    float bd = -1.f;
    int bp = -1;  // the slot of the best point
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int l0 = g * VEC * NT + VEC * t;
      if (l0 < nloc) {
        const float4 x4 = *reinterpret_cast<const float4*>(sx + l0);
        const float4 y4 = *reinterpret_cast<const float4*>(sy + l0);
        const float4 z4 = *reinterpret_cast<const float4*>(sz + l0);
        const float xs[VEC] = {x4.x, x4.y, x4.z, x4.w};
        const float ys[VEC] = {y4.x, y4.y, y4.z, y4.w};
        const float zs[VEC] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float dx = __fsub_rn(xs[j], lx);
          const float dy = __fsub_rn(ys[j], ly);
          const float dz = __fsub_rn(zs[j], lz);
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          const float m = fminf(dist[g * VEC + j], d);
          dist[g * VEC + j] = m;
          if (m > bd) {
            bd = m;
            bp = g * VEC + j;
          }
        }
      }
    }
    int bi = bp < 0 ? -1 : base + (bp / VEC) * VEC * NT + VEC * t + bp % VEC;
    // past the on-chip capacity: coordinates and distances in global memory
    for (int i = on_cap + gtid; i < cnt; i += cs * NT) {
      const float dx = __fsub_rn(X[(size_t)i * 3 + 0], lx);
      const float dy = __fsub_rn(X[(size_t)i * 3 + 1], ly);
      const float dz = __fsub_rn(X[(size_t)i * 3 + 2], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(gd[i - on_cap], d);
      gd[i - on_cap] = m;
      if (m > bd) {
        bd = m;
        bi = i;
      }
    }

    unsigned kb = bi >= 0 ? __float_as_uint(bd) : 0u;
    unsigned ki = bi >= 0 ? static_cast<unsigned>(bi) : NONE;
    warp_argmax(kb, ki);
    if (lane == 0) {
      warp_bits[warp] = kb;
      warp_idx[warp] = ki;
    }
    __syncthreads();
    if (warp == 0) {
      kb = warp_bits[lane];  // one entry a warp: NT / 32 = 32
      ki = warp_idx[lane];
      warp_argmax(kb, ki);
      float cx = 0.f, cy = 0.f, cz = 0.f;
      if (lane == 0 && ki != NONE) {
        const int w = static_cast<int>(ki);
        if (w < on_cap) {
          cx = sx[w - base];
          cy = sy[w - base];
          cz = sz[w - base];
        } else {
          cx = X[(size_t)w * 3 + 0];
          cy = X[(size_t)w * 3 + 1];
          cz = X[(size_t)w * 3 + 2];
        }
      }
      cx = __shfl_sync(0xffffffffu, cx, 0);
      cy = __shfl_sync(0xffffffffu, cy, 0);
      cz = __shfl_sync(0xffffffffu, cz, 0);
      if (lane < cs) {
        const uint32_t dst = map_rank(smem_u32(&slots[par][rank][0]), lane);
        const uint32_t bar = map_rank(smem_u32(&mbar[par]), lane);
        st_async_v4(dst, kb, ki, __float_as_uint(cx), __float_as_uint(cy), bar);
        st_async_v4(dst + 16, __float_as_uint(cz), 0u, 0u, 0u, bar);
      }
    }
    mbar_wait(smem_u32(&mbar[par]), (s >> 1) & 1);
    if (t == 0) mbar_expect_tx(smem_u32(&mbar[par]), tx);  // its use two steps on

    unsigned cb = 0u, ci = NONE;
    if (lane < cs) {
      cb = slots[par][lane][0].x;
      ci = slots[par][lane][0].y;
    }
    const unsigned mine = cb, mine_i = ci;
    warp_argmax(cb, ci);
    const int src = __ffs(__ballot_sync(0xffffffffu, mine == cb && mine_i == ci)) - 1;
    lx = __uint_as_float(slots[par][src][0].z);
    ly = __uint_as_float(slots[par][src][0].w);
    lz = __uint_as_float(slots[par][src][1].x);
    last = ci != NONE ? static_cast<int>(ci) : 0;
    par ^= 1;
  }
  cluster.sync();  // no block leaves while another may still write to it
}

cudaLaunchConfig_t launch_config(int B, int cs, int cap, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * cs));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = static_cast<size_t>(cap) * 3 * sizeof(float);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cs);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Checks the launch shape; on a device's first launch, allows the kernel
// the most shared memory and the largest cluster it can ask for, so that
// later launches make no attribute calls.
cudaError_t set_attributes(int cs, int cap) {
  if (cs < 1 || cs > MAX_CLUSTER || cap < VEC || cap > BLOCK_POINTS || cap % VEC)
    return cudaErrorInvalidValue;
  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && ready[dev])) return err;
  err = cudaFuncSetAttribute(fps_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BLOCK_POINTS * 3 * static_cast<int>(sizeof(float)));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fps_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < MAX_DEVICES) ready[dev] = true;
  return err;
}

}  // namespace

// cxyz [B, N, 3] f32: each item's valid points first, in order; count [B]
// i32 valid points an item; out [B, n_sample] i32 compacted indices;
// gdist [B, spill_stride] f32 scratch for the points past cs * cap (one
// element an item where there are none). cs blocks a cluster (1 to 16),
// cap points of shared memory a block (a multiple of 4, at most 16384).
// Returns the cudaError_t of the launch.
extern "C" int gapro_fps(const float* cxyz, const int32_t* count, int B, int N, int n_sample,
                         int cs, int cap, int32_t* out, float* gdist, long long spill_stride,
                         void* stream) {
  if (B == 0 || n_sample == 0) return 0;
  cudaError_t err = set_attributes(cs, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(B, cs, cap, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, fps_cluster_kernel, cxyz, count, N, n_sample, cs, cap, out,
                           gdist, spill_stride);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of cs blocks with cap points each the card runs at
// once (cudaOccupancyMaxActiveClusters), in *clusters.
extern "C" int gapro_fps_max_active_clusters(int cs, int cap, int* clusters) {
  cudaError_t err = set_attributes(cs, cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, cs, cap, nullptr, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, reinterpret_cast<const void*>(fps_cluster_kernel), &cfg));
}
