// Masked furthest-point sampling (kernel K4).
//
// Per batch item, over n_sample sequential steps: emit the last index;
// update each valid point's minimum squared distance to it; take the
// argmax as the next index, the first index on ties. The walk starts at
// the first valid point; invalid points never win. (The wrapper repeats
// the first index in the slots past the number of valid points.)
//
// Replaces the TPU kernel gapro_tpu/ops/fps_pallas.py:_fps_kernel
// (launched by fps_masked_pallas), which keeps every point in VMEM. On the
// main path N = 262144 points (4 MB of coordinates) fit no block's 227 KB
// of shared memory, so that design does not carry over.
//
// Bound on the H100: the bytes (xyz 12 B + valid 1 B a point, read once,
// 3.4 MB at N = 262144) and the arithmetic (about 9 operations a point and
// step: 2048 x 262144 x 9 = 4.8 GOP, 0.07 ms at 67 TFLOP/s) are both tiny.
// What bounds this kernel is the n_sample dependent steps, each of which
// needs one reduction across the whole point set: latency, not bandwidth.
//
// Design: one persistent cooperative launch. Each thread keeps its few
// points' coordinates and running minimum distance in registers for the
// whole walk. Per step, each block reduces (distance, index) to one 64-bit
// key, (float bits of the distance) << 32 | ~index, whose maximum is the
// largest distance and then the smallest index; distances are >= 0, so
// their bits order like the floats. Block maxima meet in a global atomicMax
// on one of three rotating slots, and grid.sync() ends the step. The third
// slot lets block 0 clear the slot of the next step while slower blocks may
// still be reading the current one. For N = 2048 the launch is one block.
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

constexpr int NT = 1024;          // threads per block
constexpr int PPT = 8;            // most points a thread holds
constexpr int POINTS_PER_THREAD_TARGET = 2;

__device__ __forceinline__ unsigned long long pack_key(float d, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
         static_cast<unsigned int>(~i);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(NT)
fps_kernel(const float* __restrict__ xyz, const uint8_t* __restrict__ valid,
           const int32_t* __restrict__ first, int B, int N, int n_sample,
           int32_t* __restrict__ out, unsigned long long* slots) {
  cg::grid_group grid = cg::this_grid();
  __shared__ unsigned long long warp_best[NT / 32];
  const int nthreads = gridDim.x * blockDim.x;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  long long t = 0;  // global step count across batch items, picks the slot
  for (int b = 0; b < B; ++b) {
    const float* X = xyz + (size_t)b * N * 3;
    const uint8_t* Vb = valid + (size_t)b * N;
    float px[PPT], py[PPT], pz[PPT], dist[PPT];
    bool ok[PPT];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int i = gtid + p * nthreads;
      ok[p] = i < N && Vb[i] != 0;
      px[p] = ok[p] ? X[(size_t)i * 3 + 0] : 0.f;
      py[p] = ok[p] ? X[(size_t)i * 3 + 1] : 0.f;
      pz[p] = ok[p] ? X[(size_t)i * 3 + 2] : 0.f;
      dist[p] = 1e10f;
    }
    int last = first[b];
    for (int s = 0; s < n_sample; ++s, ++t) {
      if (gtid == 0) out[(size_t)b * n_sample + s] = last;
      if (s == n_sample - 1) break;  // the last argmax is never emitted
      const float lx = X[(size_t)last * 3 + 0];
      const float ly = X[(size_t)last * 3 + 1];
      const float lz = X[(size_t)last * 3 + 2];
      unsigned long long best = 0;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        if (!ok[p]) continue;
        const float dx = __fsub_rn(px[p], lx);
        const float dy = __fsub_rn(py[p], ly);
        const float dz = __fsub_rn(pz[p], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        dist[p] = fminf(dist[p], d);
        best = umax64(best, pack_key(dist[p], gtid + p * nthreads));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        best = umax64(best, __shfl_xor_sync(0xffffffffu, best, off));
      if (lane == 0) warp_best[warp] = best;
      __syncthreads();
      if (warp == 0) {
        best = lane < NT / 32 ? warp_best[lane] : 0ull;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          best = umax64(best, __shfl_xor_sync(0xffffffffu, best, off));
        if (lane == 0) {
          if (best) atomicMax(&slots[t % 3], best);
          if (blockIdx.x == 0) slots[(t + 1) % 3] = 0ull;
        }
      }
      grid.sync();
      const unsigned long long w = __ldcg(&slots[t % 3]);
      last = w ? static_cast<int>(~static_cast<unsigned int>(w & 0xffffffffull)) : 0;
    }
    grid.sync();  // every block has read its last slot before the next item
  }
}

}  // namespace

// xyz [B, N, 3] f32, valid [B, N] u8, first [B] i32 (first valid index),
// out [B, n_sample] i32, slots [3] u64 zeroed by the caller. Returns the
// cudaError_t of the launch (cudaErrorInvalidValue when N does not fit).
extern "C" int gapro_fps(const float* xyz, const uint8_t* valid, const int32_t* first,
                         int B, int N, int n_sample, int32_t* out,
                         unsigned long long* slots, void* stream) {
  if (B == 0 || n_sample == 0) return 0;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fps_kernel, NT, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long max_blocks = (long long)sms * occ;
  long long blocks = ((long long)N + (long long)NT * POINTS_PER_THREAD_TARGET - 1) /
                     ((long long)NT * POINTS_PER_THREAD_TARGET);
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  if (blocks * NT * PPT < N) return static_cast<int>(cudaErrorInvalidValue);
  int nblocks = static_cast<int>(blocks);
  void* args[] = {(void*)&xyz, (void*)&valid, (void*)&first, (void*)&B, (void*)&N,
                  (void*)&n_sample, (void*)&out, (void*)&slots};
  err = cudaLaunchCooperativeKernel((const void*)fps_kernel, nblocks, NT, args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
