// 3x3x3 submanifold sparse convolution in bf16 on the tensor cores
// (kernel K1-bf16), the forward of every subm conv under
// GAPRO_CONV_DTYPE=bf16.
//
//   out[i, :] = valid[i] ? sum_k a[nbr[i, k], :] @ bf16(B[k])^T : 0
//
// a = bf16(feats) [V, K]; B[k] = W[k]^T [N, K] in fp32, read through its
// strides. A prologue kernel rounds both to bf16 (to nearest even) in one
// launch: the features into a [V, K] table (K padded to a multiple of 8),
// as the JAX package writes a bf16 table, and B into the swizzled tiles the
// main kernel copies. The products of two bf16 values are exact in fp32;
// they are summed in fp32 and the output is fp32. Two functions, as the JAX
// package computes one or the other on a level (round_taps):
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
// are those of K1 (2 nnz Cin Cout), at 989 TFLOP/s of bf16; the bytes are
// the bf16 features, the table, the bf16 weights and the fp32 output, each
// once. Level 1, V = 176128, 64 -> 64: 13.9 GFLOP, 0.014 ms of operations;
// 87 MB, 0.026 ms of bytes: bytes bound it, as they bind every level but
// the two concat convs of levels 2 and 3. In practice a gathered row comes
// from L2 once for each of its up to 27 neighbours, B from L2 once a block
// and chunk, and each k-step's wgmma is waited for before its fp32 sum is
// added: on the H100 the time follows the warpgroups an SM holds (PERF.md
// §6), not the copies in flight.
//
// Design (sparse/conv.py:k1_bf16_schedule picks the tile and the splits):
// - A block is two warpgroups. With WGN = 1 each takes its own 64 rows of a
//   128-row tile by BN columns (Cout <= 64); with WGN = 2 both take the
//   same 64 rows, side by side on 2 BN columns, so that a block covers the
//   whole Cout up to 224 (BN up to 112; 96 with round_taps, which keeps a
//   tap's sum) and each neighbour row is gathered once a block. The rows
//   come in the order `order` gives (valid rows first, sorted by their
//   neighbour mask); a block loads a chunk when a tile's OR-mask holds one
//   of its offsets, and each warpgroup multiplies only what its tile needs.
// - The reduction runs over the flattened (offset, K) axis in chunks of 64
//   columns (128 bytes of a gathered row). K must be a multiple of 8, so
//   that no 16-byte piece straddles two offsets. A stage holds a chunk's
//   gathered A rows ([BM][36 words], a -1 neighbour zero-fills) and its B
//   tile ([BNB][64], 128-byte swizzle), filled by cp.async, 16 bytes a
//   thread; gathered rows rule out TMA's tiled copies.
// - wgmma.m64nNk16.f32.bf16.bf16, A from registers (bf16 pairs loaded from
//   the padded tile, conflict-free), four k-steps a chunk.
// The tensor cores truncate their fp32 sums (csrc/subm_conv.cu). Each
// k-step's wgmma starts from a zero accumulator, and the k-step sums are
// added on the CUDA cores in fp32 (round to nearest), in k order, without
// untruncate (PERF.md §6). With round_taps, the k-step sums of one tap are
// added apart, rounded to bf16 when the tap's channels end, then added to
// the output's sum; a k-step that holds the last 8 channels of one tap and
// the first 8 of the next (K = 8, or K an odd multiple of 8) is taken as
// two wgmmas, each with the other half of its A fragment zeroed. Two forms
// of the loop add the same k-step sums in the same order (the paired one
// also adds the exact zeros of a k-step no row of its tile needs), so that
// their outputs are equal bit for bit:
// - unpaired (Cout <= 32, or <= 64 with round_taps: levels 0 and 1): the
//   design before, one stage and one accumulator, a wait after each
//   k-step; the fewest registers and the least shared memory, so the most
//   blocks an SM, which there is worth more than the overlap (PERF.md §6);
// - paired (the others): two accumulators take a chunk's four k-steps in
//   turn, k-step s + 1 issued before k-step s's sum is added
//   (wgmma.wait_group 1, every wgmma of a chunk retired within it, so that
//   ptxas keeps them in flight), over a ring of up to three stages: while
//   chunk c is multiplied, the copies of the next ones are in flight.
// - The deep levels have too few tiles to fill the card, so the chunks of a
//   tile are split over the z blocks of a thread-block cluster (at most 8),
//   each split whole taps. Each block leaves its partial sums in its shared
//   memory; after a cluster barrier each block adds, for its share of the
//   tile's entries, the splits' partials in split order through distributed
//   shared memory and writes the output. Every output is summed in a fixed
//   order with no atomics; every row is written once, invalid rows as
//   exact zeros. A conv is two launches: the prologue and this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KOFF = 27;
constexpr int NT = 256;         // two warpgroups
constexpr int BK = 64;          // chunk of the flattened (offset, K) axis: 128 bytes of bf16
constexpr int KS = 16;          // bf16 values a wgmma k-step
constexpr int AS = 36;          // A tile row stride in 32-bit words (32 words of data)
constexpr int SM_SHARED = 233472;  // shared memory of an SM (228 KB), 1 KB of it a block's
constexpr int MAX_CLUSTER = 8;

// The tile of a block: WGN warpgroups side by side on the columns (1 or 2),
// BN columns a warpgroup; PAIRED: the k-steps of a chunk in turn on two
// accumulators, with a ring of stages, else one accumulator and one stage.
// Registers: the k-step accumulators, the running sum and, with ROUND, the
// tap's sum, BN / 2 each, plus about 32 (sparse/conv.py:k1_bf16_regs makes
// the same estimate). A PAIRED tile asks for two blocks an SM where that
// estimate is at most 128 (the launch bound's minimum), and takes the most
// stages up to MAX_STAGES that let them share the SM's shared memory.
constexpr int MAX_STAGES = 3;
// A block's shared memory: the stages (or a split's partials, where more),
// the [BM][27] neighbour rows, the [BM] output rows, alignment slack.
constexpr int tile_bytes(int stages, int stage, int bm, int red) {
  return (stages * stage + bm * KOFF * 4 > red ? stages * stage + bm * KOFF * 4 : red) + bm * 4 +
         1024;
}
constexpr int fit_stages(int stages, int blocks, int stage, int bm, int red) {
  return stages == 1 || blocks * (tile_bytes(stages, stage, bm, red) + 1024) <= SM_SHARED
             ? stages
             : fit_stages(stages - 1, blocks, stage, bm, red);
}
template <int BN, int WGN, bool ROUND, bool PAIRED>
struct Layout {
  static constexpr int BM = 128 / WGN;                       // rows a block
  static constexpr int BNB = BN * WGN;                       // columns a block
  static constexpr int REGS = ((PAIRED ? 2 : 1) + (ROUND ? 2 : 1)) * BN / 2 + 32;
  static constexpr int BLOCKS = PAIRED && REGS <= 128 ? 2 : 1;
  static constexpr int B_BYTES = BNB * 128;                  // [BNB][64] bf16, swizzled
  static constexpr int A_BYTES = BM * AS * 4;
  static constexpr int STAGE = B_BYTES + A_BYTES;            // a multiple of 1024
  static constexpr int RED = BM * BNB * 4;  // a split's partials, over the stages and nbs
  static constexpr int STAGES = PAIRED ? fit_stages(MAX_STAGES, BLOCKS, STAGE, BM, RED) : 1;
  static constexpr int NBS = STAGES * STAGE;                 // [BM][27] neighbour rows
  static constexpr int BYTES = tile_bytes(STAGES, STAGE, BM, RED);
  static constexpr int ROWS = BYTES - BM * 4 - 1024;         // [BM] output rows
  static constexpr int A_ROWS = BM * 8 / NT;                 // gathered rows a thread and chunk
  static_assert(STAGE % 1024 == 0 && BYTES <= SM_SHARED - 1024, "K1-bf16 tile does not fit");
};

#include "conv_common.cuh"

// d[64 x N] = a[64 x 16] (registers, bf16 pairs) * b[16 x N] (shared, bf16,
// K-major); the accumulator's input is ignored (scale-d 0).
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma<80>(float (&d)[40], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma<112>(float (&d)[56], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(0));
}

__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// The prologue, one launch: blocks [0, a_blocks) write the bf16 table a
// [V, K] from feats [V, k_real] fp32 (columns past k_real 0; 8 values a
// thread where k_real = K and feats is 16-byte aligned, else one); the
// rest write B in bf16, laid out as the main kernel's shared memory wants
// it: for chunk c and column tile t, a [BNB][64] tile, rows 128 bytes with
// their 16-byte pieces (8 values) swizzled (piece q of row n at q ^ (n % 8)).
// Element (n, col) is bf16(B[k][t * BNB + n][ch]) with (k, ch) =
// divmod(c * 64 + col, K), read through the strides (sk, sn, sc), and 0 past
// the k_real real columns or the N rows.
__global__ void subm_conv_bf16_prologue_kernel(const float* __restrict__ f,
                                               __nv_bfloat16* __restrict__ a, long long a_items,
                                               int vec, int K, int k_real,
                                               const float* __restrict__ b, long long sk,
                                               long long sn, long long sc,
                                               __nv_bfloat16* __restrict__ bt, int N, int BNB,
                                               long long b_elems, unsigned a_blocks) {
  if (blockIdx.x < a_blocks) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= a_items) return;
    if (vec) {  // 8 values: two float4 in, one 16-byte piece out
      const float4 x = reinterpret_cast<const float4*>(f)[2 * e];
      const float4 y = reinterpret_cast<const float4*>(f)[2 * e + 1];
      __nv_bfloat162 o[4] = {__floats2bfloat162_rn(x.x, x.y), __floats2bfloat162_rn(x.z, x.w),
                             __floats2bfloat162_rn(y.x, y.y), __floats2bfloat162_rn(y.z, y.w)};
      reinterpret_cast<uint4*>(a)[e] = *reinterpret_cast<const uint4*>(o);
    } else {
      const long long v = e / K;
      const int ch = static_cast<int>(e - v * K);
      a[e] = __float2bfloat16_rn(ch < k_real ? f[v * k_real + ch] : 0.f);
    }
    return;
  }
  const long long e = (long long)(blockIdx.x - a_blocks) * blockDim.x + threadIdx.x;
  if (e >= b_elems) return;
  const int col = static_cast<int>(e % BK);
  const int n = static_cast<int>((e / BK) % BNB);
  const long long tile = e / ((long long)BK * BNB);
  const int n_tiles = (N + BNB - 1) / BNB;
  const int c = static_cast<int>(tile / n_tiles), t = static_cast<int>(tile % n_tiles);
  const int flat = c * BK + col, k = flat / K, ch = flat - k * K, nn = t * BNB + n;
  const float x = flat < KOFF * K && ch < k_real && nn < N ? b[k * sk + nn * sn + ch * sc] : 0.f;
  bt[tile * BNB * BK + n * BK + ((((col >> 3) ^ (n & 7)) << 3) | (col & 7))] =
      __float2bfloat16_rn(x);
}

// The output of a block's [BM][BNB] tile, sum[4i + 2h + e] = D[ar + 8h][8i
// + 2 t4 + e] of the warpgroup's 64 x BN part at column cw of the block:
// written where the reduction is whole, else, split over the cluster's z
// blocks, each block's partials left in its shared memory (over the
// stages), and each block adds its share of the entries over the splits in
// split order through distributed shared memory.
template <int BN, int BM, int BNB>
__device__ __forceinline__ void write_tile(const float (&sum)[BN / 2], uint8_t* smem,
                                          const int32_t* rows, int ar, int cw, int t4,
                                          const uint8_t* __restrict__ valid,
                                          float* __restrict__ out, int N) {
  const int n0 = blockIdx.y * BNB;
  if (gridDim.z == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rows[ar + 8 * h];
      if (row < 0) continue;
      const bool ok = valid[row] != 0;
      float* dst = out + (size_t)row * N;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + cw + 8 * i + 2 * t4 + e;
          if (col < N) dst[col] = ok ? sum[4 * i + 2 * h + e] : 0.f;
        }
    }
    return;
  }
  cp_async_wait<0>();
  __syncthreads();  // no warpgroup still reads a stage
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[(ar + 8 * h) * BNB + cw + 8 * i + 2 * t4 + e] = sum[4 * i + 2 * h + e];
  cluster_sync();
  const int splits = gridDim.z, rank = blockIdx.z;  // the cluster spans z
  for (int e = rank * NT + threadIdx.x; e < BM * BNB; e += splits * NT) {
    const int row = rows[e / BNB], col = n0 + e % BNB;
    if (row < 0 || col >= N) continue;
    const uint32_t local = smem_u32(red + e);
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ld_cluster(cluster_addr(local, z));
    out[(size_t)row * N + col] = valid[row] ? s : 0.f;
  }
  cluster_sync();  // no block leaves while another may still read its partials
}

// Unpaired (two 64-row tiles a block by BN columns): the design before, one
// stage and one accumulator, a wait after each k-step; the fewest
// registers and the least shared memory, so the most blocks an SM, and the
// fastest of the forms at Cout 32, and at 64 with round_taps (PERF.md §6).
// Its loop is kept as it was written: the same loop built from the paired
// kernel's helpers took more registers a thread, and a block less an SM.
template <int BN, bool ROUND>
__global__ void __launch_bounds__(NT)
subm_conv_bf16_kernel_unpaired(const __nv_bfloat16* __restrict__ a,
                               const int32_t* __restrict__ nbr,
                               const __nv_bfloat16* __restrict__ bt,
                               const uint8_t* __restrict__ valid,
                               const int32_t* __restrict__ order,
                               const int32_t* __restrict__ tile_mask, float* __restrict__ out,
                               int V, int K, int N, int chunks_per_split) {
  using L = Layout<BN, 1, ROUND, false>;
  constexpr int BM = L::BM, WG = 2;
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
    for (int i = 0; i < L::A_ROWS; ++i) {
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
    wgmma<BN>(acc, x, desc_sw128(b_s + s * 32));  // the k-step's sum starts at 0
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
  write_tile<BN, BM, BN>(sum, smem, rows, ar, 0, t4, valid, out, N);
}

template <int BN, int WGN, bool ROUND>
__global__ void __launch_bounds__(NT, (Layout<BN, WGN, ROUND, true>::BLOCKS))
subm_conv_bf16_kernel(const __nv_bfloat16* __restrict__ a, const int32_t* __restrict__ nbr,
                      const __nv_bfloat16* __restrict__ bt, const uint8_t* __restrict__ valid,
                      const int32_t* __restrict__ order, const int32_t* __restrict__ tile_mask,
                      float* __restrict__ out, int V, int K, int N, int chunks_per_split) {
  using L = Layout<BN, WGN, ROUND, true>;
  constexpr int BM = L::BM, BNB = L::BNB, S = L::STAGES, WGM = 2 / WGN;
  constexpr int P = S - 1;  // chunks in flight past the one multiplied
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
  // the OR-masks of the block's 64-row tiles: the block loads a chunk any
  // needs, each warpgroup multiplies only what its own tile needs
  const int n_masks = (V + 63) / 64;
  uint32_t mask = 0;
#pragma unroll
  for (int w = 0; w < WGM; ++w) {
    const int idx = blockIdx.x * WGM + w;
    mask |= idx < n_masks ? static_cast<uint32_t>(tile_mask[idx]) : 0u;
  }
  const int my_idx = blockIdx.x * WGM + (WGN == 1 ? wg : 0);
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
  // A chunk whose offsets no row of the block has gathers only zeros:
  // skipping it leaves every sum as it was (finite weights).
  auto next_live = [&](int c) {
    while (c < c_end && !(mask & span(c * BK, BK))) ++c;
    return c;
  };

  // this thread's 16-byte piece (8 values) of each gathered row, and its rows
  const int p = tid & 7, r0 = tid >> 3;
  const __nv_bfloat16* b_src = bt + (size_t)blockIdx.y * BNB * BK;
  const size_t b_chunk = (size_t)gridDim.y * BNB * BK;
  const uint32_t s0 = smem_u32(smem);
  auto load = [&](int c, int st) {
    const uint32_t b_s = s0 + st * L::STAGE, a_s = b_s + L::B_BYTES;
    const int col = c * BK + p * 8;
    const int k = col / K, ch = col - k * K;
    const bool in = col < KF;
#pragma unroll
    for (int i = 0; i < L::A_ROWS; ++i) {
      const int r = r0 + i * (NT / 8);
      const int j = in ? nbs[r * KOFF + k] : -1;
      cp_async16(a_s + r * AS * 4 + p * 16, a + (size_t)max(j, 0) * K + ch, j >= 0);
    }
    const __nv_bfloat16* src = b_src + c * b_chunk;
#pragma unroll
    for (int e = tid; e < BNB * 8; e += NT) cp_async16(b_s + 16 * e, src + 8 * e, true);
  };

  // the two k-step accumulators (tensor cores), the running sum, the
  // current tap's sum (ROUND)
  float acc0[BN / 2], acc1[BN / 2], sum[BN / 2], tap[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc0[i] = acc1[i] = sum[i] = tap[i] = 0.f;

  // this thread's A rows: ar, ar + 8; its warpgroup's B columns
  const int ar = (WGN == 1 ? 64 * wg : 0) + 16 * ((tid >> 5) & 3) + g;
  const uint32_t b_off = WGN == 2 ? wg * BN * 128 : 0;

  // a k-step's sum, its wgmma complete, joins the tap's sum (ROUND) or the
  // running sum; with ROUND, where the tap's channels end (ends_tap), the
  // tap's sum, rounded to bf16, joins the running sum
  auto settle = [&](float (&acc)[BN / 2], bool ends_tap) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      asm volatile("" : "+f"(acc[i])::"memory");  // read acc only after the wait
      if (ROUND)
        tap[i] = __fadd_rn(tap[i], acc[i]);
      else
        sum[i] = __fadd_rn(sum[i], acc[i]);
    }
    if (ROUND && ends_tap) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        sum[i] = __fadd_rn(sum[i], __bfloat162float(__float2bfloat16_rn(tap[i])));
        tap[i] = 0.f;
      }
    }
  };
  // one wgmma into acc, a k-step's sum from zero, its own commit group
  auto mma = [&](float (&acc)[BN / 2], const uint32_t (&x)[4], uint32_t b) {
    wgmma_fence();
    wgmma<BN>(acc, x, desc_sw128(b));
    wgmma_commit();
  };
  // the A fragment of k-step s, bf16 pairs: columns (2 t4, 2 t4 + 1) and
  // (2 t4 + 8, 2 t4 + 9) of rows ar and ar + 8
  auto frag = [&](uint32_t (&x)[4], const uint32_t* as, int s) {
    x[0] = as[ar * AS + 8 * s + t4];
    x[1] = as[(ar + 8) * AS + 8 * s + t4];
    x[2] = as[ar * AS + 8 * s + t4 + 4];
    x[3] = as[(ar + 8) * AS + 8 * s + t4 + 4];
  };
  // with ROUND, whether a tap's channels end with the k-step at column col
  auto ends = [&](int col) { return ROUND && ((col + KS) % K == 0 || col + KS >= KF); };
  // one k-step at column col on its own: its wgmma, then its sum added
  auto serial_kstep = [&](const uint32_t* as, uint32_t b_s, int s, int col) {
    uint32_t x[4];
    frag(x, as, s);
    if (ROUND && (col + 8) % K == 0 && col + 8 < KF) {
      // a tap ends after the first 8 columns: each half on its own
      const uint32_t lo[4] = {x[0], x[1], 0u, 0u}, hi[4] = {0u, 0u, x[2], x[3]};
      mma(acc0, lo, b_s + s * 32);
      wgmma_wait<0>();
      settle(acc0, true);
      mma(acc0, hi, b_s + s * 32);
    } else {
      mma(acc0, x, b_s + s * 32);
    }
    wgmma_wait<0>();
    settle(acc0, ends(col));
  };

  {
    // The four k-steps of a chunk in turn on two accumulators, one wgmma
    // each, where no k-step holds the end of one tap and the start of the
    // next (always without ROUND; with it where K is a multiple of 16).
    const bool paired = !ROUND || K % 16 == 0;
    int cn = next_live(c_begin);  // the next chunk to load
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (cn < c_end) {
        load(cn, i);
        cn = next_live(cn + 1);
      }
      cp_async_commit();
    }
    int ld_st = P, st = 0;
    // Every warpgroup's wgmmas of a chunk complete within it: past the
    // barrier at the top of chunk c, the stage of chunk c - 1 is free for
    // chunk c + P.
    auto load_next = [&]() {
      if (cn < c_end) {
        load(cn, ld_st);
        cn = next_live(cn + 1);
      }
      cp_async_commit();
      ld_st = ld_st + 1 == S ? 0 : ld_st + 1;
    };
    for (int c = next_live(c_begin); c < c_end; c = next_live(c + 1)) {
      if (P == 0) {  // one stage: chunk c itself is loaded here
        __syncthreads();
        load_next();
      }
      cp_async_wait<(P > 0 ? P - 1 : 0)>();  // chunk c has landed
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      if (P > 0) load_next();
      const uint32_t b_s = s0 + st * L::STAGE + b_off;
      const uint32_t* as = reinterpret_cast<const uint32_t*>(smem + st * L::STAGE + L::B_BYTES);
      st = st + 1 == S ? 0 : st + 1;
      const int c0 = c * BK;
      // warpgroup-uniform: no row of the tile has an offset here, and its A
      // columns are all zero
      if (!(my_mask & span(c0, BK))) continue;
      if (paired) {
        // k-step s + 1 is issued before k-step s's sum is added: the adds of
        // one overlap the products of the next. A k-step past the last tap,
        // or of an offset no row of the tile has, adds zeros.
        uint32_t xa[4], xb[4];
        frag(xa, as, 0);
        mma(acc0, xa, b_s);
        frag(xb, as, 1);
        mma(acc1, xb, b_s + 32);
        wgmma_wait<1>();
        settle(acc0, ends(c0));
        frag(xa, as, 2);
        mma(acc0, xa, b_s + 64);
        wgmma_wait<1>();
        settle(acc1, ends(c0 + KS));
        frag(xb, as, 3);
        mma(acc1, xb, b_s + 96);
        wgmma_wait<1>();
        settle(acc0, ends(c0 + 2 * KS));
        wgmma_wait<0>();
        settle(acc1, ends(c0 + 3 * KS));
      } else {
#pragma unroll
        for (int s = 0; s < BK / KS; ++s) {
          const int col = c0 + s * KS;
          if (col < KF && (my_mask & span(col, KS))) serial_kstep(as, b_s, s, col);
        }
      }
    }
  }

  write_tile<BN, BM, BNB>(sum, smem, rows, ar, WGN == 2 ? wg * BN : 0, t4, valid, out, N);
}

template <int BN, int WGN, bool ROUND, bool PAIRED>
cudaError_t launch(const __nv_bfloat16* a, const int32_t* nbr, const __nv_bfloat16* bt,
                   const uint8_t* valid, const int32_t* order, const int32_t* tile_mask,
                   float* out, int V, int K, int N, int splits, int chunks_per_split,
                   cudaStream_t st) {
  using L = Layout<BN, WGN, ROUND, PAIRED>;
  auto kernel = [] {
    if constexpr (PAIRED)
      return subm_conv_bf16_kernel<BN, WGN, ROUND>;
    else
      return subm_conv_bf16_kernel_unpaired<BN, ROUND>;
  }();
  // on a device's first launch, allow the kernel its shared memory
  constexpr int MAX_DEVICES = 64;
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((V + L::BM - 1) / L::BM, (N + L::BNB - 1) / L::BNB, splits);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = static_cast<unsigned>(splits);
  cfg.attrs = &attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a, nbr, bt, valid, order, tile_mask, out, V, K, N,
                           chunks_per_split);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const __nv_bfloat16*, const int32_t*, const __nv_bfloat16*,
                                 const uint8_t*, const int32_t*, const int32_t*, float*, int, int,
                                 int, int, int, cudaStream_t);

// The instantiated tiles, (wgn, bn, round_taps, paired): sparse/conv.py:
// K1_BF16_TILES lists the same, and k1_bf16_schedule picks among them.
Launcher launcher(int wgn, int bn, int round_taps, int paired) {
  if (wgn == 1 && !paired) {
    if (bn == 32) return round_taps ? launch<32, 1, true, false> : launch<32, 1, false, false>;
    if (bn == 64 && round_taps) return launch<64, 1, true, false>;
  }
  if (wgn == 1 && paired && bn == 64 && !round_taps) return launch<64, 1, false, true>;
  if (wgn != 2 || !paired) return nullptr;
  switch (bn) {
    case 48: return round_taps ? launch<48, 2, true, true> : launch<48, 2, false, true>;
    case 64: return round_taps ? launch<64, 2, true, true> : launch<64, 2, false, true>;
    case 80: return round_taps ? launch<80, 2, true, true> : launch<80, 2, false, true>;
    case 96: return round_taps ? launch<96, 2, true, true> : launch<96, 2, false, true>;
    case 112: return round_taps ? nullptr : launch<112, 2, false, true>;
    default: return nullptr;
  }
}

}  // namespace

// feats [V, k_real] fp32 contiguous; a [V, K] bf16 scratch (K a multiple of
// 8, k_real <= K); nbr [V, 27] i32; b: B[k][n][c] fp32 at b[k * sk + n * sn
// + c * sc] for c < k_real; bt bf16 scratch of ceil(27 K / 64) chunks x
// ceil(N / (wgn bn)) tiles x (wgn bn) x 64 elements; valid [V] u8; order [V]
// i32 (a permutation of the rows); tile_mask [ceil(V / 64)] i32 (the OR of
// each 64-row tile's neighbour masks under order); out [V, N] f32; all on
// the current device, contiguous but b. The schedule (bn, wgn, splits at
// most 8, chunks_per_split, whole taps a split) is
// sparse/conv.py:k1_bf16_schedule's. round_taps 1 rounds each tap's sum to
// bf16 (the window kernel's function). Returns the cudaError_t of the
// launches.
extern "C" int gapro_subm_conv_bf16_fwd(const float* feats, int k_real, void* a,
                                        const int32_t* nbr, const float* b, long long sk,
                                        long long sn, long long sc, void* bt,
                                        const uint8_t* valid, const int32_t* order,
                                        const int32_t* tile_mask, float* out, int V, int K,
                                        int N, int bn, int wgn, int paired, int splits,
                                        int chunks_per_split, int round_taps, void* stream) {
  if (V == 0) return 0;
  const Launcher run = launcher(wgn, bn, round_taps, paired);
  if (!run || splits < 1 || splits > MAX_CLUSTER || chunks_per_split < 1 || K % 8 != 0 ||
      k_real > K)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bnb = bn * wgn;
  const long long b_elems =
      (long long)((KOFF * K + BK - 1) / BK) * ((N + bnb - 1) / bnb) * bnb * BK;
  const int vec = k_real == K && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  const long long a_items = (long long)V * K / (vec ? 8 : 1);
  const unsigned a_blocks = static_cast<unsigned>((a_items + 255) / 256);
  const unsigned b_blocks = static_cast<unsigned>((b_elems + 255) / 256);
  __nv_bfloat16* ab = static_cast<__nv_bfloat16*>(a);
  __nv_bfloat16* btb = static_cast<__nv_bfloat16*>(bt);
  subm_conv_bf16_prologue_kernel<<<a_blocks + b_blocks, 256, 0, st>>>(
      feats, ab, a_items, vec, K, k_real, b, sk, sn, sc, btb, N, bnb, b_elems, a_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run(ab, nbr, btb, valid, order, tile_mask, out, V, K, N, splits, chunks_per_split, st);
  return static_cast<int>(err);
}
