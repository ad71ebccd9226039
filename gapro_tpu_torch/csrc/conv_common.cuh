// Device helpers shared by the two conv kernels, subm_conv.cu (K1, and
// dfeats through it) and subm_conv_dw.cu (dW): cp.async copies into shared
// memory, the TF32 split of the 3xTF32 products, and untruncate. Each
// kernel includes this file inside its own anonymous namespace, after
// <cuda_runtime.h> and <stdint.h>.

#pragma once

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// x plus half an ulp of x away from zero, rounded to nearest even: x's
// neighbour away from zero when x's last bit is 1, else x. A sum the tensor
// cores truncated lies below the exact one by half an ulp on average; the
// tie this add makes rounds up or down alike, so the result is right on
// average. In the bits: b + (b & 1), the max keeping a NaN whose mantissa
// is all ones (the canonical one) from carrying into the sign; 0 stays 0.
__device__ __forceinline__ float untruncate(float x) {
  const int b = __float_as_int(x);
  return __int_as_float(max(static_cast<int>(static_cast<uint32_t>(b) + (b & 1)), b));
}
