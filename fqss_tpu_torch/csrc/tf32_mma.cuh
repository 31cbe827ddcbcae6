// 3xTF32 products on Hopper's tensor cores and the cp.async copies that feed
// them, shared by qat_dense.cu (K5, K5-bwd, K3) and attention.cu (K8); and
// the bf16 routes' rounding (K5, K3 and K8 under bf16 compute).
//
// A float32 value v splits into hi = v rounded to TF32 (10 mantissa bits, to
// nearest, ties away from zero: cvt.rna.tf32.f32's rounding, done on the
// integer view, which runs at four times the rate of a conversion on this
// card) and lo = v - hi (exact; the tensor cores read its top 10 mantissa
// bits). A float32 product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b:
// what is dropped is about 2^-21 of |a b|. The tensor cores' own accumulation
// truncates (it is not an IEEE sum), so a caller sums a bounded stage of
// products from zero and adds the stages with __fadd_rn.
//
// A bf16 route rounds each operand to bfloat16 and keeps it in float32 (its
// low 16 bits are zero): such a value is exact in TF32 (bf16 is a subset), and
// the product of two of them (8 x 8 significant bits) is exact in float32, so
// one TF32 product computes it, not three.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fqss {

// v = hi + lo + (a remainder of at most ~2^-21 |v|).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

// v rounded to bfloat16 (to nearest, ties to even, NaN kept: cvt.rn.bf16.f32), held in float32.
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// The TF32 operand bits of v rounded to bfloat16 (exact in TF32).
__device__ __forceinline__ uint32_t bf16_tf32(float v) { return __float_as_uint(round_bf16(v)); }

// d += a b over one k8 step of an m16n8 tile. Fragments (g = lane / 4, t = lane % 4): a0 (row g, slot t), a1 (row
// g + 8, slot t), a2 (row g, slot t + 4), a3 (row g + 8, slot t + 4); b0 (slot t, column g), b1 (slot t + 4,
// column g); d0, d1 (row g, columns 2t, 2t + 1), d2, d3 (row g + 8, the same columns).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b as 3xTF32: the two small cross products first, then hi hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2], const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// 16 bytes from global to shared memory (both 16-byte aligned); zeros where !ok.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
}

// The first `bytes` (0 to 16) of 16, the rest zero-filled.
__device__ __forceinline__ void cp_async16_bytes(float* dst, const float* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

// 4 bytes (both 4-byte aligned); zero where !ok.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace fqss
