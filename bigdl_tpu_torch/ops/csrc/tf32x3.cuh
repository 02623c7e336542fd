// Float32 products on Hopper's tensor cores at float32 accuracy ("3xTF32"),
// and the cp.async copies that stage their tiles, for the block-sparse
// product (block_sparse_matmul.cu) and the flash backward
// (flash_attention_bwd.cu).
//
// A TF32 tensor-core product reads the top 11 significant bits of each
// float32 operand (10 explicit mantissa bits).  Each operand x is split
// into hi, x rounded to nearest TF32 (half a TF32 step added to the bit
// pattern, the low 13 bits cleared: two integer instructions, the rounding
// cvt.rna.tf32.f32 does, and measured faster than it on the card), and
// lo = x - hi (one float32 subtraction, exact), of which the tensor core
// reads the top 11 bits.  Then
//
//   a b  ~  a_hi b_hi + a_hi b_lo + a_lo b_hi
//
// drops only a_lo b_lo and the truncation of lo, each below 2^-22 of
// |a b|, against 2^-11 for one TF32 product: the three products,
// accumulated in float32, agree with a float32 CUDA-core product to within
// float32 summation noise.  (hi truncated instead of rounded saves one
// instruction but leaves 2^-20, which the card tests' attention gradients
// notice.)  The three products of a call site go in three passes over
// independent accumulators (small products first), so no mma waits on the
// one before it.  The tensor core adds into its accumulator with
// truncation, which biases long sums; callers that sum many k-steps add
// each tile's partial sum into a float32 total.
//
// mma.sync.m16n8k8 (TF32 in, float32 accumulators) fragment layout, with
// g = lane / 4 and t = lane % 4:
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4)
//   B (8 x 8, k x n):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// hi = x rounded to nearest TF32 (ties away from zero), lo = x - hi, as
// 32-bit patterns for mma
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return Split{hi, __float_as_uint(__fsub_rn(x, __uint_as_float(hi)))};
}

// An A fragment (4 values) and a B fragment (2 values), split.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  const float v[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.hi[i] = s.hi;
    f.lo[i] = s.lo;
  }
  return f;
}

__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  const Split s0 = split(b0), s1 = split(b1);
  f.hi[0] = s0.hi;
  f.lo[0] = s0.lo;
  f.hi[1] = s1.hi;
  f.lo[1] = s1.lo;
  return f;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a b[i] for N independent accumulators at float32 accuracy: the
// three TF32 passes, small products first
template <int N>
__device__ __forceinline__ void mma3(float (&c)[N][4], const FragA& a,
                                     const FragB (&b)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a.lo, b[i].hi);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a.hi, b[i].lo);
#pragma unroll
  for (int i = 0; i < N; ++i) mma(c[i], a.hi, b[i].hi);
}

// cp.async: `bytes` (4 or 16) from global `src` to shared `dst`, or zeros
// when `pred` is false (src is then not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
