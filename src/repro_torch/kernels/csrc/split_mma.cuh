// fp32-accurate matrix products on Hopper's tensor cores through an
// error-compensated TF32 split; shared by flash_attention.cu and
// ssd_scan.cu.
//
// The split: an fp32 x is cut into hi = TF32(x) (cvt.rna: round to nearest,
// ties away, 10 explicit mantissa bits) and lo = TF32(x − hi).  x − hi is
// exact in fp32, and lo carries the next 11 significant bits, so hi + lo
// holds x to about 2^-22 relative.  A product a·b is taken as
//
//   lo_a·hi_b + hi_a·lo_b + hi_a·hi_b      (lo_a·lo_b, ~2^-22, dropped)
//
// three TF32 products accumulated in fp32 by the tensor core (each TF32
// product is exact in fp32: 11 × 11 significant bits).  The two small terms
// are issued first, so that they meet the accumulator before hi·hi grows
// it.  A single TF32 product keeps only ~2^-11 of each operand, which the
// kernels' fp32 tolerances catch (tests/test_torch_split_products.py).
//
// An operand that is exact in TF32 (a bf16 value, a zero) has lo = 0, so
// its lo terms are skipped at compile time (the A_EXACT / B_EXACT template
// flags of mma3): 2 products where one side is exact, 1 where both are.
//
// Fragment layouts (PTX ISA, mma.sync.aligned.m16n8k8 .tf32 and
// m16n8k16 .bf16, fp32 accumulators; g = lane / 4, t = lane % 4):
//
//   m16n8k8 tf32   A (16 × 8, row):  a0 (g, t)   a1 (g+8, t)
//                                    a2 (g, t+4) a3 (g+8, t+4)
//                  B (8 × 8, col):   b0 (t, g)   b1 (t+4, g)
//   m16n8k16 bf16  A (16 × 16):      a0 (g, 2t..2t+1)   a1 (g+8, 2t..2t+1)
//                                    a2 (g, 2t+8..+9)   a3 (g+8, 2t+8..+9)
//                  B (16 × 8):       b0 (2t..2t+1, g)   b1 (2t+8..+9, g)
//   C / D (16 × 8), both:            c0 (g, 2t) c1 (g, 2t+1)
//                                    c2 (g+8, 2t) c3 (g+8, 2t+1)
//
// Since a product sums over k, the kernels may number k in any order that
// A and B share.  They take the TF32 product's k index t to mean column 2t
// and t+4 to mean 2t+1 of each group of eight (`kperm`): then a0, a2 (and
// b0, b1) are two neighbouring elements, one 8-byte load, and an
// accumulator fragment (c0, c1 at columns 2t, 2t+1) is already an A
// fragment of the next product over those columns, with no shuffle.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace split_mma {

// TF32 of x, round to nearest (ties away), as a 32-bit pattern
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

// an A fragment (4 registers) and a B fragment (2 registers), split
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  const float v[4] = {a0, a1, a2, a3};
  FragA f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split s = split(v[i]);
    f.hi[i] = s.hi;
    f.lo[i] = s.lo;
  }
  return f;
}

__device__ __forceinline__ FragB split_b(float b0, float b1) {
  const Split s0 = split(b0), s1 = split(b1);
  return {{s0.hi, s1.hi}, {s0.lo, s1.lo}};
}

// d += a·b, one m16n8k8 TF32 product (not volatile: the compiler may
// interleave the independent products of neighbouring tiles)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b, one m16n8k16 bf16 product (each register: two bf16, the lower
// k index in the low half)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a·b to fp32 accuracy: the small terms first, then hi·hi; an operand
// exact in TF32 (A_EXACT, B_EXACT) has lo = 0 and its terms are not issued
template <bool A_EXACT = false, bool B_EXACT = false>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (!A_EXACT) mma_tf32(d, a.lo, b.hi);
  if constexpr (!B_EXACT) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// two bf16 (lo, hi) packed into one register: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// (x, y) as bf16 hi parts (round to nearest even) and the bf16 remainders
// x − hi, y − hi: x ≈ hi + lo to about 2^-17 relative
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pack_bf16(hx, hy);
  lo = pack_bf16(__float2bfloat16_rn(x - __bfloat162float(hx)),
                 __float2bfloat16_rn(y - __bfloat162float(hy)));
}

// 16-byte copy global → shared that bypasses the registers (cp.async.cg);
// src_bytes 0 fills the 16 bytes with zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace split_mma
