// The 3xTF32 split and the warp-level TF32 product (mma.sync m16n8k8),
// shared by the tensor-core GEMMs (tc_gemm.cu) and the f32 attention cores
// (encoder.cu, encoder_train.cu); the warp-level bf16 product (mma.sync
// m16n8k16) and its fragment loads, shared by the bf16 products'
// mma.sync kernels (bf16_gemm.cu) and the bf16 attention cores.
//
// A TF32 operand keeps 10 mantissa bits.  v = big + small + (less than
// 2^-21 of v), both parts exact TF32 values: big is v rounded to nearest
// (ties away from zero: half of the last kept bit added to the magnitude,
// then the low bits cleared; two integer operations, where cvt.rna.tf32.f32
// issues at a quarter of their rate), small the exact remainder v - big with
// its low bits cleared.  Truncating big would do for the accuracy of one
// product, but it shrinks every term the same way: a bias of 5e-7 of each
// output, which a gradient that is a small difference of large sums turns
// into a relative error of 1e-3.  The remainder of a rounded big has either
// sign, so clearing its low bits leans neither way.
//
// The tensor cores round toward zero when they add into their f32
// accumulator, so every user keeps a chain of products short: the products
// of one 32-deep slice start from zero (small terms first, then big x big)
// and the slices are added on the CUDA cores, rounding to nearest.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace gtt {

constexpr uint32_t kTf32Mask = 0xffffe000u;
constexpr uint32_t kTf32Half = 0x1000u;  // half of the last kept bit

__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(v) + kTf32Half) & kTf32Mask;
  small = __float_as_uint(v - __uint_as_float(big)) & kTf32Mask;
}

// d += a @ b over one 16 x 8 x 8 step.  Fragments (g = lane / 4, q = lane %
// 4): a0 (row g, k q), a1 (row g + 8, k q), a2 (row g, k q + 4), a3 (row
// g + 8, k q + 4); b0 (k q, col g), b1 (k q + 4, col g); d0, d1 (row g,
// cols 2q, 2q + 1), d2, d3 (row g + 8, the same cols).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The two small terms of one 3xTF32 step (issued before the big one).
__device__ __forceinline__ void mma_small_terms(float (&d)[4], const uint32_t (&a_big)[4],
                                                const uint32_t (&a_small)[4],
                                                const uint32_t (&b_big)[2],
                                                const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
}

// d += a @ b over one 16 x 8 x 16 bf16 step, f32 accumulation.  Fragments
// (g = lane / 4, q = lane % 4), each a pair of bf16 (the lower k in the low
// half): a0 (row g, k 2q, 2q + 1), a1 (row g + 8, the same k), a2 (row g,
// k 2q + 8, 2q + 9), a3 (row g + 8, those k); b0 (k 2q, 2q + 1, col g), b1
// (k 2q + 8, 2q + 9, col g); d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two neighbouring bf16 elements as one fragment register.
__device__ __forceinline__ uint32_t pair_at(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// B fragments (b0, b1) of a [k][n] row-major 16 x 8 bf16 block whose rows
// lanes 0-15 address (row lane & 15 of the block), transposed on the way.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// Four 8 x 8 bf16 blocks transposed (lanes 8i .. 8i + 7 address block i's
// rows): an A fragment of a [k][m] tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

}  // namespace gtt
