// Pieces shared by the tensor-core attention kernels of the encoder layer's
// forward (encoder.cu) and backward (encoder_train.cu): a tile of rows of
// one head staged into shared memory, and the 16 x 32 score tile of a warp
// on the tensor cores (mma.sync, 3xTF32).
#pragma once

#include "encoder.cuh"
#include "mma.cuh"

namespace gtt {

constexpr int kTcQ = 32;                  // query rows a block (16 a warp)
constexpr int kTcKeys = 32;               // keys a shared-memory tile
constexpr int kTcStride = kAttnMaxD + 4;  // words a row: fragment loads hit 32 banks
constexpr int kTcND = kAttnMaxD / 8;      // n-tiles of the head width, at most

// Rows [r0, r0 + n) of a [t, d] head slice (row stride ld floats, d and
// the slice 16-byte aligned) into shared memory at row stride kTcStride,
// as they lie (the fragments are split as they are loaded); zeros past t.
// Four columns a copy, no division in the loop (threads >= d / 4).
__device__ __forceinline__ void stage_rows(const float* src, long ld, int r0, int n, int t,
                                           int d, float* dst, int tid, int threads) {
  const int d4 = d / 4;
  int r = tid / d4, c4 = tid - (tid / d4) * d4;
  const int step_r = threads / d4, step_c = threads - step_r * d4;
  for (; r < n; r += step_r) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t) v = *reinterpret_cast<const float4*>(src + (long)(r0 + r) * ld + 4 * c4);
    *reinterpret_cast<float4*>(dst + r * kTcStride + 4 * c4) = v;
    c4 += step_c;
    if (c4 >= d4) {
      c4 -= d4;
      ++r;
    }
  }
}

// big of the 3xTF32 split alone (split_tf32's)
__device__ __forceinline__ uint32_t tf32_big(float v) {
  return (__float_as_uint(v) + kTf32Half) & kTf32Mask;
}

// dot(x[0:d], y[0:d]) of two 16-byte aligned rows, in order
__device__ __forceinline__ float row_dot(const float* x, const float* y, int d) {
  float acc = 0.f;
  for (int c = 0; c < d; c += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + c);
    const float4 b = *reinterpret_cast<const float4*>(y + c);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// acc[n] (this warp's 16 rows x 8 keys of n-tile n) = the rows staged at
// a (fragment rows r_lo, r_lo + 8) dotted with the key rows 8 n + g staged
// at b, over the head width: 32-deep slices started from zero (small terms
// first, then big x big), added in f32.
__device__ __forceinline__ void tile_scores(float (&acc)[4][4], const float* a, const float* b,
                                            int r_lo, int g, int qd, int nd) {
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int s0 = 0; s0 < nd; s0 += 4) {
    float part[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (s0 + kk >= nd) break;
        const int col = (s0 + kk) * 8 + qd;
        const int lo = r_lo * kTcStride + col, hi = lo + 8 * kTcStride;
        const float av[4] = {a[lo], a[hi], a[lo + 4], a[hi + 4]};
        uint32_t ab[4], as[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (pass == 0) split_tf32(av[i], ab[i], as[i]);
          else ab[i] = tf32_big(av[i]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int kr = (n * 8 + g) * kTcStride + col;
          if (pass == 0) {
            uint32_t bb[2], bs[2];
            split_tf32(b[kr], bb[0], bs[0]);
            split_tf32(b[kr + 4], bb[1], bs[1]);
            mma_small_terms(part[n], ab, as, bb, bs);
          } else {
            const uint32_t bb[2] = {tf32_big(b[kr]), tf32_big(b[kr + 4])};
            mma_tf32(part[n], ab, bb);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

}  // namespace gtt
