// The bf16 chains' products (fp16_run): the conv-GEMM and the weight
// gradient as the JAX kernels compute them with dtype bf16,
// jnp.dot(a.astype(bf16), w, preferred_element_type=f32): each operand
// element rounded to bf16 as it is staged, bf16 x bf16 products on the
// tensor cores (mma.sync m16n8k16, f32 accumulation), the epilogue of the
// f32 chains with the bf16 roundings (epilogue.cuh, epilogue_cols_bf16).
//
// Every product of the bf16 chains takes these two kernels: A gathered as
// im2col while staging (taps, dilation, tap_sign, a_mask, as
// conv_gemm_kernel does), B read as it lies or through w_t's per-tap
// transpose, each of A, B and the epilogue's operands f32 or bf16
// (ConvGemm::bf16).  The f32 chains' tensor-core kernels (tc_gemm.cu) copy
// operands as they lie (cp.async, TMA) into the 3xTF32 layout; a bf16
// operand needs neither the split nor that layout, and an f32 operand of a
// bf16 chain (a cotangent) must be rounded on its way in, so these kernels
// stage through registers, 8 elements a load (16 bytes of bf16, or 32 of
// f32 rounded as they are packed): they take operands whose rows hold whole
// groups of 8 (conv_fits, wgrad_fits; every product at the shipped widths),
// and refuse the rest.
//
// conv_gemm_bf16_kernel: a 64 x 64 output tile per block of 128 threads (a
// warp 32 x 32: 2 x 4 mma tiles), 32-deep K slices double-buffered in
// shared memory with the next slice's loads in flight during the current
// one's mma; A [m][k] read by 32-bit pairs, B [n][k] the same (w_t) or
// [k][n] by ldmatrix.trans; the accumulator tile staged through shared
// memory to the epilogue (4 neighbouring columns a call).
//
// wgrad_bf16_kernel: out[kk, n] = sum over rows m of im2col(A)[m, kk] *
// dY[m, n] (times the row masks): a 64 (kk) x 64 (n) tile per block over
// one split of the rows, 32 rows a slice staged as they lie ([row][kk],
// [row][n]) and read transposed by ldmatrix.trans (the mma's k is the row
// axis); the splits' partial sums added in split order by a second pass,
// which writes the gradient in the weight's dtype (the JAX kernels'
// ``g.astype(w.dtype)``).  Its bias gradient is bias_grad of dY (f32: the
// unrounded cotangent, as the JAX kernels sum it).
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "epilogue.cuh"

namespace gtt {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kSK = kBK + 8;  // bf16 a shared-memory row: 80 bytes, conflict-free fragments

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pair_at(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc (2 m16 x 4 n8 tiles of this warp's 32 x 32) += the slice's product:
// as [m][k] and bs [n][k] (k contiguous), the warp's rows from wm, columns
// from wn.
__device__ __forceinline__ void slice_mma(float (&acc)[2][4][4], const __nv_bfloat16* as,
                                          const __nv_bfloat16* bs, int wm, int wn, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* r0 = as + (wm + 16 * i + g) * kSK + kk + 2 * q;
      const __nv_bfloat16* r1 = r0 + 8 * kSK;
      a[i][0] = pair_at(r0);
      a[i][1] = pair_at(r1);
      a[i][2] = pair_at(r0 + 8);
      a[i][3] = pair_at(r1 + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16* c0 = bs + (wn + 8 * j + g) * kSK + kk + 2 * q;
      b[j][0] = pair_at(c0);
      b[j][1] = pair_at(c0 + 8);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
}

// The warp's accumulators into the block's [kBM][kBN + 1] f32 tile.
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], float* tile, int wm,
                                           int wn, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wm + 16 * i + g + 8 * (e >> 1);
        const int c = wn + 8 * j + 2 * q + (e & 1);
        tile[r * (kBN + 1) + c] = acc[i][j][e];
      }
}

constexpr int kTileBytes = kBM * (kBN + 1) * 4;  // the accumulator tile, for the epilogue

constexpr int kWRows = 32;  // rows a slice of the weight gradient


constexpr int kSN = kBN + 8;  // a [k][n] bf16 row: 144 bytes, conflict-free ldmatrix rows

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

// Elements i .. i + 7 of an f32 or (b16) bf16 tensor, times m, as 8 bf16
// (rounded to nearest even after the multiply).
__device__ __forceinline__ uint4 load8(const float* p, long i, bool b16, float m) {
  uint4 r;
  if (b16) {
    r = *reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(p) + i);
    if (m != 1.f) {
      uint32_t* w = &r.x;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack2(w[e]);
        w[e] = pack2(f.x * m, f.y * m);
      }
    }
    return r;
  }
  const float4 a = *reinterpret_cast<const float4*>(p + i);
  const float4 b = *reinterpret_cast<const float4*>(p + i + 4);
  r.x = pack2(a.x * m, a.y * m);
  r.y = pack2(a.z * m, a.w * m);
  r.z = pack2(b.x * m, b.y * m);
  r.w = pack2(b.z * m, b.w * m);
  return r;
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// acc += the slice's product, A [m][k] (stride kSK) read by pairs, B either
// [n][k] (stride kSK, kBnk) or [k][n] (stride kSN, by ldmatrix.trans).
template <bool kBnk>
__device__ __forceinline__ void slice_mma_staged(float (&acc)[2][4][4], const __nv_bfloat16* as,
                                              const __nv_bfloat16* bs, int wm, int wn, int lane) {
  if (kBnk) {
    slice_mma(acc, as, bs, wm, wn, lane);
    return;
  }
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat16* r0 = as + (wm + 16 * i + g) * kSK + kk + 2 * q;
      const __nv_bfloat16* r1 = r0 + 8 * kSK;
      a[i][0] = pair_at(r0);
      a[i][1] = pair_at(r1);
      a[i][2] = pair_at(r0 + 8);
      a[i][3] = pair_at(r1 + 8);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ldmatrix_x2_trans(b[j], bs + (kk + (lane & 15)) * kSN + wn + 8 * j);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
  }
}

// double-buffered A and B slices, B either way round
constexpr int kBStage = kBK * kSN > kBN * kSK ? kBK * kSN : kBN * kSK;
constexpr int kStageBytes = 2 * (kBM * kSK + kBStage) * 2;
constexpr int kSmemBytes = kStageBytes > kTileBytes ? kStageBytes : kTileBytes;

template <bool kWT>
__global__ void __launch_bounds__(128) conv_gemm_bf16_kernel(const ConvGemm g) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBM][kSK]
  __nv_bfloat16* bs = as + 2 * kBM * kSK;                        // [2][kBStage]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int rows = g.batch * g.t;
  const int kdim = g.taps * g.c_in;
  const int half_taps = g.taps / 2;
  const bool a16 = has(g.bf16, kA16);
  const int ldb = g.ldb ? g.ldb : g.n;
  const bool pair = paired(g.epilogue);

  // A: units tid and tid + 128, row u / 4 and the k group u % 4 (8 k's)
  int a_row0[2], a_t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid + 128 * i) / 4;
    const int b = m / g.t;
    a_row0[i] = m < rows ? b * g.t : -1;
    a_t[i] = m - b * g.t;
  }
  uint4 ra[2], rb[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + 128 * i;
      const int kidx = k0 + 8 * (u % 4);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kidx < kdim && a_row0[i] >= 0) {
        const int tap = kidx / g.c_in;
        const int c = kidx - tap * g.c_in;
        const int ts = a_t[i] + g.tap_sign * (tap - half_taps) * g.dilation;
        if (ts >= 0 && ts < g.t) {
          const long src = (long)a_row0[i] + ts;
          v = load8(g.a, src * g.lda + c, a16, g.a_mask ? g.a_mask[src] : 1.f);
        }
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + 128 * i;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (kWT) {  // B[tap * c_in + j, col] = w[tap * n + col, j]: 8 k's of column u / 4
        const int n = n0 + u / 4, kidx = k0 + 8 * (u % 4);
        if (n < g.n && kidx < kdim) {
          const int tap = kidx / g.c_in;
          v = load8(g.w, ((long)tap * g.n + physical_col(g, n)) * g.c_in + (kidx - tap * g.c_in),
                    true, 1.f);
        }
      } else {  // K row u / 8, 8 logical columns from 8 (u % 8)
        const int kr = k0 + u / 8, n = n0 + 8 * (u % 8);
        if (kr < kdim && n < g.n) {
          const __nv_bfloat16* w = reinterpret_cast<const __nv_bfloat16*>(g.w) + (long)kr * ldb;
          if (pair) {  // logical 2j + e is column j + e * split: two runs of 4
            const uint2 lo = *reinterpret_cast<const uint2*>(w + n / 2);
            const uint2 hi = *reinterpret_cast<const uint2*>(w + n / 2 + g.split);
            v = make_uint4(__byte_perm(lo.x, hi.x, 0x5410), __byte_perm(lo.x, hi.x, 0x7632),
                           __byte_perm(lo.y, hi.y, 0x5410), __byte_perm(lo.y, hi.y, 0x7632));
          } else {
            v = *reinterpret_cast<const uint4*>(w + n);
          }
        }
      }
      rb[i] = v;
    }
  };
  auto store = [&](int buf) {
    __nv_bfloat16* a_s = as + buf * kBM * kSK;
    __nv_bfloat16* b_s = bs + buf * kBStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + 128 * i;
      *reinterpret_cast<uint4*>(a_s + (u / 4) * kSK + 8 * (u % 4)) = ra[i];
      if (kWT) {
        *reinterpret_cast<uint4*>(b_s + (u / 4) * kSK + 8 * (u % 4)) = rb[i];
      } else {
        *reinterpret_cast<uint4*>(b_s + (u / 8) * kSN + 8 * (u % 8)) = rb[i];
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    const bool more = k0 + kBK < kdim;
    if (more) load(k0 + kBK);
    slice_mma_staged<kWT>(acc, as + buf * kBM * kSK, bs + buf * kBStage, wm, wn, lane);
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  float* tile = reinterpret_cast<float*>(smem);
  store_tile(acc, tile, wm, wn, lane);
  __syncthreads();
  for (int i = tid; i < kBM * (kBN / 4); i += 128) {
    const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
    const int m = m0 + r;
    if (m >= rows || n0 + c >= g.n) continue;
    const float v[4] = {tile[r * (kBN + 1) + c], tile[r * (kBN + 1) + c + 1],
                        tile[r * (kBN + 1) + c + 2], tile[r * (kBN + 1) + c + 3]};
    epilogue_row_bf16<4>(g, m, n0 + c, v);
  }
}

constexpr int kSA = kBM + 8;  // the weight gradient's [row][kk] and [row][n] bf16 rows

__global__ void __launch_bounds__(128) wgrad_bf16_kernel(const WGrad w, int rows_per_split,
                                                             float* dst, int dst_bf16) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kWRows][kSA]
  __nv_bfloat16* bs = as + 2 * kWRows * kSA;                     // [2][kWRows][kSA]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int n0 = blockIdx.x * kBN, k0 = blockIdx.y * kBM;
  const int rows = w.batch * w.t;
  const int kdim = w.taps * w.c_in;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(rows, m_begin + rows_per_split);
  const int half_taps = w.taps / 2;
  const bool a16 = has(w.bf16, kA16), dy16 = has(w.bf16, kAux16);
  // units tid and tid + 128: row u / 8 of the slice, 8 columns from 8 (u % 8)
  // (kk for A, n for dY)
  int a_c[2], a_off[2];
  bool a_ok[2], b_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int u = tid + 128 * i;
    const int kk = k0 + 8 * (u % 8);
    a_ok[i] = kk < kdim;
    const int tap = a_ok[i] ? kk / w.c_in : 0;
    a_c[i] = kk - tap * w.c_in;
    a_off[i] = (tap - half_taps) * w.dilation;
    b_ok[i] = n0 + 8 * (u % 8) < w.n;
  }
  uint4 ra[2], rb[2];
  auto load = [&](int mb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + 128 * i;
      const int m = mb + u / 8;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (m < m_end) {
        const int b = m / w.t;
        const int ts = m - b * w.t + a_off[i];
        if (a_ok[i] && ts >= 0 && ts < w.t) {
          const long src = (long)b * w.t + ts;
          va = load8(w.a, src * w.lda + a_c[i], a16, w.a_mask ? w.a_mask[src] : 1.f);
        }
        if (b_ok[i])
          vb = load8(w.dy, (long)m * w.ldy + n0 + 8 * (u % 8), dy16,
                     w.dy_mask ? w.dy_mask[m] : 1.f);
      }
      ra[i] = va;
      rb[i] = vb;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int u = tid + 128 * i;
      const int at = buf * kWRows * kSA + (u / 8) * kSA + 8 * (u % 8);
      *reinterpret_cast<uint4*>(as + at) = ra[i];
      *reinterpret_cast<uint4*>(bs + at) = rb[i];
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (m_begin < m_end) {
    load(m_begin);
    store(0);
  }
  __syncthreads();
  int buf = 0;
  for (int mb = m_begin; mb < m_end; mb += kWRows) {
    const bool more = mb + kWRows < m_end;
    if (more) load(mb + kWRows);
    const __nv_bfloat16* a_s = as + buf * kWRows * kSA;
    const __nv_bfloat16* b_s = bs + buf * kWRows * kSA;
#pragma unroll
    for (int ks = 0; ks < kWRows; ks += 16) {
      // A = im2col(A)^T: kk rows, slice rows as k, by ldmatrix.trans of [row][kk]
      uint32_t a[2][4], b[4][2];
      const int mat = lane >> 3, r8 = lane & 7;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4_trans(a[i], a_s + (ks + (mat >> 1) * 8 + r8) * kSA + wm + 16 * i +
                                    (mat & 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldmatrix_x2_trans(b[j], b_s + (ks + (lane & 15)) * kSA + wn + 8 * j);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  float* tile = reinterpret_cast<float*>(smem);
  store_tile(acc, tile, wm, wn, lane);
  __syncthreads();
  const long base = (long)blockIdx.z * kdim * w.n;
  for (int i = tid; i < kBM * kBN; i += 128) {
    const int r = i / kBN, cc = i % kBN;
    const int k = k0 + r, n = n0 + cc;
    if (k < kdim && n < w.n) st_act(dst, base + (long)k * w.n + n, tile[r * (kBN + 1) + cc],
                                    dst_bf16 != 0);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// What the kernels take: operands whose rows hold whole groups of 8 elements
// (c_in, the row strides and the column counts multiples of 8, paired
// columns in runs of 4), 16-byte aligned, the weights bf16.
bool conv_fits(const ConvGemm& g) {
  const bool a16 = has(g.bf16, kA16);
  const int ldb = g.ldb ? g.ldb : g.n;
  bool ok = has(g.bf16, kW16) && g.c_in % 8 == 0 && g.lda % (a16 ? 8 : 4) == 0 &&
            g.n % 8 == 0 && aligned16(g.a) && aligned16(g.w);
  if (!g.w_t) ok = ok && (paired(g.epilogue) ? g.split % 4 == 0 && ldb % 4 == 0 : ldb % 8 == 0);
  return ok;
}

bool wgrad_fits(const WGrad& w) {
  return w.c_in % 8 == 0 && w.n % 8 == 0 && w.lda % (has(w.bf16, kA16) ? 8 : 4) == 0 &&
         w.ldy % (has(w.bf16, kAux16) ? 8 : 4) == 0 && aligned16(w.a) && aligned16(w.dy);
}

// out[i] = sum over the splits s (in order) of part[s * per_split + i],
// written in out's dtype.
__global__ void split_sum_kernel(const float* __restrict__ part, long per_split, int splits,
                                 float* out, int out_bf16) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_split) return;
  float v = 0.f;
  for (int s = 0; s < splits; ++s) v += part[s * per_split + i];
  st_act(out, i, v, out_bf16 != 0);
}

}  // namespace

cudaError_t conv_gemm_bf16(const ConvGemm& g, cudaStream_t stream) {
  const int rows = g.batch * g.t;
  if (rows <= 0 || g.n <= 0) return cudaSuccess;
  if ((g.epilogue == kGateBwd && g.out4) || !conv_fits(g)) return cudaErrorInvalidValue;
  ++product_counts().bf16_gemm;
  const dim3 grid((g.n + kBN - 1) / kBN, (rows + kBM - 1) / kBM);
  if (g.w_t) conv_gemm_bf16_kernel<true><<<grid, 128, 0, stream>>>(g);
  else conv_gemm_bf16_kernel<false><<<grid, 128, 0, stream>>>(g);
  return cudaGetLastError();
}

cudaError_t wgrad_bf16(const WGrad& w, cudaStream_t stream) {
  const int rows = w.batch * w.t;
  const int kdim = w.taps * w.c_in;
  if (kdim <= 0 || w.n <= 0) return cudaSuccess;
  if (w.dy_t != nullptr || !wgrad_fits(w)) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  ++product_counts().bf16_wgrad;
  if (w.bias_out) {  // the bias gradient: the f32 column sums of dY, by sample, then added
    if (w.a_mask || w.scratch == nullptr || w.scratch_floats < (long)w.batch * w.n)
      return cudaErrorInvalidValue;
    if ((err = bias_grad(w.dy, w.ldy, w.n, w.dy_mask, w.batch, w.t, w.scratch, w.bias_out,
                         stream, has(w.bf16, kAux16))) != cudaSuccess)
      return err;
  }
  const int tiles = ((w.n + kBN - 1) / kBN) * ((kdim + kBM - 1) / kBM);
  const long per_split = (long)kdim * w.n;
  // about four waves of blocks, at least 64 rows a split, within scratch
  long splits = (4 * sms + tiles - 1) / tiles;
  splits = std::min(splits, std::max(1L, (rows + 63L) / 64));
  splits = std::min(splits, std::max(1L, w.scratch_floats / per_split));
  if (w.scratch == nullptr) splits = 1;
  int rows_per_split = (int)((rows + splits - 1) / splits);
  rows_per_split = ((rows_per_split + kWRows - 1) / kWRows) * kWRows;
  splits = std::max(1, (rows + rows_per_split - 1) / rows_per_split);
  const dim3 grid((w.n + kBN - 1) / kBN, (kdim + kBM - 1) / kBM, (unsigned)splits);
  const int out16 = has(w.bf16, kOut16) ? 1 : 0;
  if (splits == 1) {
    wgrad_bf16_kernel<<<grid, 128, 0, stream>>>(w, rows_per_split, w.out, out16);
    return cudaGetLastError();
  }
  wgrad_bf16_kernel<<<grid, 128, 0, stream>>>(w, rows_per_split, w.scratch, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  split_sum_kernel<<<(unsigned)((per_split + 255) / 256), 256, 0, stream>>>(
      w.scratch, per_split, (int)splits, w.out, out16);
  return cudaGetLastError();
}

}  // namespace gtt
