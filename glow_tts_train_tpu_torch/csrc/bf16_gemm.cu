// The bf16 chains' products (fp16_run): the conv-GEMM and the weight
// gradient as the JAX kernels compute them with dtype bf16,
// jnp.dot(a.astype(bf16), w, preferred_element_type=f32): each operand
// element rounded to bf16 once, bf16 x bf16 products on the tensor cores
// with f32 accumulation, the epilogue of the f32 chains with the bf16
// roundings (epilogue.cuh, epilogue_cols_bf16).  They replace the products
// inside block_pallas.py's _block_fwd_save_kernel and _block_bwd_store_kernel
// (and wn_pallas.py's _layer_fwd / _reverse_walk they call), and inside the
// text kernels' (text_pallas.py, encoder_pallas.py) with dtype bf16.  Two
// units:
//
// The TMA-fed wgmma kernels (conv_gemm_bf16_tma_kernel,
// wgrad_bf16_tma_kernel), for every bf16 chain (the flow block's, the text
// encoder layer's, the prenet's and the duration stack's), which asks for
// them (ConvGemm::tma_ring, WGrad::tma_ring) and gives every product bf16
// operands (each the bf16 copy its writer rounds); of their conv-GEMMs,
// the WN forward's in-layer conv and res/skip take a warp-specialised
// persistent kernel (conv_gemm_bf16_ws_kernel, below).
// What bounds them: their operations at the dense BF16 peak (989 TFLOP/s)
// against the L2 traffic of their tiles' operands and the epilogue's loads
// and stores, which the K walk does not hide.  The design:
//  * TMA (cp.async.bulk.tensor) brings 64 x 64 bf16 boxes in the 128-byte
//    swizzle into an mbarrier ring (full: the producer's arrival and the
//    stage's bytes; empty: every consumer warp, after a proxy fence); one
//    producer thread in a warpgroup that gives its registers to the
//    consumers (setmaxnreg); wgmma m64nNk16 with both operands from shared
//    memory, one instruction of the tile's whole width (N = 64 to 192) a
//    16-deep step, one group left in flight while the next stage is waited
//    for.
//  * Activations are 3-D tensor maps [batch, t, c]: a tile or a row slice
//    never crosses a sample, so a tap's shifted box reads zeros past the
//    sample's edge (TMA's fill): the im2col gather and the zero padding
//    cost nothing.  Weights are read as they lie: a forward [K, N] as
//    wgmma's transposed (N-major) B in 64-column chunks (a paired
//    epilogue's tile one chunk of each half, so a pair sits in one
//    thread), a transposed product's w [taps * n, c_in] K-major.
//  * The conv-GEMM: 64-row tiles, one consumer warpgroup, 96 KB of stages,
//    two blocks an SM (one's epilogue under the other's K walk); the
//    accumulators through shared memory to the epilogue, 4 columns a call.
//    For a text chain's short, deep products (ConvGemm::part) the plan
//    (tma_conv_plan) also picks the chunks a tile and split-K shares: each
//    share's partial sums to scratch, added in split order by a pass that
//    runs the epilogue (conv_split_sum_bf16_kernel).
//  * The weight gradient: 128 im2col columns (two consumer warpgroups) by
//    64 to 192 dY columns a block over its split of the 64-row slices, both
//    operands MN-major (the slice's rows are wgmma's K); the splits'
//    partial sums added in split order by a second pass (no atomics).
//
// The mma.sync kernels (conv_gemm_bf16_kernel, wgrad_bf16_kernel), for
// shapes the TMA-fed ones do not take (below 64 channels or columns) and
// for measurements in turns (gtt_bf16_tma): A gathered as im2col while
// staging (taps, dilation, tap_sign, a_mask, as conv_gemm_kernel does), B
// read as it lies or through w_t's per-tap transpose, each of A, B and the
// epilogue's operands f32 or bf16 (ConvGemm::bf16), staged through registers 8
// elements a load (16 bytes of bf16, or 32 of f32 rounded as they are
// packed): they take operands whose rows hold whole groups of 8
// (conv_fits, wgrad_fits; every product at the shipped widths), and
// refuse the rest.
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
// ``g.astype(w.dtype)``).
//
// Either unit's bias gradient (the flow chains'; the text chains take
// their column sums themselves) comes from the tile sums of dY that the
// epilogues writing dY keep (ConvGemm::sums: f32 sums of the unrounded
// cotangent, as the JAX kernels sum it, per sample and 64-row tile), so no
// f32 copy of dY is written for it: the weight gradient's one reduction
// launch (wgrad_bf16_reduce_kernel) adds its row splits, its bias's tile sums
// and, for dW_in, the conditioning's per-sample sums.  A weight gradient
// is two launches.
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "epilogue.cuh"
#include "mma.cuh"
#include "tma.cuh"

namespace gtt {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kSK = kBK + 8;  // bf16 a shared-memory row: 80 bytes, conflict-free fragments

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

// A cotangent epilogue's column sums over one 64-row tile (ConvGemm::sums):
// each thread adds the values of its column group (kW columns from q kW)
// over the rows of its phase (rows phase, phase + phases, ... of the tile)
// in cs; stage_sums puts them in shared memory, stage [phases][4][cols];
// then, after a barrier, flush_sums adds each column's phases in order and
// writes the tile's sum (sample b, tile `tile`) where sum_slot says.
// (kS 0: the group's columns are q kW .. q kW + kW - 1; else its kW / 2
// pairs 2q + p kS, + 1, as conv_gemm_bf16_tma_kernel lays them out with
// kPairs.)
template <int kW, int kS = 0>
__device__ __forceinline__ void stage_sums(const float (&cs)[4][kW], float* stage, int phase,
                                           int q, int cols) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int e = 0; e < kW; ++e)
      stage[(phase * 4 + s) * cols + (kS ? 2 * q + (e >> 1) * kS + (e & 1) : q * kW + e)] =
          cs[s][e];
}

__device__ __forceinline__ void flush_sums(const ConvGemm& g, const float* stage, int phases,
                                           int cols, int n0, int b, int tile, int tid,
                                           int threads) {
  const int slots = sum_slots(g.epilogue);
  const long at = (long)b * ((g.t + kSumTileRows - 1) / kSumTileRows) + tile;
  for (int i = tid; i < slots * cols; i += threads) {
    const int s = i / cols, c = i - s * cols, n = n0 + c;
    int col = 0;
    const TileSums t = sum_slot(g, s, n, &col);
    if (n >= g.n || t.p == nullptr) continue;
    float v = 0.f;
    for (int p = 0; p < phases; ++p) v = __fadd_rn(v, stage[(p * 4 + s) * cols + c]);
    t.p[at * t.ld + col] = v;
  }
}

constexpr int kWRows = 32;  // rows a slice of the weight gradient


constexpr int kSN = kBN + 8;  // a [k][n] bf16 row: 144 bytes, conflict-free ldmatrix rows

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
// the epilogue's tile and, after it, its column sums' stage [8][4][kBN]
constexpr int kSumStageBytes = 8 * 4 * kBN * 4;
constexpr int kSmemBytes = kStageBytes > kTileBytes + kSumStageBytes
                               ? kStageBytes
                               : kTileBytes + kSumStageBytes;

template <bool kWT>
__global__ void __launch_bounds__(128) conv_gemm_bf16_kernel(const ConvGemm g) {
  __shared__ __align__(16) unsigned char smem[kSmemBytes];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBM][kSK]
  __nv_bfloat16* bs = as + 2 * kBM * kSK;                        // [2][kBStage]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  // a tile: 64 rows of one sample (its tiles end at its last row, so a
  // tile's column sums are the sample's), columns from n0
  const int tiles_t = (g.t + kBM - 1) / kBM;
  const int b = blockIdx.y / tiles_t, ti = blockIdx.y - b * tiles_t;
  const int t0 = ti * kBM, n0 = blockIdx.x * kBN;
  const int kdim = g.taps * g.c_in;
  const int half_taps = g.taps / 2;
  const bool a16 = has(g.bf16, kA16);
  const int ldb = g.ldb ? g.ldb : g.n;
  const bool pair = paired(g.epilogue);

  // A: units tid and tid + 128, row u / 4 and the k group u % 4 (8 k's)
  int a_row0[2], a_t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_t[i] = t0 + (tid + 128 * i) / 4;
    a_row0[i] = a_t[i] < g.t ? b * g.t : -1;
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
  // a thread: 4 columns from c of rows tid / 16, + 8, ...
  float cs[4][4] = {};
  const int c = (tid % (kBN / 4)) * 4;
  for (int r = tid / (kBN / 4); r < kBM; r += 128 / (kBN / 4)) {
    if (t0 + r >= g.t || n0 + c >= g.n) continue;
    const float v[4] = {tile[r * (kBN + 1) + c], tile[r * (kBN + 1) + c + 1],
                        tile[r * (kBN + 1) + c + 2], tile[r * (kBN + 1) + c + 3]};
    epilogue_row_bf16<4>(g, b * g.t + t0 + r, n0 + c, v, cs);
  }
  if (g.sums.p == nullptr) return;
  float* stage = tile + kBM * (kBN + 1);
  stage_sums<4>(cs, stage, tid / (kBN / 4), tid % (kBN / 4), kBN);
  __syncthreads();
  flush_sums(g, stage, 128 / (kBN / 4), kBN, n0, b, ti, tid, 128);
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

// One weight gradient's reduction, in one launch of 256-thread blocks:
//  * w_blocks: out[i] = sum over the row splits s (in order) of
//    part[s * per_split + i], written in out's dtype;
//  * b_blocks: the bias gradient bias[j], 32 columns a block: each
//    sample's tile sums of column j (WGrad::bias_lo / bias_hi) added in
//    tile order by one of 8 thread rows, then the samples' in order;
//  * the rest: the conditioning's gradient dg[b * dg_ld + j] (bf16), sample
//    b's tile sums of g added in tile order.
// No atomics: the same bits on every call.
struct WgradReduce {
  const float* part = nullptr;
  long per_split = 0;
  int splits = 0;
  float* out = nullptr;
  int out_bf16 = 0;
  float* bias = nullptr;
  int n = 0, split = 0;  // the bias's columns, those from lo
  TileSums lo, hi, g;
  float* dg = nullptr;
  long dg_ld = 0;
  int batch = 0, tiles = 0;
  int w_blocks = 0, b_blocks = 0;
};

constexpr int kSumRows = 8;  // a bias block's thread rows (samples b, b + 8, ...)

__device__ __forceinline__ float tile_sum_at(const TileSums& s, int b, int tile, int tiles,
                                             int j) {
  return s.p ? s.p[((long)b * tiles + tile) * s.ld + j] : 0.f;
}

// sample b's part of column j: its tiles in order
__device__ __forceinline__ float sample_sum(const TileSums& s, int b, int tiles, int j) {
  float v = 0.f;
  for (int i = 0; i < tiles; ++i) v += tile_sum_at(s, b, i, tiles, j);
  return v;
}

__global__ void __launch_bounds__(256) wgrad_bf16_reduce_kernel(const WgradReduce r) {
  extern __shared__ float by_sample[];  // [batch][32]: a bias block's samples' parts
  const int tid = threadIdx.x;
  int blk = blockIdx.x;
  if (blk < r.w_blocks) {
    const long i = (long)blk * 256 + tid;
    if (i >= r.per_split) return;
    float v = 0.f;
    for (int s = 0; s < r.splits; ++s) v += r.part[s * r.per_split + i];
    st_act(r.out, i, v, r.out_bf16 != 0);
    return;
  }
  blk -= r.w_blocks;
  if (blk < r.b_blocks) {
    const int tx = tid % 32, ty = tid / 32;
    const int j = blk * 32 + tx;
    const bool on = j < r.n;
    const TileSums src = j < r.split ? r.lo : r.hi;
    const int col = j < r.split ? j : j - r.split;
    for (int b = ty; b < r.batch; b += kSumRows)
      by_sample[b * 32 + tx] = on ? sample_sum(src, b, r.tiles, col) : 0.f;
    __syncthreads();
    if (ty != 0 || !on) return;
    float v = 0.f;
    for (int b = 0; b < r.batch; ++b) v += by_sample[b * 32 + tx];
    r.bias[j] = v;
    return;
  }
  blk -= r.b_blocks;
  const long i = (long)blk * 256 + tid;
  if (i >= (long)r.batch * r.n) return;
  const int b = (int)(i / r.n), j = (int)(i - (long)b * r.n);
  st_act(r.dg, b * r.dg_ld + j, sample_sum(r.g, b, r.tiles, j), true);
}

// The reduction of weight gradient w (scratch holding its `splits` row
// splits' partial sums where splits > 1) with its bias and conditioning
// gradients; none of the three to do: no launch.
cudaError_t wgrad_reduce(const WGrad& w, int splits, int out16, cudaStream_t stream) {
  WgradReduce r;
  const long per_split = (long)w.taps * w.c_in * w.n;
  if (splits > 1) {
    r.part = w.scratch; r.per_split = per_split; r.splits = splits;
    r.out = w.out; r.out_bf16 = out16;
    r.w_blocks = (int)((per_split + 255) / 256);
  }
  r.batch = w.batch; r.tiles = (w.t + kSumTileRows - 1) / kSumTileRows; r.n = w.n;
  if (w.bias_out) {
    r.bias = w.bias_out; r.split = w.bias_split; r.lo = w.bias_lo; r.hi = w.bias_hi;
    r.b_blocks = (w.n + 31) / 32;
  }
  int g_blocks = 0;
  if (w.dg) {
    r.g = w.g_sums; r.dg = w.dg; r.dg_ld = w.dg_ld;
    g_blocks = (int)(((long)w.batch * w.n + 255) / 256);
  }
  const int blocks = r.w_blocks + r.b_blocks + g_blocks;
  if (blocks == 0) return cudaSuccess;
  const size_t smem = r.b_blocks ? sizeof(float) * 32 * w.batch : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  wgrad_bf16_reduce_kernel<<<blocks, 256, smem, stream>>>(r);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the TMA-fed wgmma products (the bf16 chains')
// ---------------------------------------------------------------------------

constexpr int kRingChunk = 64 * 128;  // one 64 x 64 16-bit chunk: 64 rows of 128 bytes

// A ring of kStages stages in dynamic shared memory, each the A operand's kA
// chunks (64 rows of a conv's tile, or 64 im2col columns of a weight
// gradient's, 64 deep) then B's kNB chunks of 64 columns; then each stage's
// full and empty barrier.  The conv-GEMM: a 64-row tile, one consumer
// warpgroup, 96 KB of stages, two blocks an SM (one's epilogue under the
// other's K walk); the weight gradient: 128 im2col columns, two consumer
// warpgroups, 4 stages, one block an SM.
template <int kA, int kNB, int kStages>
struct Ring {
  static constexpr int kStageBytes = (kA + kNB) * kRingChunk;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;
  static constexpr int kConsumers = 128 * kA;  // a warpgroup per A chunk
  static constexpr int kDepth = kStages;
  uint32_t base;  // 1024-byte aligned
  __device__ uint32_t a_chunk(int s, int i) const {
    return base + s * kStageBytes + i * kRingChunk;
  }
  __device__ uint32_t b_chunk(int s, int j) const {
    return base + s * kStageBytes + (kA + j) * kRingChunk;
  }
  __device__ uint32_t full(int s) const { return base + kStages * kStageBytes + 8 * s; }
  __device__ uint32_t empty(int s) const { return full(kStages + s); }
  __device__ int stage(int step) const { return step % kStages; }
  __device__ uint32_t phase(int step) const { return (step / kStages) & 1; }
};

template <int kNB>
using ConvRing = Ring<1, kNB, 12 / (1 + kNB)>;
template <int kNB>
using WgradRing = Ring<2, kNB, 4>;

// The ring in the block's dynamic shared memory, its barriers initialised
// (full: the producer's arrival and the stage's bytes; empty: every
// consumer warp) before any copy or wait.
template <class R>
__device__ __forceinline__ R ring_setup(unsigned char* smem_raw) {
  const R r{(smem_addr(smem_raw) + 1023u) & ~1023u};
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::kDepth; ++s) {
      mbar_init(r.full(s), 1);
      mbar_init(r.empty(s), R::kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// d += A [64 x 16] B [16 x 64 kNB], both from shared memory in the
// 128-byte swizzle: kTA / kTB 0 K-major (16 k of a 128-byte row), 1
// MN-major (16 rows of 64 elements, wgmma's transposed 16-bit operand; B's
// 64-column chunks kRingChunk apart, the descriptor's leading offset).
// d[j][4 i + {0, 1}]: row 16 warp + lane / 4, columns 64 j + 8 i + 2 (lane
// % 4) + {0, 1}; d[j][4 i + {2, 3}]: the same columns 8 rows down.
template <int kNB>
struct WgmmaBf16;

template <>
struct WgmmaBf16<1> {
  template <int kTA, int kTB>
  static __device__ __forceinline__ void run(float (&d)[1][32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
          "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
          "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
          "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
          "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
          "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
          "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31])
        : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
  }
};

template <>
struct WgmmaBf16<2> {
  template <int kTA, int kTB>
  static __device__ __forceinline__ void run(float (&d)[2][32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
          "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
          "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
          "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
          "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
          "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
          "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
          "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
          "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
          "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
          "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
          "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
          "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
        : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
  }
};

template <>
struct WgmmaBf16<3> {
  template <int kTA, int kTB>
  static __device__ __forceinline__ void run(float (&d)[3][32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n"
        "}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
          "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
          "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
          "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
          "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
          "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
          "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
          "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
          "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
          "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
          "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
          "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
          "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
          "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]),
          "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
          "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]),
          "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]),
          "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]),
          "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31])
        : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
  }
};

// The consumers' K walk: per step, wait for its stage, issue its 4 wgmmas
// (this warpgroup's A chunk against all of B's chunks; none where a_on is
// false), and release the previous step's stage once its wgmmas are done
// (one group left in flight).  Every warp releases each stage, after a
// proxy fence that orders its reads before the producer's next copy into
// it.  Columns of chunks a stage did not fill (past n) hold stale values:
// their outputs are never written.
template <int kTA, int kTB, int kNB, class R>
__device__ __forceinline__ void ring_products(const R& r, int n_steps, bool a_on,
                                              float (&acc)[kNB][32]) {
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  auto release = [&](int s) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(r.empty(r.stage(s)));
  };
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
  for (int s = 0; s < n_steps; ++s) {
    const int st = r.stage(s);
    mbar_wait(r.full(st), r.phase(s));
    if (a_on) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = sw128_descriptor(r.a_chunk(st, wg) + ks * (kTA ? 2048 : 32));
        // an MN-major B's 64-column chunks are kRingChunk apart
        const uint64_t db = sw128_descriptor(r.b_chunk(st, 0) + ks * (kTB ? 2048 : 32),
                                             kTB ? kRingChunk : 16);
        WgmmaBf16<kNB>::template run<kTA, kTB>(acc, da, db);
      }
      wgmma_commit();
    }
    wgmma_wait<1>();
    if (s > 0) release(s - 1);
  }
  wgmma_wait<0>();
  if (n_steps > 0) release(n_steps - 1);
}

// The bf16 conv-GEMM fed by TMA (ConvGemm::tma_ring in a bf16 chain): a
// 64-row x 64 kNB-column tile of one sample's rows per block (the tiles of
// a sample end at its last row, so a tap's rows outside the sample are
// TMA's zero fill), K walked tap outer, 64-channel slice inner.  A stage: A
// one box [64 rows x 64 channels] of the [batch, t, c_in] tensor map at the
// tap's shifted time index (K-major); B either the per-tap transposed
// weights of w_t as they lie (w [taps * n, c_in]: one K-major box of 64 kNB
// rows) or w [K, n] as it lies (N-major, wgmma's transposed B: a box of 64
// columns by 64 K rows per chunk; a paired epilogue's tile takes the
// columns j0 .. j0 + 63 and split + j0 .. split + j0 + 63, so that the
// thread holding column c of the first chunk holds its pair in the second).
// One producer thread issues the copies, one consumer warpgroup runs the
// wgmmas, and two blocks share an SM, so that one block's epilogue runs
// under the other's K walk (with one block of two consumer warpgroups an
// SM, 128-row tiles, the chains' epilogues added 40-130% to the bare
// products: the gate backward's loads wait with nothing else in flight).
// The accumulators go through shared memory to the epilogue
// (epilogue_cols_bf16, 4 neighbouring columns a call, 6 in a tile of three
// chunks: inlined once, where straight from the fragments each kernel held
// it 48 times and nvcc took minutes); a thread keeps one column group, so
// a cotangent's column sums (ConvGemm::sums) add up in its registers over
// its rows and once across threads through shared memory.  A thread's
// columns: kW neighbouring ones; with kPairs (the WN walk's transposed
// conv, whose epilogue reads and writes gx in f32) kW / 2 pairs 2 x 32
// columns apart, so that each f32 load or store of a warp spans 64
// neighbouring columns (at [22,528, 5 x 384 -> 192] 72 us on the device
// against 88 with neighbouring columns; the gate backward's and res/skip's
// bf16 epilogues took 14 and 10 us longer so, PERF.md on an H100).  Each
// column's rows add up in the same order either way: the same tile sums.
template <int kWT, int kNB, bool kPairs = false>
__global__ void __launch_bounds__(256, 2)
    conv_gemm_bf16_tma_kernel(const ConvGemm g, const __grid_constant__ CUtensorMap a_map,
                              const __grid_constant__ CUtensorMap b_map) {
  using R = ConvRing<kNB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const R r = ring_setup<R>(smem_raw);
  const int tid = threadIdx.x;
  const int tiles_t = (g.t + 63) / 64;
  const int b = blockIdx.y / tiles_t;
  const int t0 = (blockIdx.y - b * tiles_t) * 64;
  const bool pair = paired(g.epilogue);
  const int j0 = blockIdx.x * 64;        // paired: the tile's first column of each half
  const int n0 = blockIdx.x * 64 * kNB;  // else the tile's first column
  int nb_on = kNB;  // chunks holding a column below n
  if (!pair)
    while (nb_on > 1 && n0 + 64 * (nb_on - 1) >= g.n) --nb_on;
  const int slices = (g.c_in + 63) / 64;
  // split-K (gridDim.z shares, tma_conv_plan): this block's share of the
  // K walk's steps, `per` a share
  const int steps = g.taps * slices;
  const int per = (steps + gridDim.z - 1) / gridDim.z;
  const int s0 = blockIdx.z * per;
  const int n_steps = min(steps, s0 + per) - s0;

  if (tid >= R::kConsumers) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == R::kConsumers) {
      const uint32_t bytes = (1 + (kWT ? kNB : nb_on)) * kRingChunk;
      for (int i = 0; i < n_steps; ++i) {
        const int s = s0 + i;
        const int tap = s / slices, c0 = (s - tap * slices) * 64;
        const int st = r.stage(i);
        mbar_wait(r.empty(st), r.phase(i) ^ 1);
        mbar_expect_tx(r.full(st), bytes);
        const int off = g.tap_sign * (tap - g.taps / 2) * g.dilation;
        tma_load_3d(r.a_chunk(st, 0), &a_map, r.full(st), c0, t0 + off, b);
        if (kWT) {
          tma_load_3d(r.b_chunk(st, 0), &b_map, r.full(st), c0, tap * g.n + n0, 0);
        } else {
          for (int j = 0; j < nb_on; ++j) {
            const int col = pair ? j0 + j * g.split : n0 + 64 * j;
            tma_load_3d(r.b_chunk(st, j), &b_map, r.full(st), col, tap * g.c_in + c0, 0);
          }
        }
      }
    }
    return;
  }
  // the block's 32,768 registers: 40 a producer thread, 216 a consumer's
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  float acc[kNB][32];
  ring_products<0, kWT ? 0 : 1, kNB>(r, n_steps, true, acc);

  // the accumulators through shared memory (the ring is free once every
  // consumer's wgmmas are done: each copy it holds has landed), then each
  // thread takes neighbouring logical columns of a row to the epilogue
  constexpr int kStride = 64 * kNB + 8;  // floats a tile row
  float* tile = reinterpret_cast<float*>(smem_raw + (r.base - smem_addr(smem_raw)));
  const int lane = tid & 31;
  const int frag_row = ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  asm volatile("bar.sync 1, %0;\n" ::"n"(R::kConsumers) : "memory");
#pragma unroll
  for (int j = 0; j < kNB; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* at = tile + frag_row * kStride + 64 * j + 8 * i + col;
      *reinterpret_cast<float2*>(at) = make_float2(acc[j][4 * i], acc[j][4 * i + 1]);
      *reinterpret_cast<float2*>(at + 8 * kStride) = make_float2(acc[j][4 * i + 2], acc[j][4 * i + 3]);
    }
  asm volatile("bar.sync 1, %0;\n" ::"n"(R::kConsumers) : "memory");
  // a thread: kW neighbouring columns (a paired tile's: 2 pairs) of the
  // group q, in every `phases`-th row from its phase; 32 groups a row at 2
  // and 3 chunks, 16 at 1, so a warp covers a row's columns or two rows'
  constexpr int kW = kNB == 3 ? 6 : 4;
  constexpr int kGroups = 64 * kNB / kW;
  constexpr int kPhases = R::kConsumers / kGroups;
  constexpr int kS = kPairs ? 2 * kGroups : 2;  // the distance of a group's pairs
  const int q = tid % kGroups, phase = tid / kGroups;
  const int c0 = kPairs ? 2 * q : kW * q;  // the group's first column in the tile
  const long rows = (long)g.batch * g.t;
  float cs[4][kW] = {};
#pragma unroll 1
  for (int row = phase; row < 64; row += kPhases) {
    const int tt = t0 + row;
    if (tt >= g.t) continue;
    const float* tr = tile + row * kStride;
    if (gridDim.z > 1) {  // a share's partial sums, for conv_split_sum_bf16_kernel
      float* part = g.part + ((long)blockIdx.z * rows + b * g.t + tt) * g.n;
#pragma unroll
      for (int e = 0; e < kW; e += 2) {
        const int c = c0 + (e >> 1) * kS;
        if (n0 + c < g.n)
          *reinterpret_cast<float2*>(part + n0 + c) = *reinterpret_cast<const float2*>(tr + c);
      }
    } else if (pair) {  // pairs (2q, 64 + 2q) and (2q + 1, 65 + 2q): logical 2 (j0 + 2q) ..
      const float v[4] = {tr[2 * q], tr[64 + 2 * q], tr[2 * q + 1], tr[65 + 2 * q]};
      float none[4][4] = {};  // the paired epilogues keep no column sums
      epilogue_row_bf16<4>(g, b * g.t + tt, 2 * (j0 + 2 * q), v, none);
    } else {
      float v[kW];
#pragma unroll
      for (int e = 0; e < kW; e += 2) {
        const float2 f = *reinterpret_cast<const float2*>(tr + c0 + (e >> 1) * kS);
        v[e] = f.x;
        v[e + 1] = f.y;
      }
      epilogue_row_bf16<kW, kS>(g, b * g.t + tt, n0 + c0, v, cs);
    }
  }
  if (g.sums.p == nullptr) return;
  // the tile's column sums (paired epilogues keep none), staged after the
  // tile: [kPhases][4][64 kNB] floats, within the ring's stages
  float* stage = tile + 64 * kStride;
  stage_sums<kW, kPairs ? kS : 0>(cs, stage, phase, q, 64 * kNB);
  asm volatile("bar.sync 1, %0;\n" ::"n"(R::kConsumers) : "memory");
  flush_sums(g, stage, kPhases, 64 * kNB, n0, b, blockIdx.y - b * tiles_t, tid, R::kConsumers);
}

// The split-K shares of a TMA-fed conv-GEMM (part [splits, rows, n])
// added in split order, then the bf16 epilogue: a thread owns 4
// neighbouring columns of a row.
__global__ void conv_split_sum_bf16_kernel(const ConvGemm g, int splits) {
  const long rows = (long)g.batch * g.t;
  const int groups = g.n / 4;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * groups) return;
  const long m = i / groups;
  const int n0 = (int)(i - m * groups) * 4;
  float4 v = *reinterpret_cast<const float4*>(g.part + m * g.n + n0);
  for (int s = 1; s < splits; ++s) {
    const float4 p = *reinterpret_cast<const float4*>(g.part + (s * rows + m) * g.n + n0);
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  const float acc[4] = {v.x, v.y, v.z, v.w};
  float cs[4][4] = {};  // a text chain's product: no column sums
  epilogue_row_bf16<4>(g, (int)m, n0, acc, cs);
}

// The warp-specialised bf16 conv-GEMM (ws_plan: the WN forward's in-layer
// conv, kGate, and res/skip, kResSkip, in a bf16 flow chain; it replaces
// the products inside wn_pallas.py's _fwd_kernel and _fwd_save_kernel and
// block_pallas.py's _block_fwd_kernel / _block_fwd_save_kernel WN layers).
// The 64-row kernel above runs its epilogue on the warps that walk K, so an
// SM's epilogue hides only under the other block's walk, and each block
// fills its ring anew.  Here one block an SM runs a persistent loop over a
// static order of work units (unit blockIdx.x, then every gridDim.x-th),
// each kRows 64-row tiles (one sample's rows each: the next ones in row
// order) by one column tile (a paired epilogue's one chunk of each half,
// else kNB chunks from col0; ws_col_tile), and gives each role its own
// warps:
//  * warpgroups 0 .. kRows - 1 (MMA): a tile each, B shared from the stage
//    (the in-layer conv's two row tiles read each weight box once: its
//    walk is bound by its boxes' traffic from L2, PERF.md), K walked as
//    conv_gemm_bf16_tma_kernel walks it (16-deep steps, tap outer,
//    64-channel slice inner, one wgmma of the tile's width a step: the same
//    sums, the same bits); then the accumulators into a buffer in shared
//    memory, once the epilogue has emptied it, and straight on to the next
//    unit's walk;
//  * the next two warpgroups (epilogue): a unit's rows from its buffer,
//    under the next unit's walk, each element's arithmetic that of
//    epilogue_cols_bf16 (gate_values; res_skip_x, res_skip_sum), its
//    operands and results in bf16 or f32 pairs of neighbouring columns
//    (each warp access one span), res/skip's operands of all the thread's
//    rows loaded before the accumulators are waited for;
//  * the last warpgroup: one thread issues every unit's TMA copies into the
//    ring, running ahead across units (no ring fill a tile).
// Hand-offs by mbarrier: full / empty a stage (producer and MMA, as the
// 64-row kernel's ring), acc_full / acc_empty a buffer (MMA and epilogue:
// every thread arrives, so each arrival releases that thread's stores and
// each wait acquires them).  kBufs accumulator buffers: res/skip two beside
// a ring of three stages; the in-layer conv one (two tiles' rows) beside
// four stages, the MMA warpgroups' registers holding the next unit
// meanwhile.  An instance runs one epilogue (kEpi), so no other's code
// costs it registers.  No atomics; the paired epilogues keep no column
// sums, and neither does this unit.
constexpr int kWsSmemMax = 232448;

template <int kNB, int kRows, int kBufs>
struct WsLayout {
  static constexpr int kStageBytes = (kRows + kNB) * kRingChunk;
  static constexpr int kStride = 64 * kNB + 8;  // floats an accumulator row
  static constexpr int kBufBytes = 64 * kRows * kStride * 4;
  static constexpr int kMma = 128 * kRows;
  static constexpr int kEpilogue = 256;  // epilogue threads: two warpgroups
  static constexpr int kThreads = kMma + kEpilogue + 128;
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;  // 128 or 96 a thread
  static constexpr int kFixed = kBufs * kBufBytes + 8 * (2 * 8 + 2 * kBufs) + 1024;
  static constexpr int kStages = (kWsSmemMax - kFixed) / kStageBytes < 8
                                     ? (kWsSmemMax - kFixed) / kStageBytes : 8;
  static constexpr int kSmem =
      kStages * kStageBytes + kBufs * kBufBytes + 8 * (2 * kStages + 2 * kBufs) + 1024;
  // registers a thread by role (setmaxnreg; each .inc waits for the
  // registers the producer's .dec hands back, so the three must add up)
  static constexpr int kProducerRegs = kRows == 1 ? 24 : 32;
  static constexpr int kMmaRegs = kRows == 1 ? 152 : 104;
  static constexpr int kEpilogueRegs = kRows == 1 ? 168 : 120;
  static_assert(kProducerRegs * 128 + kMmaRegs * kMma + kEpilogueRegs * kEpilogue ==
                    kLaunchRegs * kThreads,
                "the roles' registers are the block's");
  static_assert(kStages >= 3 && kSmem <= kWsSmemMax, "the ring within a block's shared memory");
  uint32_t base;  // 1024-byte aligned
  __device__ uint32_t a_chunk(int s, int i) const { return base + s * kStageBytes + i * kRingChunk; }
  __device__ uint32_t b_chunk(int s, int j) const {
    return base + s * kStageBytes + (kRows + j) * kRingChunk;
  }
  __device__ uint32_t buf(int b) const { return base + kStages * kStageBytes + b * kBufBytes; }
  __device__ uint32_t bar(int i) const { return buf(kBufs) + 8 * i; }
  __device__ uint32_t full(int s) const { return bar(s); }
  __device__ uint32_t empty(int s) const { return bar(kStages + s); }
  __device__ uint32_t acc_full(int b) const { return bar(2 * kStages + b); }
  __device__ uint32_t acc_empty(int b) const { return bar(2 * kStages + kBufs + b); }
};

// Unit u's column tile: its row tiles are u / col_tiles, its column tile
// turned by its round (u / gridDim.x) so that a block's units take the
// column tiles in turn (res/skip's residual and skip halves differ in
// cost); a bijection where gridDim.x is a multiple of col_tiles, as
// launch_ws makes it.
__device__ __forceinline__ int ws_col_tile(int u, int col_tiles) {
  return (u % col_tiles + u / (int)gridDim.x) % col_tiles;
}

template <int kNB, int kRows, int kBufs, int kEpi>
__global__ void __launch_bounds__(WsLayout<kNB, kRows, kBufs>::kThreads, 1)
    conv_gemm_bf16_ws_kernel(const ConvGemm g, const __grid_constant__ CUtensorMap a_map,
                             const __grid_constant__ CUtensorMap b_map, int col0) {
  using L = WsLayout<kNB, kRows, kBufs>;
  static_assert(kEpi == kGate || kEpi == kResSkip, "the WN forward's two epilogues");
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const L l{(smem_addr(smem_raw) + 1023u) & ~1023u};
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(l.full(s), 1);
      mbar_init(l.empty(s), L::kMma / 32);
    }
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(l.acc_full(b), L::kMma);
      mbar_init(l.acc_empty(b), L::kEpilogue);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const bool pair = paired(g.epilogue);
  const int tiles_t = (g.t + 63) / 64;
  const int row_tiles = g.batch * tiles_t;
  const int col_tiles =
      pair ? (g.split + 63) / 64 : (g.n - col0 + 64 * kNB - 1) / (64 * kNB);
  const int units = (row_tiles + kRows - 1) / kRows * col_tiles;
  const int slices = (g.c_in + 63) / 64;
  const int steps = g.taps * slices;

  if (tid >= L::kMma + L::kEpilogue) {  // the producer warpgroup: one thread copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::kProducerRegs) : "memory");
    if (tid == L::kMma + L::kEpilogue) {
      int it = 0;  // the block's K steps so far, over its units
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int ru = u / col_tiles, ct = ws_col_tile(u, col_tiles);
        const int n0 = col0 + ct * 64 * kNB;
        int nb_on = kNB;  // chunks holding a column below n
        if (!pair)
          while (nb_on > 1 && n0 + 64 * (nb_on - 1) >= g.n) --nb_on;
        const int rows_on = min(kRows, row_tiles - ru * kRows);
        const uint32_t bytes = (rows_on + nb_on) * kRingChunk;
        for (int s = 0; s < steps; ++s, ++it) {
          const int tap = s / slices, c0 = (s - tap * slices) * 64;
          const int st = it % kStages;
          mbar_wait(l.empty(st), ((it / kStages) & 1) ^ 1);
          mbar_expect_tx(l.full(st), bytes);
          const int off = g.tap_sign * (tap - g.taps / 2) * g.dilation;
          for (int i = 0; i < rows_on; ++i) {
            const int rt = ru * kRows + i, b = rt / tiles_t;
            tma_load_3d(l.a_chunk(st, i), &a_map, l.full(st), c0, (rt - b * tiles_t) * 64 + off, b);
          }
          for (int j = 0; j < nb_on; ++j) {
            const int col = pair ? ct * 64 + j * g.split : n0 + 64 * j;
            tma_load_3d(l.b_chunk(st, j), &b_map, l.full(st), col, tap * g.c_in + c0, 0);
          }
        }
      }
    }
    return;
  }
  if (tid < L::kMma) {  // the MMA warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kMmaRegs) : "memory");
    const int wg = tid >> 7, lane = tid & 31;
    const int frag_row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
    const int col = 2 * (lane & 3);
    // every MMA warp releases each stage, after a proxy fence that orders
    // its reads before the producer's next copy into it
    auto release = [&](int st) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(l.empty(st));
    };
    float acc[kNB][32];
    int it = 0, k = 0;  // K steps and units so far
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
      const bool a_on = (u / col_tiles) * kRows + wg < row_tiles;
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
      for (int s = 0; s < steps; ++s, ++it) {
        const int st = it % kStages;
        mbar_wait(l.full(st), (it / kStages) & 1);
        if (a_on) {
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint64_t da = sw128_descriptor(l.a_chunk(st, wg) + ks * 32);
            // B's 64-column chunks (MN-major) are kRingChunk apart
            const uint64_t db = sw128_descriptor(l.b_chunk(st, 0) + ks * 2048, kRingChunk);
            WgmmaBf16<kNB>::template run<0, 1>(acc, da, db);
          }
          wgmma_commit();
        }
        wgmma_wait<1>();
        if (s > 0) release((it - 1) % kStages);
      }
      wgmma_wait<0>();
      release((it - 1) % kStages);
      const int b = k % kBufs;
      mbar_wait(l.acc_empty(b), ((k / kBufs) & 1) ^ 1);
      float* tile = reinterpret_cast<float*>(smem_raw + (l.buf(b) - smem_addr(smem_raw)));
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float* at = tile + frag_row * L::kStride + 64 * j + 8 * i + col;
          *reinterpret_cast<float2*>(at) = make_float2(acc[j][4 * i], acc[j][4 * i + 1]);
          *reinterpret_cast<float2*>(at + 8 * L::kStride) =
              make_float2(acc[j][4 * i + 2], acc[j][4 * i + 3]);
        }
      mbar_arrive(l.acc_full(b));
    }
    return;
  }
  // the epilogue warpgroups: a thread kW elements of the group q (32
  // groups a row), in every kPhases-th row of the unit's 64 kRows from its
  // phase
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::kEpilogueRegs) : "memory");
  constexpr int kW = kNB == 3 ? 6 : 4;
  constexpr int kGroups = 64 * kNB / kW;
  constexpr int kPhases = L::kEpilogue / kGroups;
  constexpr int kIters = 64 * kRows / kPhases;  // rows a thread a unit
  const int et = tid - L::kMma;
  const int q = et % kGroups, phase = et / kGroups;
  int k = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++k) {
    const int ru = u / col_tiles, ct = ws_col_tile(u, col_tiles);
    const int j0 = ct * 64, n0 = col0 + ct * 64 * kNB;
    const int b = k % kBufs;
    if constexpr (kEpi == kResSkip) {
      // res/skip: a thread kW / 2 column pairs kS apart (pair p at columns
      // 2q + p kS, + 1: each load or store of a warp one span of
      // neighbouring columns, each pair one 4- or 8-byte access); every
      // operand of the thread's rows (its mask, x or the skip sum so far)
      // loaded before the unit's accumulators are waited for, under the
      // walk, all in flight together; then each row's tail
      // (res_skip_pair_tail: res_skip_x and res_skip_sum, as
      // epilogue_cols_bf16 computes them)
      constexpr int kS = 64 * kNB / (kW / 2);
      const int p0 = n0 + 2 * q;  // the thread's first column
      int cnt = 0;
#pragma unroll
      for (int e = 0; e < kW; ++e) cnt += p0 + (e >> 1) * kS + (e & 1) < g.n;
      float bias[kW], rm[kIters], in[kIters][kW];
#pragma unroll
      for (int e = 0; e < kW; ++e)
        bias[e] = e < cnt ? bias_at(g, p0 + (e >> 1) * kS + (e & 1)) : 0.f;
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const int row = phase + i * kPhases;
        const int rt = ru * kRows + row / 64, sb = rt / tiles_t;
        const int tt = (rt - sb * tiles_t) * 64 + row % 64;
        rm[i] = 0.f;
        if (rt >= row_tiles || tt >= g.t) continue;
        const long m = (long)sb * g.t + tt;
        rm[i] = g.mask ? g.mask[m] : 1.f;
        res_skip_pair_operands<kW, kS>(g, m, p0, cnt, in[i]);
      }
      mbar_wait(l.acc_full(b), (k / kBufs) & 1);
      const float* tile =
          reinterpret_cast<const float*>(smem_raw + (l.buf(b) - smem_addr(smem_raw)));
#pragma unroll
      for (int i = 0; i < kIters; ++i) {
        const int row = phase + i * kPhases;
        const int rt = ru * kRows + row / 64, sb = rt / tiles_t;
        const int tt = (rt - sb * tiles_t) * 64 + row % 64;
        if (rt >= row_tiles || tt >= g.t) continue;
        float v[kW];
#pragma unroll
        for (int e = 0; e < kW; e += 2) {
          const float2 f =
              *reinterpret_cast<const float2*>(tile + row * L::kStride + 2 * q + (e >> 1) * kS);
          v[e] = f.x;
          v[e + 1] = f.y;
        }
        res_skip_pair_tail<kW, kS>(g, (long)sb * g.t + tt, rm[i], p0, cnt, v, bias, in[i]);
      }
      mbar_arrive(l.acc_empty(b));
    } else {
      // the in-layer conv: a thread the pairs (j, split + j) of columns j =
      // j0 + 2q and + 1, their biases read once a unit, each output (acts
      // and, saving, th and sg) stored as one bf16 pair; each pair's gates
      // by gate_values, as epilogue_cols_bf16 computes them.  kGateRows
      // rows at a time, every load of the group before any of its stores
      // (a load cannot pass a store that may alias it), so the rows'
      // chains run side by side.  A last column tile may reach past split
      // (h not a multiple of 64): its pairs from split on are not the
      // product's (split a multiple of 8, so a pair is all in or all out)
      constexpr int kGateRows = 2;
      const int j = j0 + 2 * q;
      const bool col_on = j < g.split;
      const float b_lo0 = col_on ? bias_at(g, j) : 0.f, b_lo1 = col_on ? bias_at(g, j + 1) : 0.f;
      const float b_hi0 = col_on ? bias_at(g, j + g.split) : 0.f;
      const float b_hi1 = col_on ? bias_at(g, j + 1 + g.split) : 0.f;
      mbar_wait(l.acc_full(b), (k / kBufs) & 1);
      const float* tile =
          reinterpret_cast<const float*>(smem_raw + (l.buf(b) - smem_addr(smem_raw)));
#pragma unroll 1
      for (int row0 = phase; row0 < 64 * kRows; row0 += kGateRows * kPhases) {
        EpilogueRow r[kGateRows];
        float2 u[kGateRows], v[kGateRows], c_lo[kGateRows], c_hi[kGateRows];
#pragma unroll
        for (int i = 0; i < kGateRows; ++i) {
          const int row = row0 + i * kPhases;
          const int rt = ru * kRows + row / 64, sb = rt / tiles_t;
          const int tt = (rt - sb * tiles_t) * 64 + row % 64;
          r[i] = EpilogueRow{-1, sb, tt, 1.f};
          if (!col_on || row >= 64 * kRows || rt >= row_tiles || tt >= g.t) continue;
          r[i].m = sb * g.t + tt;
          u[i] = *reinterpret_cast<const float2*>(tile + row * L::kStride + 2 * q);
          v[i] = *reinterpret_cast<const float2*>(tile + row * L::kStride + 64 + 2 * q);
          c_lo[i] = c_hi[i] = make_float2(0.f, 0.f);
          if (g.aux) {  // the conditioning
            const long gb = (long)sb * g.ld_aux;
            c_lo[i] = ld_pair16(g.aux, gb + j);
            c_hi[i] = ld_pair16(g.aux, gb + j + g.split);
          }
        }
        float th0[kGateRows], sg0[kGateRows], th1[kGateRows], sg1[kGateRows];
#pragma unroll
        for (int i = 0; i < kGateRows; ++i) {
          if (r[i].m < 0) continue;
          gate_values(g, r[i], j, u[i].x + b_lo0, v[i].x + b_hi0, c_lo[i].x, c_hi[i].x, th0[i],
                      sg0[i]);
          gate_values(g, r[i], j + 1, u[i].y + b_lo1, v[i].y + b_hi1, c_lo[i].y, c_hi[i].y,
                      th1[i], sg1[i]);
        }
#pragma unroll
        for (int i = 0; i < kGateRows; ++i) {
          if (r[i].m < 0) continue;
          const long m = r[i].m;
          st_pair16(g.out, m * g.ldo + j, th0[i] * sg0[i], th1[i] * sg1[i]);
          if (g.out2) {
            st_pair16(g.out2, m * g.ldo2 + j, th0[i], th1[i]);
            st_pair16(g.out3, m * g.ldo3 + j, sg0[i], sg1[i]);
          }
        }
      }
      mbar_arrive(l.acc_empty(b));
    }
  }
}

// The bf16 weight gradient fed by TMA (WGrad::tma_ring in a bf16 chain):
// out[kk, n] = sum over rows of im2col(A)[row, kk] * dY[row, n], a block's
// tile 128 im2col columns (64 a consumer warpgroup) by 64 kNB dY columns
// over its split of the row slices (64 rows of one sample each, in a fixed
// order; rows past the sample's end are TMA's zero fill).  A stage: per
// warpgroup one box [64 rows x 64 channels] of A's [batch, t, c_in] map at
// the tap's shifted time index, and per chunk one box [64 rows x 64
// columns] of dY's bf16 copy; both MN-major (wgmma's transposed operands:
// the slice's rows are the product's K).  The tile goes to dst (the
// gradient, or the split's partial sums [splits, kdim, n] that
// wgrad_bf16_reduce_kernel adds in split order) straight from the accumulators.
template <int kNB>
__global__ void __launch_bounds__(384, 1)
    wgrad_bf16_tma_kernel(const WGrad w, const __grid_constant__ CUtensorMap a_map,
                          const __grid_constant__ CUtensorMap dy_map, int splits, float* dst,
                          int dst_bf16) {
  using R = WgradRing<kNB>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const R r = ring_setup<R>(smem_raw);
  const int tid = threadIdx.x;
  const int kdim = w.taps * w.c_in;
  const int n0 = blockIdx.x * 64 * kNB, kk0 = blockIdx.y * 128;
  int nb_on = kNB;
  while (nb_on > 1 && n0 + 64 * (nb_on - 1) >= w.n) --nb_on;
  const int per_sample = (w.t + 63) / 64;
  const long slices = (long)w.batch * per_sample;
  const long s_begin = slices * blockIdx.z / splits, s_end = slices * (blockIdx.z + 1) / splits;
  const int n_steps = (int)(s_end - s_begin);

  if (tid >= R::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == R::kConsumers) {
      const int a_chunks = kk0 + 64 < kdim ? 2 : 1;
      const uint32_t bytes = (a_chunks + nb_on) * kRingChunk;
      for (int s = 0; s < n_steps; ++s) {
        const long gs = s_begin + s;
        const int b = (int)(gs / per_sample);
        const int t0 = (int)(gs - (long)b * per_sample) * 64;
        const int st = r.stage(s);
        mbar_wait(r.empty(st), r.phase(s) ^ 1);
        mbar_expect_tx(r.full(st), bytes);
        for (int i = 0; i < a_chunks; ++i) {
          const int kk = kk0 + 64 * i;
          const int tap = kk / w.c_in;
          tma_load_3d(r.a_chunk(st, i), &a_map, r.full(st), kk - tap * w.c_in,
                      t0 + (tap - w.taps / 2) * w.dilation, b);
        }
        for (int j = 0; j < nb_on; ++j)
          tma_load_3d(r.b_chunk(st, j), &dy_map, r.full(st), n0 + 64 * j, t0, b);
      }
    }
    return;
  }
  // 40 registers a producer thread, 232 a consumer's: 64,512 of the SM's
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = tid >> 7;
  float acc[kNB][32];
  ring_products<1, 1, kNB>(r, n_steps, kk0 + 64 * wg < kdim, acc);

  const int lane = tid & 31;
  const int frag_row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  const long base = (long)blockIdx.z * kdim * w.n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kk = kk0 + frag_row + 8 * h;
    if (kk >= kdim) continue;
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int n = n0 + 64 * j + 8 * i + col;  // n + 1 < w.n with it: n is a multiple of 8
        if (j >= nb_on || n >= w.n) continue;
        const long at = base + (long)kk * w.n + n;
        const float v0 = acc[j][4 * i + 2 * h], v1 = acc[j][4 * i + 2 * h + 1];
        if (dst_bf16) {
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(dst) + at) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(dst + at) = make_float2(v0, v1);
        }
      }
  }
}

// A bf16 [dim2, dim1, dim0] tensor (row stride ld, plane stride ld * dim1
// elements; dim2 1: a matrix) as a 3-D tensor map of boxes of 64 elements
// (128 bytes) by box1 rows by 1, in the 128-byte swizzle; zeros outside.
cudaError_t bf16_map(CUtensorMap* map, const void* base, int dim0, int dim1, int dim2, long ld,
                     int box1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)dim0, (cuuint64_t)dim1, (cuuint64_t)dim2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)ld * 2 * dim1};
  const cuuint32_t box[3] = {64, (cuuint32_t)box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                          const_cast<void*>(base), dims, strides, box, unit,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class R, class Kernel, class... Args>
cudaError_t launch_ring(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, R::kConsumers + 128, R::kSmem, stream>>>(args...);
  return cudaGetLastError();
}

template <int kWT, int kNB, bool kPairs = false>
cudaError_t launch_conv_ring(const ConvGemm& g, int splits, cudaStream_t stream) {
  CUtensorMap a_map, b_map;
  cudaError_t err = bf16_map(&a_map, g.a, g.c_in, g.t, g.batch, g.lda, 64);
  if (err != cudaSuccess) return err;
  if (kWT) err = bf16_map(&b_map, g.w, g.c_in, g.taps * g.n, 1, g.c_in, 64 * kNB);
  else err = bf16_map(&b_map, g.w, g.n, g.taps * g.c_in, 1, g.ldb ? g.ldb : g.n, 64);
  if (err != cudaSuccess) return err;
  const int n_tiles = paired(g.epilogue) ? (g.split + 63) / 64 : (g.n + 64 * kNB - 1) / (64 * kNB);
  const dim3 grid(n_tiles, g.batch * ((g.t + 63) / 64), splits);
  return launch_ring<ConvRing<kNB>>(conv_gemm_bf16_tma_kernel<kWT, kNB, kPairs>, grid, stream, g,
                                    a_map, b_map);
}

template <int kNB>
cudaError_t launch_wgrad_ring(const WGrad& w, int splits, float* dst, int dst_bf16,
                              cudaStream_t stream) {
  CUtensorMap a_map, dy_map;
  cudaError_t err = bf16_map(&a_map, w.a, w.c_in, w.t, w.batch, w.lda, 64);
  if (err == cudaSuccess) err = bf16_map(&dy_map, w.dy16, w.n, w.t, w.batch, w.ldy, 64);
  if (err != cudaSuccess) return err;
  const dim3 grid((w.n + 64 * kNB - 1) / (64 * kNB), (w.taps * w.c_in + 127) / 128, splits);
  return launch_ring<WgradRing<kNB>>(wgrad_bf16_tma_kernel<kNB>, grid, stream, w, a_map, dy_map,
                                     splits, dst, dst_bf16);
}

// Whether a bf16 chain's products that ask for the TMA-fed unit may take it
// (gtt_bf16_tma: the mma.sync kernels alone, for a measurement in turns).
bool& tma_allowed() {
  static bool allowed = true;
  return allowed;
}

// The TMA-fed conv-GEMM's 64-column chunks a tile for a product of a bf16
// chain that asks for it (ConvGemm::tma_ring), by shape alone; 0: the
// mma.sync kernel takes it.  It reads A and B as TMA copies them: bf16,
// rows of whole 16-byte groups (c_in, lda, ldb multiples of 8), 16-byte
// aligned, no a_mask (a chain gives the masked copy instead), at least 64
// channels and 64 columns (a narrower product leaves most of each box
// empty).  A paired epilogue's tile is one chunk of each half, else up to
// three chunks (N = 192 in one tile, 384 in two): the most a tile takes.
int tma_conv_chunks(const ConvGemm& g) {
  if (!g.tma_ring || !tma_allowed() || !has(g.bf16, kA16) || !has(g.bf16, kW16) || g.a_mask)
    return 0;
  const int ldb = g.ldb ? g.ldb : g.n;
  const bool pair = paired(g.epilogue);
  if (g.c_in < 64 || g.n < 64 || g.c_in % 8 || g.lda % 8 || (!g.w_t && ldb % 8) ||
      (pair && g.w_t) || g.epilogue == kCouplingInv || g.out4 || !aligned16(g.a) ||
      !aligned16(g.w))
    return 0;
  return pair ? 2 : std::min(3, (g.n + 63) / 64);
}

// The TMA-fed weight gradient's plan for a product of a bf16 chain that
// asks for it (WGrad::tma_ring) with dY's bf16 copy (WGrad::dy16), by shape
// alone: its chunks a tile (0: the mma.sync kernel takes it) and its row
// splits, one wave of one block an SM at most, within the slices and the
// scratch.
struct TmaWgradPlan {
  int chunks = 0, splits = 1;
};

TmaWgradPlan tma_wgrad_plan(const WGrad& w, int sms) {
  TmaWgradPlan p;
  const int kdim = w.taps * w.c_in;
  if (!w.tma_ring || !tma_allowed() || !has(w.bf16, kA16) || w.dy16 == nullptr || w.a_mask ||
      w.dy_t != nullptr)
    return p;
  if (kdim < 64 || w.n < 64 || w.c_in % 8 || w.lda % 8 || w.n % 8 || w.ldy % 8 ||
      (w.taps > 1 && w.c_in % 64) || !aligned16(w.a) || !aligned16(w.dy16))
    return p;
  p.chunks = std::min(3, (w.n + 63) / 64);
  const long tiles = (long)((w.n + 64 * p.chunks - 1) / (64 * p.chunks)) * ((kdim + 127) / 128);
  const long slices = (long)w.batch * ((w.t + 63) / 64);
  long splits = std::min(std::max(1L, sms / tiles), slices);
  if (w.scratch == nullptr) splits = 1;
  else splits = std::min(splits, std::max(1L, w.scratch_floats / ((long)kdim * w.n)));
  p.splits = (int)splits;
  return p;
}

// The TMA-fed conv-GEMM's plan, by shape alone: its chunks a tile (0: the
// mma.sync kernel takes it) and its split-K shares.  A chain that gives no
// split-K scratch (the flow block's) takes tma_conv_chunks' tile and the
// whole K walk a block.  The text chains (ConvGemm::part) take the pair of
// chunks (1 to tma_conv_chunks') and shares (at most kTmaMaxShares, each
// at least kTmaMinSlices 64-deep slices, shares * n within kTmaSplitCols)
// whose waves of blocks (two an SM) times slices a block is least; ties to
// the fewest columns past n in the last column tile (a tile's wgmma runs
// its whole width: 256 columns in 192-wide tiles compute 384), then more
// chunks, then fewer shares.  A sample's tiles end at its last row, so
// the tiles count each sample's ragged last one.  The partial sums' round
// trip is the shares' cost, which the K walk's waves do not count: at [32,
// 192] two shares of the FFN's 768 columns saved 23 us of the first conv's
// K walk and their pass took 44 us (its epilogue's loads and stores of
// rows 768 wide), so a row's partial sums stay within 768 floats.
constexpr int kTmaMaxShares = 4, kTmaMinSlices = 2, kTmaSplitCols = 768;

struct TmaConvPlan {
  int chunks = 0, splits = 1;
};

int device_sms(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Whether the plan weighs the card's SMs (a text chain's product).
bool tma_plan_needs_sms(const ConvGemm& g) {
  return g.part && !paired(g.epilogue) && tma_conv_chunks(g);
}

TmaConvPlan tma_conv_plan(const ConvGemm& g, int sms) {
  TmaConvPlan p;
  const int most = tma_conv_chunks(g);
  p.chunks = most;
  if (!tma_plan_needs_sms(g)) return p;
  const long row_tiles = (long)g.batch * ((g.t + 63) / 64);
  const int steps = g.taps * ((g.c_in + 63) / 64);
  const long slots = 2L * sms;
  long best = -1;
  int best_pad = 0;
  for (int c = most; c >= 1; --c) {
    const int col_tiles = (g.n + 64 * c - 1) / (64 * c);
    const long tiles = row_tiles * col_tiles;
    const int pad = col_tiles * 64 * c - g.n;
    for (int s = 1; s <= kTmaMaxShares; ++s) {
      const int per = (steps + s - 1) / s;
      if (s > 1 && (per < kTmaMinSlices || (long)s * g.n > kTmaSplitCols)) break;
      if ((steps + per - 1) / per != s) continue;  // folds to fewer shares
      const long cost = (tiles * s + slots - 1) / slots * per;
      if (best < 0 || cost < best || (cost == best && pad < best_pad)) {
        best = cost;
        best_pad = pad;
        p.chunks = c;
        p.splits = s;
      }
    }
  }
  return p;
}

template <int kWT>
cudaError_t launch_conv_tma(const ConvGemm& g, const TmaConvPlan& p, cudaStream_t stream) {
  // the walk's transposed conv (its epilogue's f32 gx) in column pairs
  if constexpr (kWT != 0) {
    if (p.chunks == 3 && g.epilogue == kAccumMask)
      return launch_conv_ring<kWT, 3, true>(g, p.splits, stream);
  }
  if (p.chunks == 3) return launch_conv_ring<kWT, 3>(g, p.splits, stream);
  if (p.chunks == 2) return launch_conv_ring<kWT, 2>(g, p.splits, stream);
  return launch_conv_ring<kWT, 1>(g, p.splits, stream);
}

cudaError_t launch_wgrad_tma(const WGrad& w, const TmaWgradPlan& p, float* dst, int dst_bf16,
                             cudaStream_t stream) {
  if (p.chunks == 3) return launch_wgrad_ring<3>(w, p.splits, dst, dst_bf16, stream);
  if (p.chunks == 2) return launch_wgrad_ring<2>(w, p.splits, dst, dst_bf16, stream);
  return launch_wgrad_ring<1>(w, p.splits, dst, dst_bf16, stream);
}

// The warp-specialised unit's plan of a bf16 chain's conv-GEMM, by shape and
// epilogue: its chunks a tile (0: not this unit) and first column.  The WN
// forward's products that the 64-row kernel would take (tma_conv_chunks),
// with their bf16 operands, and that keep no column sums; a last layer's
// res/skip (flag 0: its residual half discarded) only the skip half, from
// split.
struct WsPlan {
  int chunks = 0, col0 = 0;
};

WsPlan ws_plan(const ConvGemm& g) {
  WsPlan p;
  const unsigned b = g.bf16;
  const bool gate = g.epilogue == kGate && has(b, kOut16) &&
                    (!g.out2 || (has(b, kOut2_16) && has(b, kOut3_16))) &&
                    (!g.aux || has(b, kAux16));
  const bool res_skip = g.epilogue == kResSkip && has(b, kOut16) && has(b, kAux16) &&
                        (!g.skip_mask || has(b, kOut3_16));
  if (!(gate || res_skip) || g.part || g.w_t || g.sums.p || g.sums2.p) return p;
  p.chunks = tma_conv_chunks(g);
  if (res_skip && !g.flag) p.col0 = g.split;
  return p;
}

template <int kNB, int kRows, int kBufs, int kEpi>
cudaError_t launch_ws(const ConvGemm& g, int col0, cudaStream_t stream) {
  using L = WsLayout<kNB, kRows, kBufs>;
  int sms = 0;
  if (const int err = device_sms(&sms)) return (cudaError_t)err;
  CUtensorMap a_map, b_map;
  cudaError_t err = bf16_map(&a_map, g.a, g.c_in, g.t, g.batch, g.lda, 64);
  if (err == cudaSuccess) err = bf16_map(&b_map, g.w, g.n, g.taps * g.c_in, 1, g.ldb ? g.ldb : g.n, 64);
  if (err != cudaSuccess) return err;
  const int row_units = (g.batch * ((g.t + 63) / 64) + kRows - 1) / kRows;
  const int col_tiles = paired(g.epilogue) ? (g.split + 63) / 64
                                           : (g.n - col0 + 64 * kNB - 1) / (64 * kNB);
  const int units = row_units * col_tiles;
  if (units <= 0) return cudaSuccess;
  auto kernel = conv_gemm_bf16_ws_kernel<kNB, kRows, kBufs, kEpi>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return err;
  // a whole number of column tiles' blocks (ws_col_tile)
  kernel<<<std::min(units, std::max(1, sms / col_tiles) * col_tiles), L::kThreads, L::kSmem,
           stream>>>(g, a_map, b_map, col0);
  return cudaGetLastError();
}

// The instance of a plan, its row tiles a unit and accumulator buffers by
// the epilogue: the in-layer conv two row tiles a unit (B's boxes read once
// for both) and one buffer; res/skip one row tile and two buffers, at 3 or
// 2 chunks a tile.
cudaError_t launch_ws_plan(const ConvGemm& g, const WsPlan& p, cudaStream_t stream) {
  if (g.epilogue == kGate && p.chunks == 2) return launch_ws<2, 2, 1, kGate>(g, p.col0, stream);
  if (g.epilogue == kResSkip && p.chunks == 3)
    return launch_ws<3, 1, 2, kResSkip>(g, p.col0, stream);
  if (g.epilogue == kResSkip && p.chunks == 2)
    return launch_ws<2, 1, 2, kResSkip>(g, p.col0, stream);
  return cudaErrorInvalidValue;
}

// A bf16 conv-GEMM on the 64-row TMA-fed kernel (by tma_conv_plan) or the
// mma.sync one.
cudaError_t conv_gemm_bf16_ring(const ConvGemm& g, cudaStream_t stream) {
  const int rows = g.batch * g.t;
  int sms = 0;
  if (tma_plan_needs_sms(g)) {
    if (const int err = device_sms(&sms)) return (cudaError_t)err;
  }
  const TmaConvPlan plan = tma_conv_plan(g, sms);
  // column sums only from whole-K tiles
  if ((g.sums.p || g.sums2.p) && plan.splits > 1) return cudaErrorInvalidValue;
  if (plan.chunks) {
    ++product_counts().bf16_tma_gemm;
    cudaError_t err = g.w_t ? launch_conv_tma<1>(g, plan, stream) : launch_conv_tma<0>(g, plan, stream);
    if (err != cudaSuccess || plan.splits == 1) return err;
    const long threads = (long)rows * (g.n / 4);
    conv_split_sum_bf16_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
        g, plan.splits);
    return cudaGetLastError();
  }
  if ((g.epilogue == kGateBwd && g.out4) || !conv_fits(g)) return cudaErrorInvalidValue;
  ++product_counts().bf16_gemm;
  const dim3 grid((g.n + kBN - 1) / kBN, g.batch * ((g.t + kBM - 1) / kBM));
  if (g.w_t) conv_gemm_bf16_kernel<true><<<grid, 128, 0, stream>>>(g);
  else conv_gemm_bf16_kernel<false><<<grid, 128, 0, stream>>>(g);
  return cudaGetLastError();
}

// One bf16 conv-GEMM on a given unit, for measurements and tests: 0 the
// mma.sync kernel, 1 the 64-row TMA-fed one, 2 the warp-specialised one (an
// error where the product does not fit the unit asked for).
cudaError_t conv_gemm_bf16_on(const ConvGemm& g, int unit, cudaStream_t stream) {
  ConvGemm h = g;
  h.tma_ring = unit != 0;
  if (unit == 2) {
    const WsPlan p = ws_plan(h);
    if (!p.chunks) return cudaErrorInvalidValue;
    ++product_counts().bf16_ws_gemm;
    return launch_ws_plan(h, p, stream);
  }
  if (unit == 1 && !tma_conv_chunks(h)) return cudaErrorInvalidValue;
  return conv_gemm_bf16_ring(h, stream);
}

}  // namespace

cudaError_t conv_gemm_bf16(const ConvGemm& g, cudaStream_t stream) {
  if (g.batch * g.t <= 0 || g.n <= 0) return cudaSuccess;
  const WsPlan ws = ws_plan(g);
  if (ws.chunks) {
    ++product_counts().bf16_ws_gemm;
    return launch_ws_plan(g, ws, stream);
  }
  return conv_gemm_bf16_ring(g, stream);
}

cudaError_t wgrad_bf16(const WGrad& w, cudaStream_t stream) {
  const int rows = w.batch * w.t;
  const int kdim = w.taps * w.c_in;
  if (kdim <= 0 || w.n <= 0) return cudaSuccess;
  // the product reads dY's bf16 copy where the chain gives one (rounded, and
  // masked by dy_mask, by the epilogue that wrote dY); the bias gradient dY
  WGrad p = w;
  if (w.dy16 != nullptr) {
    p.dy = w.dy16;
    p.bf16 |= kAux16;
    p.dy_mask = nullptr;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const TmaWgradPlan plan = tma_wgrad_plan(w, sms);
  if (w.dy_t != nullptr || (!plan.chunks && !wgrad_fits(p))) return cudaErrorInvalidValue;
  // the bias and conditioning gradients only from the tile sums dY's
  // writers kept, added in the reduction's launch
  if ((w.bias_out && (w.a_mask || w.dy16 == nullptr || !(w.bias_lo.p || w.bias_hi.p))) ||
      (w.dg && w.g_sums.p == nullptr))
    return cudaErrorInvalidValue;
  const int out16 = has(w.bf16, kOut16) ? 1 : 0;
  const long per_split = (long)kdim * w.n;
  if (plan.chunks) {
    ++product_counts().bf16_tma_wgrad;
    err = launch_wgrad_tma(w, plan, plan.splits == 1 ? w.out : w.scratch,
                           plan.splits == 1 ? out16 : 0, stream);
    return err != cudaSuccess ? err : wgrad_reduce(w, plan.splits, out16, stream);
  }
  ++product_counts().bf16_wgrad;
  const int tiles = ((w.n + kBN - 1) / kBN) * ((kdim + kBM - 1) / kBM);
  // about four waves of blocks, at least 64 rows a split, within scratch
  long splits = (4 * sms + tiles - 1) / tiles;
  splits = std::min(splits, std::max(1L, (rows + 63L) / 64));
  splits = std::min(splits, std::max(1L, w.scratch_floats / per_split));
  if (w.scratch == nullptr) splits = 1;
  int rows_per_split = (int)((rows + splits - 1) / splits);
  rows_per_split = ((rows_per_split + kWRows - 1) / kWRows) * kWRows;
  splits = std::max(1, (rows + rows_per_split - 1) / rows_per_split);
  const dim3 grid((w.n + kBN - 1) / kBN, (kdim + kBM - 1) / kBM, (unsigned)splits);
  wgrad_bf16_kernel<<<grid, 128, 0, stream>>>(p, rows_per_split, splits == 1 ? w.out : w.scratch,
                                              splits == 1 ? out16 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return wgrad_reduce(w, (int)splits, out16, stream);
}

}  // namespace gtt

// ---------------------------------------------------------------------------
// one bf16 product alone (bare epilogue), and the units' switch, for
// measurements
// ---------------------------------------------------------------------------

// Which unit the bf16 chains may take for their products that ask for the
// TMA-fed kernels: 1 (the default) those kernels where the shape fits, 0
// the mma.sync kernels alone.  Returns the previous setting.
extern "C" int gtt_bf16_tma(int on) {
  const int was = gtt::tma_allowed() ? 1 : 0;
  gtt::tma_allowed() = on != 0;
  return was;
}

// out [batch * t, n] f32 = im2col(a) @ B, a bf16 [batch * t, c_in], w bf16
// [taps * c_in, n] (or w_t: [taps * n, c_in], B its per-tap transpose), on
// the 64-row TMA-fed kernel (tma 1) or the mma.sync one (tma 0); an error
// where the shape does not fit the unit.  mask [batch * t] f32 or null: out's rows times it
// (kBiasMask).  sums [batch, ceil(t / 64), n] f32 or null: the column sums
// of out per sample and 64-row tile, as a flow chain's cotangent epilogue
// keeps them (ConvGemm::sums).
extern "C" int gtt_bf16_conv_product(const float* a, const float* w, float* out,
                                     const float* mask, float* sums, int batch, int t, int c_in,
                                     int taps, int dilation, int tap_sign, int n, int w_t, int tma,
                                     cudaStream_t stream) {
  gtt::ConvGemm g;
  g.a = a; g.lda = c_in; g.c_in = c_in; g.taps = taps; g.dilation = dilation;
  g.batch = batch; g.t = t; g.tap_sign = tap_sign; g.w = w; g.w_t = w_t; g.n = n;
  g.epilogue = mask ? gtt::kBiasMask : gtt::kBias; g.out = out; g.ldo = n; g.mask = mask;
  g.sums = {sums, n};
  g.bf16 = gtt::kBf16 | gtt::kA16 | gtt::kW16;
  return (int)gtt::conv_gemm_bf16_on(g, tma, stream);
}

// One layer's product of the bf16 WN forward (wn_layer_products) alone, on
// `unit` (as gtt_bf16_conv_product's tma): h channels over batch * t rows.
// kind 0, the in-layer conv: a = x bf16, w bf16 [taps * h, 2h], bias f32
// [2h]; out = acts, out2 / out3 = th / sg (bf16, or null: no saves); aux the
// conditioning bf16 [batch, 2h] or null; dropout of `site` of n_sites.
// kind 1, res/skip: a = acts bf16, w bf16 [h, 2h], bias f32 [2h]; aux =
// x_l bf16; out = the next x (bf16; may be x_l) where `flag` (not the last
// layer); out2 = the skip sum f32 (written where skip_init, else added to);
// with skip_mask out3 = its masked bf16 copy; mask [batch * t] f32.
extern "C" int gtt_bf16_wn_product(const float* a, const float* w, const float* bias, float* out,
                                   float* out2, float* out3, const float* aux, const float* mask,
                                   int batch, int t, int h, int taps, int dilation, int kind,
                                   int flag, int skip_init, int skip_mask, int drop_on,
                                   int drop_seed, int n_sites, int site, unsigned threshold,
                                   float scale, int unit, cudaStream_t stream) {
  using namespace gtt;
  ConvGemm g;
  g.a = a; g.lda = h; g.c_in = h; g.batch = batch; g.t = t;
  g.w = w; g.bias = bias; g.n = 2 * h; g.split = h;
  g.out = out; g.ldo = h; g.out2 = out2; g.ldo2 = h; g.out3 = out3; g.ldo3 = h;
  g.tma_ring = 1;
  if (kind == 0) {
    g.taps = taps; g.dilation = dilation; g.epilogue = kGate;
    g.aux = aux; g.ld_aux = 2 * h;
    g.drop = make_dropout(drop_on, drop_seed, n_sites, threshold, scale).at(site);
    g.bf16 = kBf16 | kA16 | kW16 | kOut16 | kOut2_16 | kOut3_16 | kAux16;
  } else {
    g.epilogue = kResSkip; g.mask = mask; g.aux = aux; g.ld_aux = h;
    g.flag = flag; g.skip_init = skip_init; g.skip_mask = skip_mask;
    g.bf16 = kBf16 | kA16 | kW16 | kOut16 | kAux16 | kOut3_16;
  }
  return (int)conv_gemm_bf16_on(g, unit, stream);
}

// The same product by the text chains' plan (tma_conv_plan with split-K
// scratch `part`, at least kSplitKCols floats a row): on the TMA-fed kernel
// in its chunks and shares, the shares added in split order by the bias
// epilogue's pass; an error where the plan declines the TMA-fed kernel.
extern "C" int gtt_bf16_text_product(const float* a, const float* w, float* out, float* part,
                                     long long part_floats, int batch, int t, int c_in, int taps,
                                     int tap_sign, int n, int w_t, cudaStream_t stream) {
  gtt::ConvGemm g;
  g.a = a; g.lda = c_in; g.c_in = c_in; g.taps = taps; g.batch = batch; g.t = t;
  g.tap_sign = tap_sign; g.w = w; g.w_t = w_t; g.n = n;
  g.epilogue = gtt::kBias; g.out = out; g.ldo = n;
  g.bf16 = gtt::kBf16 | gtt::kA16 | gtt::kW16;
  g.tma_ring = 1;
  g.part = part;
  if (part_floats < (long long)gtt::kSplitKCols * batch * t || !gtt::tma_plan_needs_sms(g))
    return (int)cudaErrorInvalidValue;
  return (int)gtt::conv_gemm_bf16(g, stream);
}

// tma_conv_plan of a bf16 conv-GEMM of c_in channels, taps and n columns
// over batch samples of t rows (text 1: a text chain's, with split-K
// scratch; w_t the transposed product's B) on `sms` SMs, as chunks * 100 +
// shares (0: the mma.sync kernel).
extern "C" int gtt_bf16_tma_conv_plan(int batch, int t, int c_in, int taps, int n, int w_t,
                                      int text, int sms) {
  gtt::ConvGemm g;
  static float dummy[4] __attribute__((aligned(16)));
  g.a = dummy; g.lda = c_in; g.c_in = c_in; g.taps = taps; g.batch = batch; g.t = t;
  g.w = dummy; g.w_t = w_t; g.n = n; g.epilogue = gtt::kBias;
  g.bf16 = gtt::kBf16 | gtt::kA16 | gtt::kW16;
  g.tma_ring = 1;
  g.part = text ? dummy : nullptr;
  const gtt::TmaConvPlan p = gtt::tma_conv_plan(g, sms);
  return p.chunks * 100 + p.splits;
}

// out [taps * c_in, n] f32 = im2col(a)^T dy over all batch * t rows, a bf16
// [batch * t, c_in], dy bf16 [batch * t, n]; scratch: the row splits'
// partial sums.  tma: as above.  bias [n] f32 or null: the bias gradient
// from dy's tile sums (conv product's `sums`), columns below bias_split
// from bias_lo [batch, tiles, bias_split], the rest from bias_hi [batch,
// tiles, n - bias_split]; dg [batch, n] bf16 or null: each sample's part of
// g_sums [batch, tiles, n].  Both in the reduction's launch, as a flow
// chain's weight gradient takes them (WGrad::bias_lo).
extern "C" int gtt_bf16_wgrad_product(const float* a, const float* dy, float* out, float* scratch,
                                      const float* bias_lo, const float* bias_hi,
                                      const float* g_sums, float* bias, float* dg,
                                      long long scratch_floats, int batch, int t, int c_in,
                                      int taps, int dilation, int n, int bias_split, int tma,
                                      cudaStream_t stream) {
  gtt::WGrad w;
  w.a = a; w.lda = c_in; w.c_in = c_in; w.taps = taps; w.dilation = dilation;
  w.batch = batch; w.t = t; w.dy = dy; w.dy16 = dy; w.ldy = n; w.n = n; w.out = out;
  w.scratch = scratch; w.scratch_floats = scratch_floats;
  w.bias_out = bias; w.bias_split = bias_split;
  w.bias_lo = {const_cast<float*>(bias_lo), bias_split};
  w.bias_hi = {const_cast<float*>(bias_hi), n - bias_split};
  w.g_sums = {const_cast<float*>(g_sums), n};
  w.dg = dg; w.dg_ld = n;
  w.bf16 = gtt::kBf16 | gtt::kA16 | gtt::kAux16;
  w.tma_ring = tma;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (tma && !gtt::tma_wgrad_plan(w, sms).chunks) return (int)cudaErrorInvalidValue;
  return (int)gtt::wgrad_bf16(w, stream);
}
