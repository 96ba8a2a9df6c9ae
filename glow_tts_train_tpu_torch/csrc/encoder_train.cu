// The backward of one text-encoder layer, the counterpart of
// glow_tts_train_tpu/ops/encoder_pallas.py::_bwd_kernel.
//
// Like the TPU kernel it saves nothing from the forward: it recomputes the
// layer from (weights, x, mask, seed) with the forward's own chain
// (encoder.cu, the same launches and dispatch, so the recomputed output and
// ReLU gates are the forward's bits), keeping q/k/v, the heads' outputs,
// both norms' normalised inputs and inverse stds, the FFN's dropped ReLU
// output and the softmax's row max and inverse row sum; replays every
// dropout keep mask from the seed; then walks back: second norm, FFN (two
// transposed conv products with the ReLU/keep and residual tails in their
// epilogues), first norm, output projection, attention core, the Q/K/V
// projection (one [h, 3h] product: one weight and one bias gradient).  The
// transposed products read the forward's weights as they lie
// (ConvGemm::w_t), and every buffer comes from the caller's one scratch
// block (encoder_scratch).  The products run on the tensor cores where the
// shape fits (text_product); the gradient sums whose lean matters stay on
// the CUDA cores: the norms' dgamma = sum dy * xhat and mean(g * xhat)
// (column_sums, layer_norm_bwd) and the softmax backward's dsum.
//
// Attention core, each (query tile, key tile)'s q.k^T and dout.v^T
// computed once (five [t, t, d] products where the streaming design took
// seven).  With pd the dropped probabilities, the softmax backward's row
// term sum_j pd_ij * dpd_ij equals dout_i . out_i (the rel-v band term
// included), so it comes from the forward's output.
//  * attn_bwd_scores_tc_kernel: a block owns 32 query rows of one (sample,
//    head) and streams the keys; q.k^T and dout.v^T on the tensor cores
//    (3xTF32 mma.sync, as the forward's core); per pair the dropped
//    probability pd and the score cotangent ds (pair_grad), written to
//    [batch, heads, t, t] scratch (4.7 MB each at [16, 2, 192, 192]), and
//    per row the band sums dqrel = ds * scale and pb = pd on the 2w+1
//    diagonals.
//  * attn_bwd_products_kernel: dq = scale ds k + dqrel rel_k, dk = scale
//    ds^T q, dv = pd^T dout, three batched 3xTF32 products in one launch,
//    each output element owned by one thread: no atomics.
//  * rel_grads_kernel: both rel-pos tables' gradients, shared by the heads,
//    d rel_k[o] = sum dqrel[., o] q and d rel_v[o] = sum pb[., o] dout over
//    rows and heads in a fixed order, one launch.
// ds is zero where the attend mask is zero, so a padded query row (uniform
// softmax over -1e4 scores) contributes to dv and the rel-v table only, as
// in the TPU kernel.
//
// The bf16 layer: the recompute is the bf16 forward chain (encoder.cu); the
// products take the TMA-fed wgmma kernels (tma_conv_plan, tma_wgrad_plan),
// each operand the bf16 copy its writer rounds (the JAX kernel's casts
// before its dots: dconv2 and dy by the norms' backward, dpre by the first
// transposed product's epilogue, dout_h by datt's, dM by the attention
// products kernel), the f32 values kept for the bias and norm sums.  The
// attention backward's bf16 kernels stage q, k, v and dout as bf16 and run
// their products on mma.sync m16n8k16 bf16: attn_bwd_scores_bf16_kernel
// (q.k^T and dout.v^T, ds and pd stored bf16: JAX's dst and pdt) and
// attn_bwd_products_bf16_kernel (ds.k, ds^T.q, pd^T.dout; dq, dk, dv f32
// and their bf16 copy).
//
// Bound on the card: the operations of the FFN's products (recompute,
// weight gradient and transposed conv); at t_x of a hundred or two the
// products are short and deep, which is what the split-K variant is for.
#include <math.h>

#include <algorithm>

#include "attention_tc.cuh"
#include "encoder.cuh"

namespace gtt {
namespace {

struct AttnBwd {
  const float* qkv = nullptr;        // [rows, 3h]
  const float* mask = nullptr;       // [rows]
  const float* rel_k = nullptr;      // [nb, d]
  const float* rel_v = nullptr;
  const float* att = nullptr;        // [rows, h] forward output of the core
  const float* datt = nullptr;       // [rows, h] its cotangent
  const float* stat_m = nullptr;     // [batch, heads, t] softmax row max
  const float* stat_linv = nullptr;  // and inverse row sum
  float* dqkv = nullptr;             // [rows, 3h]
  // the band sums dqrel and pb per row and head, [rows, heads * nb]
  float* dqrel = nullptr;
  float* pb = nullptr;
  // the score pass's score cotangents and dropped probabilities,
  // [batch, heads, t, t]
  float* ds = nullptr;
  float* pd = nullptr;
  int t = 0, n_heads = 0, d = 0, window = 0;
  float scale = 1.f;
  Dropout drop;
};

// One (query, key) pair of head hd: the dropped probability pd and the
// score cotangent ds, from q.k, dout.v, the band terms (when |key - query|
// <= window) and the query row's statistics.
__device__ __forceinline__ void pair_grad(const AttnBwd& a, int b, int hd, int qi,
                                          int key, float dot_qk, float dot_dv,
                                          bool in_band, float qrel_o, float dorv_o,
                                          float m, float linv, float dsum,
                                          bool attend, float& pd, float& ds) {
  float s = dot_qk * a.scale;
  if (in_band) s += qrel_o * a.scale;
  if (!attend) s = -1e4f;
  const float p = expf(s - m) * linv;
  const float dpd = dot_dv + (in_band ? dorv_o : 0.f);
  float keep_scale = 1.f;
  if (a.drop.on)
    keep_scale = site_keep(a.drop.at(hd), b, qi, a.t, key) ? a.drop.scale : 0.f;
  pd = p * keep_scale;
  ds = attend ? p * (dpd * keep_scale - dsum) : 0.f;
}

// ---------------------------------------------------------------------------
// the attention backward on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kKeyChunk = 64;  // keys a block of the f32 score pass walks
constexpr int kScoresSmem = (2 * kTcQ + 2 * kTcKeys) * kTcStride * 4 +
                            4 * kTcQ * kAttnMaxBand * 4 + kTcKeys * 4 + kTcQ * 4;

// A block owns 32 query rows of one (sample, head) and one chunk of 64 keys
// (blockIdx.x = query tile * chunks + chunk): the pairs are independent,
// so more blocks, and no combining.  dqrel and pb start at zero (the
// caller clears them); a block writes the band entries whose key it owns.
__global__ void __launch_bounds__(64) attn_bwd_scores_tc_kernel(const AttnBwd a) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [kTcQ][kTcStride]
  float* ot = qt + kTcQ * kTcStride;            // dout
  float* kt = ot + kTcQ * kTcStride;            // [kTcKeys][kTcStride]
  float* vt = kt + kTcKeys * kTcStride;
  float* qrel = vt + kTcKeys * kTcStride;  // [kTcQ][kAttnMaxBand]
  float* dorv = qrel + kTcQ * kAttnMaxBand;
  float* dqr = dorv + kTcQ * kAttnMaxBand;
  float* pbs = dqr + kTcQ * kAttnMaxBand;
  float* kmask = pbs + kTcQ * kAttnMaxBand;
  float* row_dsum = kmask + kTcKeys;

  const int t = a.t, d = a.d;
  const int chunks = (t + kKeyChunk - 1) / kKeyChunk;
  const int b = blockIdx.z;
  const int hd = blockIdx.y;
  const int q0 = (blockIdx.x / chunks) * kTcQ;
  const int key_lo = (blockIdx.x % chunks) * kKeyChunk;
  const int key_hi = min(t, key_lo + kKeyChunk);
  const int h = a.n_heads * d;
  const int ld = 3 * h;
  const int nb = 2 * a.window + 1;
  const int hb = a.n_heads * nb;
  const int nd = d / 8;
  const float* base = a.qkv + (long)b * t * ld;
  const float* dbase = a.datt + (long)b * t * h;
  const float* mrow = a.mask + (long)b * t;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
  const long z = (long)b * a.n_heads + hd;
  float* ds_out = a.ds + z * t * t;
  float* pd_out = a.pd + z * t * t;

  stage_rows(base + hd * d, ld, q0, kTcQ, t, d, qt, tid, 64);
  stage_rows(dbase + hd * d, h, q0, kTcQ, t, d, ot, tid, 64);
  // per row (CUDA cores, a lane a (row, offset)): q . rel_k and dout . rel_v
  // where the band's key lies in this chunk; dsum = dout . out, two lanes a row
  for (int i = lane; i < 16 * nb; i += 32) {
    const int r = warp * 16 + i / nb, o = i - (i / nb) * nb;
    const int qi = q0 + r, key = qi + o - a.window;
    float pk = 0.f, pv = 0.f;
    if (qi < t && key >= key_lo && key < key_hi) {
      pk = rel_dot<false>(base + (long)qi * ld + hd * d, a.rel_k, o, d);
      pv = rel_dot<false>(dbase + (long)qi * h + hd * d, a.rel_v, o, d);
    }
    qrel[r * kAttnMaxBand + o] = pk;
    dorv[r * kAttnMaxBand + o] = pv;
    dqr[r * kAttnMaxBand + o] = 0.f;
    pbs[r * kAttnMaxBand + o] = 0.f;
  }
  {
    const int r = warp * 16 + lane / 2, qi = q0 + r, half = d / 2;
    float dsr = 0.f;
    if (qi < t) {
      const float* o_row = dbase + (long)qi * h + hd * d + (lane & 1) * half;
      const float* a_row = a.att + ((long)b * t + qi) * h + hd * d + (lane & 1) * half;
      for (int c = 0; c < half; ++c) dsr = fmaf(o_row[c], a_row[c], dsr);
    }
    dsr += __shfl_xor_sync(0xffffffffu, dsr, 1);
    if ((lane & 1) == 0) row_dsum[r] = dsr;
  }
  __syncwarp();
  int rloc[2], qi[2];
  float qm[2], m[2], linv[2], dsum[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rloc[e] = warp * 16 + g + 8 * e;
    qi[e] = q0 + rloc[e];
    const bool ok = qi[e] < t;
    const long at = z * t + qi[e];
    qm[e] = ok ? mrow[qi[e]] : 0.f;
    m[e] = ok ? a.stat_m[at] : 0.f;
    linv[e] = ok ? a.stat_linv[at] : 0.f;
    dsum[e] = row_dsum[rloc[e]];
  }

  for (int k0 = key_lo; k0 < key_hi; k0 += kTcKeys) {
    __syncthreads();  // previous tile consumed (and the row terms written)
    stage_rows(base + h + hd * d, ld, k0, kTcKeys, t, d, kt, tid, 64);
    stage_rows(base + 2 * h + hd * d, ld, k0, kTcKeys, t, d, vt, tid, 64);
    if (tid < kTcKeys) kmask[tid] = k0 + tid < t ? mrow[k0 + tid] : 0.f;
    __syncthreads();
    float qk[4][4], dv[4][4];
    tile_scores(qk, qt, kt, rloc[0], g, qd, nd);
    tile_scores(dv, ot, vt, rloc[0], g, qd, nd);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int key = k0 + n * 8 + 2 * qd + (e & 1);
        if (key >= key_hi || qi[row] >= t) continue;
        const int r = rloc[row];
        const int o = key - qi[row] + a.window;
        const bool in_band = o >= 0 && o < nb;
        float pd, ds;
        pair_grad(a, b, hd, qi[row], key, qk[n][e], dv[n][e], in_band,
                  in_band ? qrel[r * kAttnMaxBand + o] : 0.f,
                  in_band ? dorv[r * kAttnMaxBand + o] : 0.f, m[row], linv[row], dsum[row],
                  qm[row] != 0.f && kmask[key - k0] != 0.f, pd, ds);
        if (in_band) {  // one thread per (row, offset) over the whole walk
          dqr[r * kAttnMaxBand + o] = ds * a.scale;
          pbs[r * kAttnMaxBand + o] = pd;
        }
        const long at = (long)qi[row] * t + key;
        ds_out[at] = ds;
        pd_out[at] = pd;
      }
  }
  __syncwarp();
  for (int i = lane; i < 16 * nb; i += 32) {
    const int r = warp * 16 + i / nb, o = i - (i / nb) * nb;
    const int key = q0 + r + o - a.window;
    if (q0 + r >= t || key < key_lo || key >= key_hi) continue;
    const long at = ((long)b * t + q0 + r) * hb + hd * nb + o;
    a.dqrel[at] = dqr[r * kAttnMaxBand + o];
    a.pb[at] = pbs[r * kAttnMaxBand + o];
  }
}

// dq, dk and dv of every (sample, head): blockIdx.z = product * batch *
// heads + sample * heads + head; a block owns 64 output rows x 32 columns
// (a warp 16 rows), the K walk over t in slices of 32 through shared memory
// split on the way in, 3xTF32, each slice started from zero.
//   product 0: dq = scale * ds k + dqrel rel_k   (A = ds [t, t] as it lies)
//   product 1: dk = scale * ds^T q                (A = ds transposed)
//   product 2: dv = pd^T dout                     (A = pd transposed)
constexpr int kPM = 64, kPN = 32, kPK = 32;
constexpr int kPAStride = 36;  // A [m][k] as it lies; transposed [k][m] at 72
constexpr int kPBStride = 40;  // B [k][n]

__global__ void __launch_bounds__(128) attn_bwd_products_kernel(const AttnBwd a) {
  __shared__ uint32_t a_big[kPM * kPAStride], a_small[kPM * kPAStride];
  __shared__ uint32_t b_big[kPK * kPBStride], b_small[kPK * kPBStride];
  const int t = a.t, d = a.d, H = a.n_heads;
  const int h = H * d;
  const int bh = gridDim.z / 3;
  const int product = blockIdx.z / bh;
  const int zz = blockIdx.z - product * bh;
  const int b = zz / H, hd = zz - (zz / H) * H;
  const int m0 = blockIdx.y * kPM, n0 = blockIdx.x * kPN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
  const bool trans = product != 0;
  const float* src_a = (product == 2 ? a.pd : a.ds) + (long)zz * t * t;
  const float* src_b;
  long ldb;
  if (product == 0) {
    src_b = a.qkv + (long)b * t * 3 * h + h + hd * d;  // k
    ldb = 3 * h;
  } else if (product == 1) {
    src_b = a.qkv + (long)b * t * 3 * h + hd * d;  // q
    ldb = 3 * h;
  } else {
    src_b = a.datt + (long)b * t * h + hd * d;  // dout
    ldb = h;
  }

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int r_lo = warp * 16 + g;
  for (int k0 = 0; k0 < t; k0 += kPK) {
    __syncthreads();
    for (int i = tid; i < kPM * kPK; i += 128) {
      int mm, kk;
      float v = 0.f;
      if (trans) {  // read along m: A[m][k] = src[k][m]
        mm = i % kPM; kk = i / kPM;
        if (m0 + mm < t && k0 + kk < t) v = src_a[(long)(k0 + kk) * t + m0 + mm];
        split_tf32(v, a_big[kk * 72 + mm], a_small[kk * 72 + mm]);
      } else {
        mm = i / kPK; kk = i % kPK;
        if (m0 + mm < t && k0 + kk < t) v = src_a[(long)(m0 + mm) * t + k0 + kk];
        split_tf32(v, a_big[mm * kPAStride + kk], a_small[mm * kPAStride + kk]);
      }
    }
    for (int i = tid; i < kPK * kPN; i += 128) {
      const int kk = i / kPN, nn = i % kPN;
      const float v = k0 + kk < t && n0 + nn < d ? src_b[(long)(k0 + kk) * ldb + n0 + nn] : 0.f;
      split_tf32(v, b_big[kk * kPBStride + nn], b_small[kk * kPBStride + nn]);
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int kc = ks * 8 + qd;
        int i0, i1, i2, i3;  // a0 (r, k), a1 (r + 8, k), a2 (r, k + 4), a3 (r + 8, k + 4)
        if (trans) {
          i0 = kc * 72 + r_lo; i1 = i0 + 8; i2 = (kc + 4) * 72 + r_lo; i3 = i2 + 8;
        } else {
          i0 = r_lo * kPAStride + kc; i1 = i0 + 8 * kPAStride; i2 = i0 + 4; i3 = i1 + 4;
        }
        const uint32_t ab[4] = {a_big[i0], a_big[i1], a_big[i2], a_big[i3]};
        const uint32_t as[4] = {a_small[i0], a_small[i1], a_small[i2], a_small[i3]};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int bi = kc * kPBStride + n * 8 + g;
          const uint32_t bb[2] = {b_big[bi], b_big[bi + 4 * kPBStride]};
          if (pass == 0) {
            const uint32_t bs[2] = {b_small[bi], b_small[bi + 4 * kPBStride]};
            mma_small_terms(part[n], ab, as, bb, bs);
          } else {
            mma_tf32(part[n], ab, bb);
          }
        }
      }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }

  const int nb = 2 * a.window + 1;
  const int hb = H * nb;
  const float sc = product == 2 ? 1.f : a.scale;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + r_lo + 8 * (e >> 1);
      const int c = n0 + n * 8 + 2 * qd + (e & 1);
      if (m >= t || c >= d) continue;
      const long row = (long)b * t + m;
      float v = acc[n][e] * sc;
      if (product == 0)
        for (int o = 0; o < nb; ++o)
          v = fmaf(a.dqrel[row * hb + hd * nb + o], rel_at<false>(a.rel_k, o, d, c), v);
      a.dqkv[row * 3 * h + product * h + hd * d + c] = v;
    }
}

// ---------------------------------------------------------------------------
// the bf16 layer's attention backward (mma.sync m16n8k16 bf16)
// ---------------------------------------------------------------------------

// bf16 views of the chain's bf16 tensors
__device__ __forceinline__ const __nv_bfloat16* b16(const float* p) {
  return reinterpret_cast<const __nv_bfloat16*>(p);
}
__device__ __forceinline__ __nv_bfloat16* b16(float* p) {
  return reinterpret_cast<__nv_bfloat16*>(p);
}

// the Q, dout, K and V tiles (bf16), the band terms, the key mask and the
// rows' dsum
constexpr int kScoresBf16Smem = (2 * kTcQ + 2 * kTcKeys) * kS16 * 2 +
                                4 * kTcQ * kAttnMaxBand * 4 + kTcKeys * 4 + kTcQ * 4;

// attn_bwd_scores_tc_kernel's pairs with bf16 operands: q, k, v (qkv bf16)
// and dout's bf16 copy (dout16) staged as bf16, q.k^T and dout.v^T on
// m16n8k16; dout's f32 values (datt) for the band term dout . rel_v and the
// row term dout . out (att f32); ds and pd written bf16.  A block owns 32
// query rows of one (sample, head) and walks all their keys, so it stages
// them and takes their row terms once and writes every band entry of its
// rows (no fill first): at [32, 192] 105.6 us against 128.4 in 64-key
// chunks (139.5 in 128, 155.4 in 32; more blocks, each row's work repeated).
__global__ void __launch_bounds__(64) attn_bwd_scores_bf16_kernel(const AttnBwd a,
                                                                   const float* dout16) {
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kTcQ][kS16]
  __nv_bfloat16* ot = qt + kTcQ * kS16;                         // dout
  __nv_bfloat16* kt = ot + kTcQ * kS16;                         // [kTcKeys][kS16]
  __nv_bfloat16* vt = kt + kTcKeys * kS16;
  float* qrel = reinterpret_cast<float*>(vt + kTcKeys * kS16);  // [kTcQ][kAttnMaxBand]
  float* dorv = qrel + kTcQ * kAttnMaxBand;
  float* dqr = dorv + kTcQ * kAttnMaxBand;
  float* pbs = dqr + kTcQ * kAttnMaxBand;
  float* kmask = pbs + kTcQ * kAttnMaxBand;
  float* row_dsum = kmask + kTcKeys;

  const int t = a.t, d = a.d;
  const int b = blockIdx.z;
  const int hd = blockIdx.y;
  const int q0 = blockIdx.x * kTcQ;
  const int h = a.n_heads * d;
  const int ld = 3 * h;
  const int nb = 2 * a.window + 1;
  const int hb = a.n_heads * nb;
  const __nv_bfloat16* base = b16(a.qkv) + (long)b * t * ld;
  const float* dbase = a.datt + (long)b * t * h;
  const float* mrow = a.mask + (long)b * t;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
  const long z = (long)b * a.n_heads + hd;
  __nv_bfloat16* ds_out = b16(a.ds) + z * t * t;
  __nv_bfloat16* pd_out = b16(a.pd) + z * t * t;

  stage_rows_bf16(base + hd * d, ld, q0, kTcQ, t, d, qt, tid, 64);
  stage_rows_bf16(b16(dout16) + (long)b * t * h + hd * d, h, q0, kTcQ, t, d, ot, tid, 64);
  __syncthreads();
  // per row (CUDA cores, a lane a (row, offset)): q . rel_k and dout . rel_v
  // where the band's key lies in [0, t); dsum = dout . out, two lanes a row
  for (int i = lane; i < 16 * nb; i += 32) {
    const int r = warp * 16 + i / nb, o = i - (i / nb) * nb;
    const int qi = q0 + r, key = qi + o - a.window;
    float pk = 0.f, pv = 0.f;
    if (qi < t && key >= 0 && key < t) {
      pk = rel_dot_bf16(qt + r * kS16, a.rel_k, o, d);
      pv = rel_dot<true>(dbase + (long)qi * h + hd * d, a.rel_v, o, d);
    }
    qrel[r * kAttnMaxBand + o] = pk;
    dorv[r * kAttnMaxBand + o] = pv;
    dqr[r * kAttnMaxBand + o] = 0.f;
    pbs[r * kAttnMaxBand + o] = 0.f;
  }
  {
    const int r = warp * 16 + lane / 2, qi = q0 + r, half = d / 2;
    float dsr = 0.f;
    if (qi < t) {
      const float* o_row = dbase + (long)qi * h + hd * d + (lane & 1) * half;
      const float* a_row = a.att + ((long)b * t + qi) * h + hd * d + (lane & 1) * half;
      for (int c = 0; c < half; ++c) dsr = fmaf(o_row[c], a_row[c], dsr);
    }
    dsr += __shfl_xor_sync(0xffffffffu, dsr, 1);
    if ((lane & 1) == 0) row_dsum[r] = dsr;
  }
  __syncwarp();
  int rloc[2], qi[2];
  float qm[2], m[2], linv[2], dsum[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rloc[e] = warp * 16 + g + 8 * e;
    qi[e] = q0 + rloc[e];
    const bool ok = qi[e] < t;
    const long at = z * t + qi[e];
    qm[e] = ok ? mrow[qi[e]] : 0.f;
    m[e] = ok ? a.stat_m[at] : 0.f;
    linv[e] = ok ? a.stat_linv[at] : 0.f;
    dsum[e] = row_dsum[rloc[e]];
  }
  const bool pairs = (t & 1) == 0;  // a row's (key, key + 1) is 4-byte aligned

  for (int k0 = 0; k0 < t; k0 += kTcKeys) {
    __syncthreads();  // previous tile consumed (and the row terms written)
    stage_rows_bf16(base + h + hd * d, ld, k0, kTcKeys, t, d, kt, tid, 64);
    stage_rows_bf16(base + 2 * h + hd * d, ld, k0, kTcKeys, t, d, vt, tid, 64);
    if (tid < kTcKeys) kmask[tid] = k0 + tid < t ? mrow[k0 + tid] : 0.f;
    __syncthreads();
    float qk[4][4], dv[4][4];
    tile_scores_bf16(qk, qt, kt, rloc[0], g, qd, d);
    tile_scores_bf16(dv, ot, vt, rloc[0], g, qd, d);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        if (qi[row] >= t) continue;
        const int r = rloc[row];
        float pdv[2] = {0.f, 0.f}, dsv[2] = {0.f, 0.f};
        const int key0 = k0 + n * 8 + 2 * qd;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int key = key0 + c, e = 2 * row + c;
          if (key >= t) continue;
          const int o = key - qi[row] + a.window;
          const bool in_band = o >= 0 && o < nb;
          pair_grad(a, b, hd, qi[row], key, qk[n][e], dv[n][e], in_band,
                    in_band ? qrel[r * kAttnMaxBand + o] : 0.f,
                    in_band ? dorv[r * kAttnMaxBand + o] : 0.f, m[row], linv[row], dsum[row],
                    qm[row] != 0.f && kmask[key - k0] != 0.f, pdv[c], dsv[c]);
          if (in_band) {  // one thread per (row, offset) over the whole walk
            dqr[r * kAttnMaxBand + o] = dsv[c] * a.scale;
            pbs[r * kAttnMaxBand + o] = round_bf16(pdv[c]);
          }
        }
        const long at = (long)qi[row] * t + key0;
        if (key0 >= t) continue;
        if (pairs && key0 + 1 < t) {
          *reinterpret_cast<__nv_bfloat162*>(ds_out + at) = __floats2bfloat162_rn(dsv[0], dsv[1]);
          *reinterpret_cast<__nv_bfloat162*>(pd_out + at) = __floats2bfloat162_rn(pdv[0], pdv[1]);
        } else {
          ds_out[at] = __float2bfloat16_rn(dsv[0]);
          pd_out[at] = __float2bfloat16_rn(pdv[0]);
          if (key0 + 1 < t) {
            ds_out[at + 1] = __float2bfloat16_rn(dsv[1]);
            pd_out[at + 1] = __float2bfloat16_rn(pdv[1]);
          }
        }
      }
  }
  __syncwarp();
  for (int i = lane; i < 16 * nb; i += 32) {  // every band entry of the rows, 0 off [0, t)
    const int r = warp * 16 + i / nb, o = i - (i / nb) * nb;
    if (q0 + r >= t) continue;
    const long at = ((long)b * t + q0 + r) * hb + hd * nb + o;
    a.dqrel[at] = dqr[r * kAttnMaxBand + o];
    a.pb[at] = pbs[r * kAttnMaxBand + o];
  }
}

// attn_bwd_products_kernel's blocks (64 output rows x 32 columns, a warp 16
// rows) and products with bf16 operands as they lie in memory (ds, pd, k,
// q, dout's bf16 copy dout16), a 32-deep slice of each through shared
// memory: A [m][k] read by pairs, or transposed ([k][m] staged, by
// ldmatrix.trans), B [k][n] by ldmatrix.trans; m16n8k16 with f32
// accumulators; dqkv f32 and its bf16 copy dqkv16.
constexpr int kPA16 = kPK + 8;  // A [m][k] bf16 row: 80 bytes, conflict-free pairs
constexpr int kPT16 = kPM + 8;  // A^T [k][m] and
constexpr int kPB16 = kPN + 8;  // B [k][n] bf16 rows: conflict-free ldmatrix rows

__global__ void __launch_bounds__(128) attn_bwd_products_bf16_kernel(const AttnBwd a,
                                                                      const float* dout16,
                                                                      float* dqkv16) {
  __shared__ __align__(16) __nv_bfloat16 as[kPM * kPA16 > kPK * kPT16 ? kPM * kPA16 : kPK * kPT16];
  __shared__ __align__(16) __nv_bfloat16 bs[kPK * kPB16];
  const int t = a.t, d = a.d, H = a.n_heads;
  const int h = H * d;
  const int bh = gridDim.z / 3;
  const int product = blockIdx.z / bh;
  const int zz = blockIdx.z - product * bh;
  const int b = zz / H, hd = zz - (zz / H) * H;
  const int m0 = blockIdx.y * kPM, n0 = blockIdx.x * kPN;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
  const bool trans = product != 0;
  const __nv_bfloat16* src_a = b16(product == 2 ? a.pd : a.ds) + (long)zz * t * t;
  const __nv_bfloat16* src_b;
  long ldb;
  if (product == 0) {
    src_b = b16(a.qkv) + (long)b * t * 3 * h + h + hd * d;  // k
    ldb = 3 * h;
  } else if (product == 1) {
    src_b = b16(a.qkv) + (long)b * t * 3 * h + hd * d;  // q
    ldb = 3 * h;
  } else {
    src_b = b16(dout16) + (long)b * t * h + hd * d;  // dout
    ldb = h;
  }
  const bool vec = (t & 7) == 0;  // ds and pd rows in whole 16-byte groups

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int wm = warp * 16;
  for (int k0 = 0; k0 < t; k0 += kPK) {
    __syncthreads();
    // A: 64 x 32 of src (trans: src rows k0.., columns m0..; else rows
    // m0.., columns k0..), 8 elements a unit
    const int rows_a = trans ? kPK : kPM, cols_a = trans ? kPM : kPK;
    const int r0 = trans ? k0 : m0, c0 = trans ? m0 : k0;
    const int stride_a = trans ? kPT16 : kPA16;
    for (int u = tid; u < rows_a * cols_a / 8; u += 128) {
      const int r = u / (cols_a / 8), c = (u - r * (cols_a / 8)) * 8;
      const int sr = r0 + r, sc = c0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (sr < t) {
        if (vec && sc + 8 <= t) {
          v = *reinterpret_cast<const uint4*>(src_a + (long)sr * t + sc);
        } else {
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
          for (int j = 0; j < 8; ++j)
            if (sc + j < t) e[j] = src_a[(long)sr * t + sc + j];
        }
      }
      *reinterpret_cast<uint4*>(as + r * stride_a + c) = v;
    }
    // B: 32 x 32 of src_b (rows k0.., columns n0..; d a multiple of 8)
    for (int u = tid; u < kPK * kPN / 8; u += 128) {
      const int r = u / (kPN / 8), c = (u - r * (kPN / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < t && n0 + c < d)
        v = *reinterpret_cast<const uint4*>(src_b + (long)(k0 + r) * ldb + n0 + c);
      *reinterpret_cast<uint4*>(bs + r * kPB16 + c) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kPK; ks += 16) {
      uint32_t af[4];
      if (trans) {
        const int mat = lane >> 3, r8 = lane & 7;
        ldmatrix_x4_trans(af, as + (ks + (mat >> 1) * 8 + r8) * kPT16 + wm + (mat & 1) * 8);
      } else {
        const __nv_bfloat16* ar = as + (wm + g) * kPA16 + ks + 2 * qd;
        af[0] = pair_at(ar);
        af[1] = pair_at(ar + 8 * kPA16);
        af[2] = pair_at(ar + 8);
        af[3] = pair_at(ar + 8 * kPA16 + 8);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, bs + (ks + (lane & 15)) * kPB16 + n * 8);
        mma_bf16(acc[n], af, bf);
      }
    }
  }

  const int nb = 2 * a.window + 1;
  const int hb = H * nb;
  const float sc = product == 2 ? 1.f : a.scale;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + wm + g + 8 * (e >> 1);
      const int c = n0 + n * 8 + 2 * qd + (e & 1);
      if (m >= t || c >= d) continue;
      const long row = (long)b * t + m;
      float v = acc[n][e] * sc;
      if (product == 0)
        for (int o = 0; o < nb; ++o)
          v = fmaf(a.dqrel[row * hb + hd * nb + o], rel_at<true>(a.rel_k, o, d, c), v);
      const long at = row * 3 * h + product * h + hd * d + c;
      a.dqkv[at] = v;
      b16(dqkv16)[at] = __float2bfloat16_rn(v);
    }
}

// d rel_k[o, c] = sum over rows and heads of dqrel[row, head, o] q[row,
// head, c] (table 0) and d rel_v[o, c] = sum of pb[row, head, o] dout[row,
// head, c] (table 1): one block per (8 columns, offset, table) and 128 row
// groups (a warp: 8 neighbouring columns of 4 rows), per head eight rows in
// flight a thread in independent sums, combined in a fixed order.
constexpr int kRelCols = 8, kRelGroups = 128;

// bf16 (out_bf16): q bf16 in qkv, the tables' gradients written bf16.
__global__ void __launch_bounds__(kRelCols * kRelGroups)
    rel_grads_kernel(const AttnBwd a, int rows, float* drk, float* drv, int out_bf16) {
  __shared__ float part[kRelGroups][kRelCols + 1];
  const int H = a.n_heads, d = a.d, h = H * d;
  const int nb = 2 * a.window + 1;
  const int o = blockIdx.y;
  const int table = blockIdx.z;
  const int c = blockIdx.x * kRelCols + threadIdx.x;
  const float* coef = (table ? a.pb : a.dqrel) + o;
  const float* val = table ? a.datt : a.qkv;
  const long ld = table ? h : 3 * h;
  float acc8[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (c < d)
    for (int hd = 0; hd < H; ++hd)
      for (int r0 = 8 * threadIdx.y; r0 < rows; r0 += 8 * kRelGroups) {
        float cf[8], v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = r0 + j;
          const bool ok = row < rows;
          cf[j] = ok ? coef[((long)row * H + hd) * nb] : 0.f;
          v[j] = ok ? ld_act(val, row * ld + hd * d + c, table == 0 && out_bf16) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) acc8[j] = fmaf(cf[j], v[j], acc8[j]);
      }
  part[threadIdx.y][threadIdx.x] = ((acc8[0] + acc8[1]) + (acc8[2] + acc8[3])) +
                                   ((acc8[4] + acc8[5]) + (acc8[6] + acc8[7]));
  __syncthreads();
  if (threadIdx.y == 0 && c < d) {
    float total = 0.f;
#pragma unroll 8
    for (int y = 0; y < kRelGroups; ++y) total += part[y][threadIdx.x];
    st_act(table ? drv : drk, (long)o * d + c, total, out_bf16 != 0);
  }
}

// The bf16 layer's tables' gradients, the same sums in two launches that
// fill the card: rel_grads_part_kernel, per (chunk of kRelRows rows, table)
// a block, a thread per (offset, column), sums its rows and heads in order
// into part [2][chunks][2w+1][d]; rel_grads_sum_kernel adds the chunks in
// order and writes bf16.  (rel_grads_kernel's 216 blocks each read a column
// group's values once per offset, nine times over: 51 us at [32, 192].)
constexpr int kRelRows = 64;

__global__ void __launch_bounds__(256) rel_grads_part_kernel(const AttnBwd a, int rows,
                                                             float* part) {
  const int H = a.n_heads, d = a.d, h = H * d;
  const int nb = 2 * a.window + 1;
  const int chunk = blockIdx.x, table = blockIdx.y;
  const float* coef = table ? a.pb : a.dqrel;
  const float* val = table ? a.datt : a.qkv;  // dout f32; q in qkv, bf16
  const long ld = table ? h : 3 * h;
  const int r0 = chunk * kRelRows, r1 = min(rows, r0 + kRelRows);
  for (int i = threadIdx.x; i < nb * d; i += blockDim.x) {
    const int o = i / d, c = i - o * d;
    float acc = 0.f;
    for (int hd = 0; hd < H; ++hd)
#pragma unroll 8
      for (int r = r0; r < r1; ++r)
        acc = fmaf(coef[((long)r * H + hd) * nb + o], ld_act(val, r * ld + hd * d + c, table == 0),
                   acc);
    part[(((long)table * gridDim.x + chunk) * nb + o) * d + c] = acc;
  }
}

__global__ void rel_grads_sum_kernel(const float* part, int chunks, int per_table, float* drk,
                                     float* drv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * per_table) return;
  const int table = i / per_table, k = i - table * per_table;
  const float* p = part + (long)table * chunks * per_table + k;
  float total = 0.f;
  for (int c = 0; c < chunks; ++c) total += p[(long)c * per_table];
  st_act(table ? drv : drk, k, total, true);
}

// The attention backward's launches: dqrel and pb (adjacent in the
// scratch) filled with zeros, the score pass, the products, both rel-pos
// tables' gradients (shared by the heads: one launch).  bf16: the bf16
// kernels (qkv bf16, ds and pd bf16; the score pass writes every band
// entry, so no fill), dout's bf16 copy dout16, dq, dk, dv also written to
// dqkv16 in bf16; the tables' gradients bf16, in two launches through
// rel_part (rel_part_floats(rows, d, window) floats).
long rel_part_floats(int rows, int d, int window) {
  return 2L * ((rows + kRelRows - 1) / kRelRows) * (2 * window + 1) * d;
}

cudaError_t attention_bwd(const AttnBwd& ab, int batch, float* drk, float* drv, bool bf16,
                          const float* dout16, float* dqkv16, float* rel_part,
                          cudaStream_t stream) {
  const int t = ab.t, H = ab.n_heads, d = ab.d;
  const int q_tiles = (t + kTcQ - 1) / kTcQ;
  const dim3 product_grid((d + kPN - 1) / kPN, (t + kPM - 1) / kPM, 3 * batch * H);
  cudaError_t err;
  if (bf16) {
    err = cudaFuncSetAttribute(attn_bwd_scores_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kScoresBf16Smem);
    if (err != cudaSuccess) return err;
    attn_bwd_scores_bf16_kernel<<<dim3(q_tiles, H, batch), 64, kScoresBf16Smem, stream>>>(ab,
                                                                                        dout16);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_bwd_products_bf16_kernel<<<product_grid, 128, 0, stream>>>(ab, dout16, dqkv16);
  } else {
    err = cudaMemsetAsync(ab.dqrel, 0, (ab.pb - ab.dqrel) * 2 * sizeof(float), stream);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attn_bwd_scores_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kScoresSmem);
    if (err != cudaSuccess) return err;
    const int chunks = (t + kKeyChunk - 1) / kKeyChunk;
    attn_bwd_scores_tc_kernel<<<dim3(q_tiles * chunks, H, batch), 64, kScoresSmem, stream>>>(ab);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    attn_bwd_products_kernel<<<product_grid, 128, 0, stream>>>(ab);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (bf16) {
    const int chunks = (batch * t + kRelRows - 1) / kRelRows;
    const int per_table = (2 * ab.window + 1) * d;
    rel_grads_part_kernel<<<dim3(chunks, 2), 256, 0, stream>>>(ab, batch * t, rel_part);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    rel_grads_sum_kernel<<<(2 * per_table + 255) / 256, 256, 0, stream>>>(rel_part, chunks,
                                                                          per_table, drk, drv);
    return cudaGetLastError();
  }
  rel_grads_kernel<<<dim3((d + kRelCols - 1) / kRelCols, 2 * ab.window + 1, 2),
                     dim3(kRelCols, kRelGroups), 0, stream>>>(ab, batch * t, drk, drv, 0);
  return cudaGetLastError();
}

#define GTT_TRY(expr)                               \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

WGrad text_wgrad(const EncoderScratch& s, const float* a, int lda, int c_in, const float* a_mask,
                 int taps, int batch, int t, const float* dy, int ldy, int n, float* out,
                 unsigned bf16 = 0) {
  WGrad w;
  w.bf16 = bf16;
  w.a = a; w.lda = lda; w.c_in = c_in; w.a_mask = a_mask; w.taps = taps;
  w.batch = batch; w.t = t; w.dy = dy; w.ldy = ldy; w.n = n; w.out = out;
  w.scratch = s.wg; w.scratch_floats = s.wg_floats; w.tc = 1;
  return w;
}

}  // namespace
}  // namespace gtt

// Weights: the merged [h, 3h] Q/K/V projection and the rest of the layer
// (encoder.cuh).  Outputs: dx and the 14 weight gradients, the recomputed
// forward's output `out` and its FFN activation `ffn` [rows, f] (the
// dropped, masked ReLU output; the backward's ReLU gates are where it is
// positive).  Scratch: one block of gtt_encoder_scratch_floats(..., 1)
// floats.
namespace {

// bf16 (EncoderArgs::bf16): x, dout, dx, out, the weights, the tables and
// their gradients bf16; ffn and the bias and norm gradients f32.
int encoder_bwd_entry(
    const float* x, const float* mask, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* rel_k, const float* rel_v, const float* gamma1,
    const float* beta1, const float* gamma2, const float* beta2, const float* w1,
    const float* c1, const float* w2, const float* c2, const float* dout, float* dx,
    float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* drk, float* drv, float* dg1,
    float* dbe1, float* dg2, float* dbe2, float* dw1, float* dc1, float* dw2, float* dc2,
    float* out, float* ffn, float* scratch, long long scratch_floats, int batch, int t, int h,
    int n_heads, int window, int f, int taps, int drop, int seed, unsigned threshold,
    float scale, bool bf16, cudaStream_t stream) {
  using namespace gtt;
  const int H = n_heads;
  const int d = h / H;
  const int rows = batch * t;
  const unsigned bf = bf16 ? kBf16 | kA16 | kW16 : 0u;  // a transposed product's bits
  const unsigned wbf = bf16 ? kBf16 | kOut16 : 0u;  // a weight gradient's

  EncoderArgs a;
  a.bf16 = bf16;
  a.x = x; a.mask = mask; a.wqkv = wqkv; a.bqkv = bqkv; a.wo = wo; a.bo = bo;
  a.rel_k = rel_k; a.rel_v = rel_v;
  a.gamma1 = gamma1; a.beta1 = beta1; a.gamma2 = gamma2; a.beta2 = beta2;
  a.w1 = w1; a.c1 = c1; a.w2 = w2; a.c2 = c2; a.out = out;
  a.dims.batch = batch; a.dims.t = t; a.dims.h = h; a.dims.n_heads = H;
  a.dims.window = window; a.dims.f = f; a.dims.taps = taps;
  a.save = true;
  if (encoder_scratch(scratch, a.dims, true, ffn, &a.s, bf16) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = make_dropout(drop, seed, H + 3, threshold, scale);
  GTT_TRY(encoder_forward(a, stream));
  const EncoderScratch& s = a.s;

  // the four transposed products (reading the forward's weights as they
  // lie), their weights split for the tensor cores in one launch (the f32
  // chain's; bf16: each reads its operand's bf16 copy)
  ConvGemm dffn_g = text_product(s, bf16);  // dffn = (conv^T db) * mask * keep * [ffn > 0]
  dffn_g.a = bf16 ? s.db16 : s.db; dffn_g.lda = h; dffn_g.c_in = h; dffn_g.taps = taps;
  dffn_g.tap_sign = -1;
  dffn_g.batch = batch; dffn_g.t = t; dffn_g.w = w2; dffn_g.w_t = 1; dffn_g.n = f;
  dffn_g.epilogue = kMaskReluBwd; dffn_g.out = s.dffn; dffn_g.ldo = f; dffn_g.mask = mask;
  dffn_g.aux = ffn; dffn_g.ld_aux = f; dffn_g.drop = a.drop.at(H + 1);
  dffn_g.bf16 = bf; dffn_g.out_c = s.dffn16;
  ConvGemm dx1_g = text_product(s, bf16);  // db = d(x1) = da + (conv^T dffn) * mask
  dx1_g.a = bf16 ? s.dffn16 : s.dffn; dx1_g.lda = f; dx1_g.c_in = f; dx1_g.taps = taps;
  dx1_g.tap_sign = -1;
  dx1_g.batch = batch; dx1_g.t = t; dx1_g.w = w1; dx1_g.w_t = 1; dx1_g.n = h;
  dx1_g.epilogue = kMaskAdd; dx1_g.out = s.db; dx1_g.ldo = h; dx1_g.mask = mask;
  dx1_g.aux = s.da; dx1_g.ld_aux = h;
  dx1_g.bf16 = bf;
  ConvGemm datt_g = text_product(s, bf16);  // datt = dc wo^T
  datt_g.a = bf16 ? s.dc16 : s.dc; datt_g.lda = h; datt_g.c_in = h; datt_g.batch = batch;
  datt_g.t = t; datt_g.w = wo; datt_g.w_t = 1; datt_g.n = h; datt_g.epilogue = kBias;
  datt_g.out = s.datt; datt_g.ldo = h;
  datt_g.bf16 = bf; datt_g.out_c = s.datt16;  // dout_ht, for the attention products
  ConvGemm dx_g = text_product(s, bf16);  // dx = (da + dqkv wqkv^T) * mask
  dx_g.a = bf16 ? s.dqkv16 : s.dqkv; dx_g.lda = 3 * h; dx_g.c_in = 3 * h; dx_g.batch = batch;
  dx_g.t = t;
  dx_g.w = wqkv; dx_g.w_t = 1; dx_g.n = h; dx_g.epilogue = kResidMask; dx_g.out = dx;
  dx_g.ldo = h; dx_g.mask = mask; dx_g.aux = s.da; dx_g.ld_aux = h;
  dx_g.bf16 = bf ? bf | kOut16 : 0u;
  ConvGemm* const products[4] = {&dffn_g, &dx1_g, &datt_g, &dx_g};
  if (!bf16)
    GTT_TRY(presplit_weights(products, 4, s.tc + s.tc_floats / 2, s.tc_floats / 2, stream));
  // a weight gradient of the bf16 chain reads A and dY's bf16 copies (dy:
  // the f32 values, unused by the TMA-fed kernel)
  auto weight_grad = [&](const float* a32, const float* a16, int lda, int k_taps, const float* dy,
                         const float* dy16, int n, float* out) {
    WGrad w = text_wgrad(s, bf16 ? a16 : a32, lda, lda, nullptr, k_taps, batch, t, dy, n, n,
                         out, bf16 ? wbf | kA16 : 0u);
    if (bf16) {
      w.dy16 = dy16;
      w.tma_ring = 1;
    }
    return wgrad(w, stream);
  };

  // ---- second norm: da = d(x1 + y2), db = its dropped, masked FFN branch ----
  {
    LayerNormBwd ln;
    ln.dy = dout; ln.xhat = s.xhat2; ln.rstd = s.rstd2; ln.gamma = gamma2;
    ln.dx = s.da; ln.dx2 = s.db; ln.drop2 = a.drop.at(H + 2); ln.mask2 = mask;
    ln.dx2_c = s.db16;  // dconv2.astype(bf16)
    ln.rows = rows; ln.n = h; ln.t = t;
    ln.bf16 = bf16 ? kAux16 : 0u;
    GTT_TRY(layer_norm_bwd(ln, stream));
  }
  // the bias and norm gradients' column sums (f32, of the unrounded
  // values): each its own launch in the f32 chain; in the bf16 chain one
  // launch at the end for all whose input lives that long (every one but
  // dc2's: db is overwritten by d(x1))
  ColumnSumJobs sums;
  auto column_sum = [&](const float* x, int n, const float* mul, float* out, float* out2,
                        bool x16) -> cudaError_t {
    if (!bf16) return column_sums(x, n, n, mul, rows, out, out2, stream, x16);
    ColumnSumJob& j = sums.job[sums.count++];
    j.x = x; j.ld = n; j.n = n; j.mul = mul; j.out = out; j.out2 = out2; j.x_bf16 = x16;
    return cudaSuccess;
  };
  GTT_TRY(column_sum(dout, h, s.xhat2, dg2, dbe2, bf16));

  // ---- FFN (ffn is masked: no input mask on its products) ----
  GTT_TRY(weight_grad(ffn, s.rm16, f, taps, s.db, s.db16, h, dw2));
  GTT_TRY(column_sums(s.db, h, h, nullptr, rows, dc2, nullptr, stream));
  GTT_TRY(conv_gemm(dffn_g, stream));
  GTT_TRY(weight_grad(s.x1m, s.x1m, h, taps, s.dffn, s.dffn16, f, dw1));
  GTT_TRY(column_sum(s.dffn, f, nullptr, dc1, nullptr, false));
  GTT_TRY(conv_gemm(dx1_g, stream));

  // ---- first norm: da = d(x * mask + y), dc = dy (dropped) ----
  {
    LayerNormBwd ln;
    ln.dy = s.db; ln.xhat = s.xhat1; ln.rstd = s.rstd1; ln.gamma = gamma1;
    ln.dx = s.da; ln.dx2 = s.dc; ln.drop2 = a.drop.at(H);
    ln.dx2_c = s.dc16;  // dyt
    ln.rows = rows; ln.n = h; ln.t = t;
    GTT_TRY(layer_norm_bwd(ln, stream));
  }
  GTT_TRY(column_sum(s.db, h, s.xhat1, dg1, dbe1, false));

  // ---- output projection ----
  GTT_TRY(column_sum(s.dc, h, nullptr, dbo, nullptr, false));
  GTT_TRY(weight_grad(s.att, s.att16, h, 1, s.dc, s.dc16, h, dwo));
  GTT_TRY(conv_gemm(datt_g, stream));

  // ---- attention core ----
  {
    AttnBwd ab;
    ab.qkv = s.qkv; ab.mask = mask; ab.rel_k = rel_k; ab.rel_v = rel_v;
    ab.att = s.att; ab.datt = s.datt; ab.stat_m = s.stat_m; ab.stat_linv = s.stat_linv;
    ab.dqkv = s.dqkv; ab.dqrel = s.dqrel; ab.pb = s.pb; ab.ds = s.ds; ab.pd = s.pd;
    ab.t = t; ab.n_heads = H; ab.d = d; ab.window = window;
    ab.scale = 1.f / sqrtf((float)d); ab.drop = a.drop;
    // (bf16: the tables' partial sums in the weight gradients' scratch,
    // free between products)
    if (bf16 && rel_part_floats(rows, d, window) > s.wg_floats) return (int)cudaErrorInvalidValue;
    GTT_TRY(attention_bwd(ab, batch, drk, drv, bf16, s.datt16, s.dqkv16, s.wg, stream));
  }

  // ---- the Q/K/V projection: one weight and one bias gradient ----
  if (bf16) {
    GTT_TRY(weight_grad(nullptr, s.xm16, h, 1, s.dqkv, s.dqkv16, 3 * h, dwqkv));
  } else {
    GTT_TRY(wgrad(text_wgrad(s, x, h, h, mask, 1, batch, t, s.dqkv, 3 * h, 3 * h, dwqkv), stream));
  }
  GTT_TRY(column_sum(s.dqkv, 3 * h, nullptr, dbqkv, nullptr, false));
  GTT_TRY(conv_gemm(dx_g, stream));
  if (bf16) GTT_TRY(column_sums(sums, rows, stream));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gtt_encoder_layer_bwd(
    const float* x, const float* mask, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* rel_k, const float* rel_v, const float* gamma1,
    const float* beta1, const float* gamma2, const float* beta2, const float* w1,
    const float* c1, const float* w2, const float* c2, const float* dout, float* dx,
    float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* drk, float* drv, float* dg1,
    float* dbe1, float* dg2, float* dbe2, float* dw1, float* dc1, float* dw2, float* dc2,
    float* out, float* ffn, float* scratch, long long scratch_floats, int batch, int t, int h,
    int n_heads, int window, int f, int taps, int drop, int seed, unsigned threshold,
    float scale, cudaStream_t stream) {
  return encoder_bwd_entry(x, mask, wqkv, bqkv, wo, bo, rel_k, rel_v, gamma1, beta1, gamma2,
                           beta2, w1, c1, w2, c2, dout, dx, dwqkv, dbqkv, dwo, dbo, drk, drv,
                           dg1, dbe1, dg2, dbe2, dw1, dc1, dw2, dc2, out, ffn, scratch,
                           scratch_floats, batch, t, h, n_heads, window, f, taps, drop, seed,
                           threshold, scale, false, stream);
}

// Floats of gtt_bf16_attention_bwd's scratch: the band sums dqrel and pb
// [rows, heads, 2w+1] each (f32), ds and pd [batch, heads, t, t] (bf16),
// the tables' partial sums (for head widths up to kAttnMaxD).
extern "C" long long gtt_bf16_attention_bwd_scratch_floats(int batch, int t, int n_heads,
                                                           int window) {
  const long long bands = (long long)batch * t * n_heads * (2 * window + 1);
  const long long pairs = (long long)batch * n_heads * t * t;
  return 2 * ((bands + 3) / 4 * 4) + 2 * (((pairs + 1) / 2 + 3) / 4 * 4) +
         gtt::rel_part_floats(batch * t, gtt::kAttnMaxD, window);
}

// The bf16 attention backward alone (its score pass, products and rel-pos
// gradients), for tests: from gtt_bf16_attention's qkv16, att (f32) and
// statistics, and the heads' output cotangent datt (f32) with its bf16 copy
// datt16 -> dqkv [batch * t, 3h] f32 and its bf16 copy dqkv16, the tables'
// gradients drk, drv (bf16).
extern "C" int gtt_bf16_attention_bwd(const float* qkv16, const float* mask, const float* rel_k,
                                      const float* rel_v, const float* att, const float* stat_m,
                                      const float* stat_linv, const float* datt,
                                      const float* datt16, float* dqkv, float* dqkv16,
                                      float* drk, float* drv, float* scratch,
                                      long long scratch_floats, int batch, int t, int n_heads,
                                      int d, int window, int drop, int seed, unsigned threshold,
                                      float scale, cudaStream_t stream) {
  using namespace gtt;
  if (!attention_fits(d, window, rel_k, rel_v) ||
      scratch_floats < gtt_bf16_attention_bwd_scratch_floats(batch, t, n_heads, window))
    return (int)cudaErrorInvalidValue;
  const long long bands = (long long)batch * t * n_heads * (2 * window + 1);
  const long long pairs = (long long)batch * n_heads * t * t;
  AttnBwd ab;
  ab.qkv = qkv16; ab.mask = mask; ab.rel_k = rel_k; ab.rel_v = rel_v;
  ab.att = att; ab.datt = datt; ab.stat_m = stat_m; ab.stat_linv = stat_linv; ab.dqkv = dqkv;
  ab.dqrel = scratch;
  ab.pb = ab.dqrel + (bands + 3) / 4 * 4;
  ab.ds = ab.pb + (bands + 3) / 4 * 4;
  ab.pd = ab.ds + ((pairs + 1) / 2 + 3) / 4 * 4;
  float* rel_part = ab.pd + ((pairs + 1) / 2 + 3) / 4 * 4;
  ab.t = t; ab.n_heads = n_heads; ab.d = d; ab.window = window;
  ab.scale = 1.f / sqrtf((float)d);
  ab.drop = make_dropout(drop, seed, n_heads + 3, threshold, scale);
  return (int)attention_bwd(ab, batch, drk, drv, true, datt16, dqkv16, rel_part, stream);
}

// The same in bf16 (EncoderArgs::bf16): x, dout, dx, out, the weights, the
// rel-pos tables and their gradients bf16; ffn f32.
extern "C" int gtt_encoder_layer_bwd_bf16(
    const float* x, const float* mask, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* rel_k, const float* rel_v, const float* gamma1,
    const float* beta1, const float* gamma2, const float* beta2, const float* w1,
    const float* c1, const float* w2, const float* c2, const float* dout, float* dx,
    float* dwqkv, float* dbqkv, float* dwo, float* dbo, float* drk, float* drv, float* dg1,
    float* dbe1, float* dg2, float* dbe2, float* dw1, float* dc1, float* dw2, float* dc2,
    float* out, float* ffn, float* scratch, long long scratch_floats, int batch, int t, int h,
    int n_heads, int window, int f, int taps, int drop, int seed, unsigned threshold,
    float scale, cudaStream_t stream) {
  return encoder_bwd_entry(x, mask, wqkv, bqkv, wo, bo, rel_k, rel_v, gamma1, beta1, gamma2,
                           beta2, w1, c1, w2, c2, dout, dx, dwqkv, dbqkv, dwo, dbo, drk, drv,
                           dg1, dbe1, dg2, dbe2, dw1, dc1, dw2, dc2, out, ffn, scratch,
                           scratch_floats, batch, t, h, n_heads, window, f, taps, drop, seed,
                           threshold, scale, true, stream);
}
