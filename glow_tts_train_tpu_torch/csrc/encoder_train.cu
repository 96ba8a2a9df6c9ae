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

constexpr int kKeyChunk = 64;  // keys a block of the score pass walks
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
      pk = row_dot(base + (long)qi * ld + hd * d, a.rel_k + o * d, d);
      pv = row_dot(dbase + (long)qi * h + hd * d, a.rel_v + o * d, d);
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
        for (int o = 0; o < nb; ++o) v = fmaf(a.dqrel[row * hb + hd * nb + o], a.rel_k[o * d + c], v);
      a.dqkv[row * 3 * h + product * h + hd * d + c] = v;
    }
}

// d rel_k[o, c] = sum over rows and heads of dqrel[row, head, o] q[row,
// head, c] (table 0) and d rel_v[o, c] = sum of pb[row, head, o] dout[row,
// head, c] (table 1): one block per (8 columns, offset, table) and 128 row
// groups (a warp: 8 neighbouring columns of 4 rows), per head eight rows in
// flight a thread in independent sums, combined in a fixed order.
constexpr int kRelCols = 8, kRelGroups = 128;

__global__ void __launch_bounds__(kRelCols * kRelGroups)
    rel_grads_kernel(const AttnBwd a, int rows, float* drk, float* drv) {
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
          v[j] = ok ? val[row * ld + hd * d + c] : 0.f;
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
    (table ? drv : drk)[o * d + c] = total;
  }
}

#define GTT_TRY(expr)                               \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

WGrad text_wgrad(const EncoderScratch& s, const float* a, int lda, int c_in, const float* a_mask,
                 int taps, int batch, int t, const float* dy, int ldy, int n, float* out) {
  WGrad w;
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
  using namespace gtt;
  const int H = n_heads;
  const int d = h / H;
  const int rows = batch * t;

  EncoderArgs a;
  a.x = x; a.mask = mask; a.wqkv = wqkv; a.bqkv = bqkv; a.wo = wo; a.bo = bo;
  a.rel_k = rel_k; a.rel_v = rel_v;
  a.gamma1 = gamma1; a.beta1 = beta1; a.gamma2 = gamma2; a.beta2 = beta2;
  a.w1 = w1; a.c1 = c1; a.w2 = w2; a.c2 = c2; a.out = out;
  a.dims.batch = batch; a.dims.t = t; a.dims.h = h; a.dims.n_heads = H;
  a.dims.window = window; a.dims.f = f; a.dims.taps = taps;
  a.save = true;
  if (encoder_scratch(scratch, a.dims, true, ffn, &a.s) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = make_dropout(drop, seed, H + 3, threshold, scale);
  GTT_TRY(encoder_forward(a, stream));
  const EncoderScratch& s = a.s;

  // the four transposed products (reading the forward's weights as they
  // lie), their weights split for the tensor cores in one launch
  ConvGemm dffn_g = text_product(s);  // dffn = (conv^T db) * mask * keep * [ffn > 0]
  dffn_g.a = s.db; dffn_g.lda = h; dffn_g.c_in = h; dffn_g.taps = taps; dffn_g.tap_sign = -1;
  dffn_g.batch = batch; dffn_g.t = t; dffn_g.w = w2; dffn_g.w_t = 1; dffn_g.n = f;
  dffn_g.epilogue = kMaskReluBwd; dffn_g.out = s.dffn; dffn_g.ldo = f; dffn_g.mask = mask;
  dffn_g.aux = ffn; dffn_g.ld_aux = f; dffn_g.drop = a.drop.at(H + 1);
  ConvGemm dx1_g = text_product(s);  // db = d(x1) = da + (conv^T dffn) * mask
  dx1_g.a = s.dffn; dx1_g.lda = f; dx1_g.c_in = f; dx1_g.taps = taps; dx1_g.tap_sign = -1;
  dx1_g.batch = batch; dx1_g.t = t; dx1_g.w = w1; dx1_g.w_t = 1; dx1_g.n = h;
  dx1_g.epilogue = kMaskAdd; dx1_g.out = s.db; dx1_g.ldo = h; dx1_g.mask = mask;
  dx1_g.aux = s.da; dx1_g.ld_aux = h;
  ConvGemm datt_g = text_product(s);  // datt = dc wo^T
  datt_g.a = s.dc; datt_g.lda = h; datt_g.c_in = h; datt_g.batch = batch; datt_g.t = t;
  datt_g.w = wo; datt_g.w_t = 1; datt_g.n = h; datt_g.epilogue = kBias; datt_g.out = s.datt;
  datt_g.ldo = h;
  ConvGemm dx_g = text_product(s);  // dx = (da + dqkv wqkv^T) * mask
  dx_g.a = s.dqkv; dx_g.lda = 3 * h; dx_g.c_in = 3 * h; dx_g.batch = batch; dx_g.t = t;
  dx_g.w = wqkv; dx_g.w_t = 1; dx_g.n = h; dx_g.epilogue = kResidMask; dx_g.out = dx;
  dx_g.ldo = h; dx_g.mask = mask; dx_g.aux = s.da; dx_g.ld_aux = h;
  ConvGemm* const products[4] = {&dffn_g, &dx1_g, &datt_g, &dx_g};
  GTT_TRY(presplit_weights(products, 4, s.tc + s.tc_floats / 2, s.tc_floats / 2, stream));

  // ---- second norm: da = d(x1 + y2), db = its dropped, masked FFN branch ----
  {
    LayerNormBwd ln;
    ln.dy = dout; ln.xhat = s.xhat2; ln.rstd = s.rstd2; ln.gamma = gamma2;
    ln.dx = s.da; ln.dx2 = s.db; ln.drop2 = a.drop.at(H + 2); ln.mask2 = mask;
    ln.rows = rows; ln.n = h; ln.t = t;
    GTT_TRY(layer_norm_bwd(ln, stream));
  }
  GTT_TRY(column_sums(dout, h, h, s.xhat2, rows, dg2, dbe2, stream));

  // ---- FFN (ffn is masked: no input mask on its products) ----
  GTT_TRY(wgrad(text_wgrad(s, ffn, f, f, nullptr, taps, batch, t, s.db, h, h, dw2), stream));
  GTT_TRY(column_sums(s.db, h, h, nullptr, rows, dc2, nullptr, stream));
  GTT_TRY(conv_gemm(dffn_g, stream));
  GTT_TRY(wgrad(text_wgrad(s, s.x1m, h, h, nullptr, taps, batch, t, s.dffn, f, f, dw1), stream));
  GTT_TRY(column_sums(s.dffn, f, f, nullptr, rows, dc1, nullptr, stream));
  GTT_TRY(conv_gemm(dx1_g, stream));

  // ---- first norm: da = d(x * mask + y), dc = dy (dropped) ----
  {
    LayerNormBwd ln;
    ln.dy = s.db; ln.xhat = s.xhat1; ln.rstd = s.rstd1; ln.gamma = gamma1;
    ln.dx = s.da; ln.dx2 = s.dc; ln.drop2 = a.drop.at(H);
    ln.rows = rows; ln.n = h; ln.t = t;
    GTT_TRY(layer_norm_bwd(ln, stream));
  }
  GTT_TRY(column_sums(s.db, h, h, s.xhat1, rows, dg1, dbe1, stream));

  // ---- output projection ----
  GTT_TRY(column_sums(s.dc, h, h, nullptr, rows, dbo, nullptr, stream));
  GTT_TRY(wgrad(text_wgrad(s, s.att, h, h, nullptr, 1, batch, t, s.dc, h, h, dwo), stream));
  GTT_TRY(conv_gemm(datt_g, stream));

  // ---- attention core ----
  {
    AttnBwd ab;
    ab.qkv = s.qkv; ab.mask = mask; ab.rel_k = rel_k; ab.rel_v = rel_v;
    ab.att = s.att; ab.datt = s.datt; ab.stat_m = s.stat_m; ab.stat_linv = s.stat_linv;
    ab.dqkv = s.dqkv; ab.dqrel = s.dqrel; ab.pb = s.pb; ab.ds = s.ds; ab.pd = s.pd;
    ab.t = t; ab.n_heads = H; ab.d = d; ab.window = window;
    ab.scale = 1.f / sqrtf((float)d); ab.drop = a.drop;
    GTT_TRY(cudaFuncSetAttribute(attn_bwd_scores_tc_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kScoresSmem));
    // dqrel and pb (adjacent in the scratch) start at zero
    GTT_TRY(cudaMemsetAsync(s.dqrel, 0, (s.pb - s.dqrel) * 2 * sizeof(float), stream));
    const int chunks = (t + kKeyChunk - 1) / kKeyChunk;
    attn_bwd_scores_tc_kernel<<<dim3((t + kTcQ - 1) / kTcQ * chunks, H, batch), 64,
                                kScoresSmem, stream>>>(ab);
    GTT_TRY(cudaGetLastError());
    attn_bwd_products_kernel<<<dim3((d + kPN - 1) / kPN, (t + kPM - 1) / kPM, 3 * batch * H),
                               128, 0, stream>>>(ab);
    GTT_TRY(cudaGetLastError());
    // the tables are shared by the heads: one launch for both
    rel_grads_kernel<<<dim3((d + kRelCols - 1) / kRelCols, 2 * window + 1, 2),
                       dim3(kRelCols, kRelGroups), 0, stream>>>(ab, rows, drk, drv);
    GTT_TRY(cudaGetLastError());
  }

  // ---- the Q/K/V projection: one weight and one bias gradient ----
  GTT_TRY(wgrad(text_wgrad(s, x, h, h, mask, 1, batch, t, s.dqkv, 3 * h, 3 * h, dwqkv), stream));
  GTT_TRY(column_sums(s.dqkv, 3 * h, 3 * h, nullptr, rows, dbqkv, nullptr, stream));
  GTT_TRY(conv_gemm(dx_g, stream));
  return (int)cudaGetLastError();
}
