// The backward of one text-encoder layer, the counterpart of
// glow_tts_train_tpu/ops/encoder_pallas.py::_bwd_kernel.
//
// Like the TPU kernel it saves nothing from the forward: it recomputes the
// layer from (weights, x, mask, seed) with the forward's own chain
// (encoder.cu), keeping q/k/v, the heads' outputs, both norms' normalised
// inputs and inverse stds, the FFN's dropped ReLU output and the softmax's
// row max and inverse row sum; replays every dropout keep mask from the
// seed; then walks back: second norm, FFN (two transposed conv products with
// the ReLU/keep and residual tails in their epilogues), first norm, output
// projection, attention core, Q/K/V projections.
//
// Attention core.  The probabilities are never written: as in a streaming
// attention backward they are rebuilt tile by tile from q, k and the saved
// row statistics.  With pd the dropped probabilities, the softmax backward's
// row term sum_j pd_ij * dpd_ij equals dout_i . out_i (the rel-v band term
// included), so it comes from the forward's output.  Two kernels share the
// per-pair math (pair_grad): attn_bwd_q owns 8 query rows per block and
// streams the keys (dq, and per row the band sums dqrel = ds on the 2w+1
// diagonals and pb = pd on them); attn_bwd_kv owns 8 keys and streams the
// queries (dk, dv).  ds is zero where the attend mask is zero, so a padded
// query row (uniform softmax over -1e4 scores) contributes to dv and the
// rel-v table only, as in the TPU kernel.  The rel-pos tables are shared by
// the heads: d rel_k[o] = sum_i dqrel_i[o] q_i and d rel_v[o] = sum_i
// pb_i[o] dout_i are wgrad products per head over all rows, added in head
// order: no atomics, the same bits from run to run.
//
// Bound on the card: f32 FMA throughput of the FFN's products (recompute,
// weight gradient and transposed conv, each 2 * rows * 576 * 768 * 2 FLOPs)
// when rows = batch * t fills the card; at t_x of a hundred or two the
// attention kernels' (sample, head, 8-row) blocks and the two dozen small
// launches make it latency-bound.
#include <math.h>

#include "encoder.cuh"

namespace gtt {
namespace {

constexpr int kOwn = 8;      // rows a block owns (queries in _q, keys in _kv)
constexpr int kTile = 32;    // streamed rows per shared-memory tile (one per lane)
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kOwn / kWarps;
constexpr int kDPerLane = kAttnMaxD / 32;

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
  // per row and head, [rows, heads * nb]: q . rel_k and datt . rel_v (written
  // by attn_bwd_q, read by attn_bwd_kv), and the band sums dqrel and pb
  float* qrel = nullptr;
  float* dorv = nullptr;
  float* dqrel = nullptr;
  float* pb = nullptr;
  float* dsum = nullptr;  // [rows, heads] datt_i . att_i
  int t = 0, n_heads = 0, d = 0, window = 0;
  float scale = 1.f;
  Dropout drop;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

__global__ void __launch_bounds__(kWarps * 32) attn_bwd_q_kernel(const AttnBwd a) {
  __shared__ float qs[kOwn][kAttnMaxD];
  __shared__ float dos[kOwn][kAttnMaxD];
  __shared__ float ks[kTile][kAttnMaxD + 1];  // +1: lane j reads row j
  __shared__ float vs[kTile][kAttnMaxD + 1];
  __shared__ float qrel[kOwn][kAttnMaxBand];
  __shared__ float dorv[kOwn][kAttnMaxBand];
  __shared__ float dqr[kOwn][kAttnMaxBand];
  __shared__ float pbs[kOwn][kAttnMaxBand];
  __shared__ float kmask[kTile];

  const int b = blockIdx.z;
  const int hd = blockIdx.y;
  const int q0 = blockIdx.x * kOwn;
  const int t = a.t, d = a.d;
  const int h = a.n_heads * d;
  const int ld = 3 * h;
  const int nb = 2 * a.window + 1;
  const int hb = a.n_heads * nb;
  const float* base = a.qkv + (long)b * t * ld;
  const float* mrow = a.mask + (long)b * t;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kOwn * d; i += kWarps * 32) {
    const int r = i / d, c = i % d;
    const int qi = q0 + r;
    const bool ok = qi < t;
    qs[r][c] = ok ? base[(long)qi * ld + hd * d + c] : 0.f;
    dos[r][c] = ok ? a.datt[((long)b * t + qi) * h + hd * d + c] : 0.f;
  }
  __syncthreads();

  int qi[kRowsPerWarp];
  float qm[kRowsPerWarp], m[kRowsPerWarp], linv[kRowsPerWarp], dsum[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    qi[rr] = q0 + r;
    const bool ok = qi[rr] < t;
    for (int o = 0; o < nb; ++o) {
      float pk = 0.f, pv = 0.f;
      for (int c = lane; c < d; c += 32) {
        pk = fmaf(qs[r][c], a.rel_k[o * d + c], pk);
        pv = fmaf(dos[r][c], a.rel_v[o * d + c], pv);
      }
      pk = warp_sum(pk);
      pv = warp_sum(pv);
      if (lane == 0) {
        qrel[r][o] = pk;
        dorv[r][o] = pv;
        dqr[r][o] = 0.f;
        pbs[r][o] = 0.f;
      }
    }
    float ds_row = 0.f;
    if (ok)
      for (int c = lane; c < d; c += 32)
        ds_row = fmaf(dos[r][c], a.att[((long)b * t + qi[rr]) * h + hd * d + c], ds_row);
    dsum[rr] = warp_sum(ds_row);
    const long at = ((long)b * a.n_heads + hd) * t + qi[rr];
    qm[rr] = ok ? mrow[qi[rr]] : 0.f;
    m[rr] = ok ? a.stat_m[at] : 0.f;
    linv[rr] = ok ? a.stat_linv[at] : 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[rr][e] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += kTile) {
    __syncthreads();  // previous tile consumed (and the band rows written)
    for (int i = tid; i < kTile * d; i += kWarps * 32) {
      const int j = i / d, c = i % d;
      const int key = k0 + j;
      const bool ok = key < t;
      ks[j][c] = ok ? base[(long)key * ld + h + hd * d + c] : 0.f;
      vs[j][c] = ok ? base[(long)key * ld + 2 * h + hd * d + c] : 0.f;
    }
    if (tid < kTile) kmask[tid] = k0 + tid < t ? mrow[k0 + tid] : 0.f;
    __syncthreads();

    const int key = k0 + lane;
    float dot_qk[kRowsPerWarp] = {}, dot_dv[kRowsPerWarp] = {};
    for (int c = 0; c < d; ++c) {
      const float kc = ks[lane][c];
      const float vc = vs[lane][c];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        dot_qk[rr] = fmaf(qs[r][c], kc, dot_qk[rr]);
        dot_dv[rr] = fmaf(dos[r][c], vc, dot_dv[rr]);
      }
    }
    float ds[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      ds[rr] = 0.f;
      if (key < t && qi[rr] < t) {
        const int o = key - qi[rr] + a.window;
        const bool in_band = o >= 0 && o < nb;
        const bool attend = qm[rr] != 0.f && kmask[lane] != 0.f;
        float pd;
        pair_grad(a, b, hd, qi[rr], key, dot_qk[rr], dot_dv[rr], in_band,
                  in_band ? qrel[r][o] : 0.f, in_band ? dorv[r][o] : 0.f, m[rr],
                  linv[rr], dsum[rr], attend, pd, ds[rr]);
        if (in_band) {  // one lane per (row, offset) over the whole walk
          dqr[r][o] = ds[rr] * a.scale;
          pbs[r][o] = pd;
        }
      }
    }
    const int n_keys = min(kTile, t - k0);
    for (int j = 0; j < n_keys; ++j) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float dsj = __shfl_sync(0xffffffffu, ds[rr], j);
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) {
          const int c = lane + 32 * e;
          if (c < d) acc[rr][e] = fmaf(dsj, ks[j][c], acc[rr][e]);
        }
      }
    }
  }
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (qi[rr] >= t) continue;
    const long row = (long)b * t + qi[rr];
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c >= d) continue;
      float v = acc[rr][e] * a.scale;
      for (int o = 0; o < nb; ++o) v = fmaf(dqr[r][o], a.rel_k[o * d + c], v);
      a.dqkv[row * ld + hd * d + c] = v;
    }
    for (int o = lane; o < nb; o += 32) {
      const long at = row * hb + hd * nb + o;
      a.qrel[at] = qrel[r][o];
      a.dorv[at] = dorv[r][o];
      a.dqrel[at] = dqr[r][o];
      a.pb[at] = pbs[r][o];
    }
    if (lane == 0) a.dsum[row * a.n_heads + hd] = dsum[rr];
  }
}

__global__ void __launch_bounds__(kWarps * 32) attn_bwd_kv_kernel(const AttnBwd a) {
  __shared__ float ks[kOwn][kAttnMaxD];
  __shared__ float vs[kOwn][kAttnMaxD];
  __shared__ float qs[kTile][kAttnMaxD + 1];  // +1: lane i reads row i
  __shared__ float dos[kTile][kAttnMaxD + 1];

  const int b = blockIdx.z;
  const int hd = blockIdx.y;
  const int j0 = blockIdx.x * kOwn;
  const int t = a.t, d = a.d;
  const int h = a.n_heads * d;
  const int ld = 3 * h;
  const int nb = 2 * a.window + 1;
  const int hb = a.n_heads * nb;
  const float* base = a.qkv + (long)b * t * ld;
  const float* mrow = a.mask + (long)b * t;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int i = tid; i < kOwn * d; i += kWarps * 32) {
    const int r = i / d, c = i % d;
    const int key = j0 + r;
    const bool ok = key < t;
    ks[r][c] = ok ? base[(long)key * ld + h + hd * d + c] : 0.f;
    vs[r][c] = ok ? base[(long)key * ld + 2 * h + hd * d + c] : 0.f;
  }

  int key[kRowsPerWarp];
  float km[kRowsPerWarp];
  float acc_k[kRowsPerWarp][kDPerLane], acc_v[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    key[rr] = j0 + warp * kRowsPerWarp + rr;
    km[rr] = key[rr] < t ? mrow[key[rr]] : 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc_k[rr][e] = acc_v[rr][e] = 0.f;
  }

  for (int i0 = 0; i0 < t; i0 += kTile) {
    __syncthreads();  // previous tile consumed (and ks, vs written)
    for (int i = tid; i < kTile * d; i += kWarps * 32) {
      const int r = i / d, c = i % d;
      const int qi = i0 + r;
      const bool ok = qi < t;
      qs[r][c] = ok ? base[(long)qi * ld + hd * d + c] : 0.f;
      dos[r][c] = ok ? a.datt[((long)b * t + qi) * h + hd * d + c] : 0.f;
    }
    __syncthreads();

    // lane = query
    const int qi = i0 + lane;
    const bool q_ok = qi < t;
    const long row = (long)b * t + qi;
    const long at = ((long)b * a.n_heads + hd) * t + qi;
    const float qm = q_ok ? mrow[qi] : 0.f;
    const float m = q_ok ? a.stat_m[at] : 0.f;
    const float linv = q_ok ? a.stat_linv[at] : 0.f;
    const float dsum = q_ok ? a.dsum[row * a.n_heads + hd] : 0.f;
    float ds[kRowsPerWarp], pd[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float dot_qk = 0.f, dot_dv = 0.f;
      for (int c = 0; c < d; ++c) {
        dot_qk = fmaf(qs[lane][c], ks[r][c], dot_qk);
        dot_dv = fmaf(dos[lane][c], vs[r][c], dot_dv);
      }
      ds[rr] = 0.f;
      pd[rr] = 0.f;
      if (q_ok && key[rr] < t) {
        const int o = key[rr] - qi + a.window;
        const bool in_band = o >= 0 && o < nb;
        const long band_at = row * hb + hd * nb + o;
        pair_grad(a, b, hd, qi, key[rr], dot_qk, dot_dv, in_band,
                  in_band ? a.qrel[band_at] : 0.f, in_band ? a.dorv[band_at] : 0.f,
                  m, linv, dsum, qm != 0.f && km[rr] != 0.f, pd[rr], ds[rr]);
      }
    }
    const int n_q = min(kTile, t - i0);
    for (int i = 0; i < n_q; ++i) {
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const float dsi = __shfl_sync(0xffffffffu, ds[rr], i);
        const float pdi = __shfl_sync(0xffffffffu, pd[rr], i);
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) {
          const int c = lane + 32 * e;
          if (c < d) {
            acc_k[rr][e] = fmaf(dsi, qs[i][c], acc_k[rr][e]);
            acc_v[rr][e] = fmaf(pdi, dos[i][c], acc_v[rr][e]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (key[rr] >= t) continue;
    const long row = (long)b * t + key[rr];
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c >= d) continue;
      a.dqkv[row * ld + h + hd * d + c] = acc_k[rr][e] * a.scale;
      a.dqkv[row * ld + 2 * h + hd * d + c] = acc_v[rr][e];
    }
  }
}

#define GTT_TRY(expr)                               \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

WGrad rows_wgrad(const float* a, int lda, int c_in, const float* a_mask, int taps,
                 int batch, int t, const float* dy, int ldy, int n, float* out,
                 float* scratch, long scratch_floats) {
  WGrad w;
  w.a = a; w.lda = lda; w.c_in = c_in; w.a_mask = a_mask; w.taps = taps;
  w.batch = batch; w.t = t; w.dy = dy; w.ldy = ldy; w.n = n; w.out = out;
  w.scratch = scratch; w.scratch_floats = scratch_floats;
  return w;
}

}  // namespace
}  // namespace gtt

// Transposed weights from the wrapper: wqkv_t [3h, h] = [wq^T; wk^T; wv^T],
// wo_t [h, h], w1_t [taps * f, h] and w2_t [taps * h, f] per tap the
// transposed block.  Scratch: the forward chain's buffers and saves
// (encoder.cuh); da, db, dc, datt [rows, h]; dffn [rows, f]; dqkv [rows, 3h];
// qrel, dorv, dqrel, pb [rows, heads * nb]; dsum [rows, heads]; rel_part
// [heads, nb, d]; col_part [batch, max(f, h)]; wg_scratch for wgrad.
extern "C" int gtt_encoder_layer_bwd(
    const float* x, const float* mask, const float* wq, const float* bq,
    const float* wk, const float* bk, const float* wv, const float* bv,
    const float* wo, const float* bo, const float* rel_k, const float* rel_v,
    const float* gamma1, const float* beta1, const float* gamma2,
    const float* beta2, const float* w1, const float* c1, const float* w2,
    const float* c2, const float* wqkv_t, const float* wo_t, const float* w1_t,
    const float* w2_t, const float* dout, float* dx, float* dwq, float* dbq,
    float* dwk, float* dbk, float* dwv, float* dbv, float* dwo, float* dbo,
    float* drk, float* drv, float* dg1, float* dbe1, float* dg2, float* dbe2,
    float* dw1, float* dc1, float* dw2, float* dc2, float* out, float* qkv,
    float* att, float* x1, float* ffn, float* xhat1, float* rstd1, float* xhat2,
    float* rstd2, float* stat_m, float* stat_linv, float* da, float* db,
    float* dc, float* datt, float* dffn, float* dqkv, float* qrel, float* dorv,
    float* dqrel, float* pb, float* dsum, float* rel_part, float* col_part,
    float* wg_scratch, int wg_scratch_floats, int batch, int t, int h,
    int n_heads, int window, int f, int taps, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  using namespace gtt;
  const int H = n_heads;
  const int d = h / H;
  const int nb = 2 * window + 1;
  const int rows = batch * t;
  const long wgf = wg_scratch_floats;

  EncoderArgs a;
  a.x = x; a.mask = mask; a.wq = wq; a.bq = bq; a.wk = wk; a.bk = bk;
  a.wv = wv; a.bv = bv; a.wo = wo; a.bo = bo; a.rel_k = rel_k; a.rel_v = rel_v;
  a.gamma1 = gamma1; a.beta1 = beta1; a.gamma2 = gamma2; a.beta2 = beta2;
  a.w1 = w1; a.c1 = c1; a.w2 = w2; a.c2 = c2;
  a.out = out; a.qkv = qkv; a.att = att; a.x1 = x1; a.ffn = ffn;
  a.xhat1 = xhat1; a.rstd1 = rstd1; a.xhat2 = xhat2; a.rstd2 = rstd2;
  a.stat_m = stat_m; a.stat_linv = stat_linv;
  a.batch = batch; a.t = t; a.h = h; a.n_heads = H; a.window = window;
  a.f = f; a.taps = taps;
  a.drop = make_dropout(drop, seed, H + 3, threshold, scale);
  GTT_TRY(encoder_forward(a, stream));

  // ---- second norm: da = d(x1 + y2), db = its dropped, masked FFN branch ----
  {
    LayerNormBwd ln;
    ln.dy = dout; ln.xhat = xhat2; ln.rstd = rstd2; ln.gamma = gamma2;
    ln.dx = da; ln.dx2 = db; ln.drop2 = a.drop.at(H + 2); ln.mask2 = mask;
    ln.rows = rows; ln.n = h; ln.t = t;
    GTT_TRY(layer_norm_bwd(ln, stream));
  }
  GTT_TRY(ln_param_grads(dout, xhat2, h, batch, t, col_part, dg2, dbe2, stream));

  // ---- FFN ----
  GTT_TRY(wgrad(rows_wgrad(ffn, f, f, mask, taps, batch, t, db, h, h, dw2,
                           wg_scratch, wgf), stream));
  GTT_TRY(bias_grad(db, h, h, nullptr, batch, t, col_part, dc2, stream));
  {  // dffn = d(pre-ReLU) = (transposed conv of db) * mask * keep * [pre > 0]
    ConvGemm g;
    g.a = db; g.lda = h; g.c_in = h; g.taps = taps; g.tap_sign = -1;
    g.batch = batch; g.t = t; g.w = w2_t; g.n = f; g.epilogue = kMaskReluBwd;
    g.out = dffn; g.ldo = f; g.mask = mask; g.aux = ffn; g.ld_aux = f;
    g.drop = a.drop.at(H + 1);
    GTT_TRY(conv_gemm(g, stream));
  }
  GTT_TRY(wgrad(rows_wgrad(x1, h, h, mask, taps, batch, t, dffn, f, f, dw1,
                           wg_scratch, wgf), stream));
  GTT_TRY(bias_grad(dffn, f, f, nullptr, batch, t, col_part, dc1, stream));
  {  // db = d(x1) = da + (transposed conv of dffn) * mask
    ConvGemm g;
    g.a = dffn; g.lda = f; g.c_in = f; g.taps = taps; g.tap_sign = -1;
    g.batch = batch; g.t = t; g.w = w1_t; g.n = h; g.epilogue = kMaskAdd;
    g.out = db; g.ldo = h; g.mask = mask; g.aux = da; g.ld_aux = h;
    GTT_TRY(conv_gemm(g, stream));
  }

  // ---- first norm: da = d(x * mask + y), dc = dy (dropped) ----
  {
    LayerNormBwd ln;
    ln.dy = db; ln.xhat = xhat1; ln.rstd = rstd1; ln.gamma = gamma1;
    ln.dx = da; ln.dx2 = dc; ln.drop2 = a.drop.at(H);
    ln.rows = rows; ln.n = h; ln.t = t;
    GTT_TRY(layer_norm_bwd(ln, stream));
  }
  GTT_TRY(ln_param_grads(db, xhat1, h, batch, t, col_part, dg1, dbe1, stream));

  // ---- output projection ----
  GTT_TRY(bias_grad(dc, h, h, nullptr, batch, t, col_part, dbo, stream));
  GTT_TRY(wgrad(rows_wgrad(att, h, h, nullptr, 1, batch, t, dc, h, h, dwo,
                           wg_scratch, wgf), stream));
  {
    ConvGemm g;
    g.a = dc; g.lda = h; g.c_in = h; g.batch = batch; g.t = t;
    g.w = wo_t; g.n = h; g.epilogue = kBias; g.out = datt; g.ldo = h;
    GTT_TRY(conv_gemm(g, stream));
  }

  // ---- attention core ----
  {
    AttnBwd ab;
    ab.qkv = qkv; ab.mask = mask; ab.rel_k = rel_k; ab.rel_v = rel_v;
    ab.att = att; ab.datt = datt; ab.stat_m = stat_m; ab.stat_linv = stat_linv;
    ab.dqkv = dqkv; ab.qrel = qrel; ab.dorv = dorv; ab.dqrel = dqrel; ab.pb = pb;
    ab.dsum = dsum; ab.t = t; ab.n_heads = H; ab.d = d; ab.window = window;
    ab.scale = 1.f / sqrtf((float)d); ab.drop = a.drop;
    const dim3 grid((t + kOwn - 1) / kOwn, H, batch);
    attn_bwd_q_kernel<<<grid, kWarps * 32, 0, stream>>>(ab);
    GTT_TRY(cudaGetLastError());
    attn_bwd_kv_kernel<<<grid, kWarps * 32, 0, stream>>>(ab);
    GTT_TRY(cudaGetLastError());
  }
  // the tables are shared by the heads: one product per head, added in order
  for (int hd = 0; hd < H; ++hd)
    GTT_TRY(wgrad(rows_wgrad(dqrel + hd * nb, H * nb, nb, nullptr, 1, batch, t,
                             qkv + hd * d, 3 * h, d, rel_part + (long)hd * nb * d,
                             wg_scratch, wgf), stream));
  GTT_TRY(col_sum(rel_part, nb * d, nb * d, nullptr, 1, H, drk, nb * d, stream));
  for (int hd = 0; hd < H; ++hd)
    GTT_TRY(wgrad(rows_wgrad(pb + hd * nb, H * nb, nb, nullptr, 1, batch, t,
                             datt + hd * d, h, d, rel_part + (long)hd * nb * d,
                             wg_scratch, wgf), stream));
  GTT_TRY(col_sum(rel_part, nb * d, nb * d, nullptr, 1, H, drv, nb * d, stream));

  // ---- Q/K/V projections ----
  float* dws[3] = {dwq, dwk, dwv};
  float* dbs[3] = {dbq, dbk, dbv};
  for (int i = 0; i < 3; ++i) {
    GTT_TRY(wgrad(rows_wgrad(x, h, h, mask, 1, batch, t, dqkv + i * h, 3 * h, h,
                             dws[i], wg_scratch, wgf), stream));
    GTT_TRY(bias_grad(dqkv + i * h, 3 * h, h, nullptr, batch, t, col_part, dbs[i], stream));
  }
  {  // dx = (da + dq wq^T + dk wk^T + dv wv^T) * mask
    ConvGemm g;
    g.a = dqkv; g.lda = 3 * h; g.c_in = 3 * h; g.batch = batch; g.t = t;
    g.w = wqkv_t; g.n = h; g.epilogue = kResidMask; g.out = dx; g.ldo = h;
    g.mask = mask; g.aux = da; g.ld_aux = h;
    GTT_TRY(conv_gemm(g, stream));
  }
  return (int)cudaGetLastError();
}
