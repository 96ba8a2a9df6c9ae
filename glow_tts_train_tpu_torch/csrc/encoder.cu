// One text-encoder layer, the counterpart of
// glow_tts_train_tpu/ops/encoder_pallas.py::_fwd_kernel
// (math: _layer_fwd_math): masked input -> Q/K/V 1x1 -> per head
// softmax(q.k^T/sqrt(d) + banded rel-k, -1e4 fill) . v + banded rel-v ->
// out 1x1 -> residual LayerNorm -> conv FFN (k taps, ReLU) -> residual
// LayerNorm.
//
// The TPU kernel holds one sample's whole layer in VMEM. Here the layer is
// seven launches on one stream: three conv_gemm for Q, K and V into one
// [rows, 3h] buffer, the attention core below, conv_gemm for the output
// projection, layer_norm, two conv_gemm for the FFN, layer_norm.
//
// The attention core is bound by neither FLOPs nor bytes at serving shapes
// (t_x of tens to hundreds of phonemes, d = 96): it is latency-bound, with
// few blocks per launch. Each block owns 16 query rows of one (sample,
// head) and streams the keys through shared memory 32 at a time with an
// online softmax, so any t fits the same 45 KB of shared memory. The
// relative-position terms are the TPU kernel's banded form: 2w+1 diagonals
// of q.rel_k added to the scores, and the band of the probabilities times
// rel_v added to the output; the raw band scores are kept per row so the
// band probabilities come out of the final max and sum.
//
// Training dropout is the TPU kernel's per-site keep mask (sites in
// encoder.cuh).  In the streaming softmax the keep mask scales only the
// numerator (the weighted sum of v and the band term), never the running
// sum: the softmax is of the undropped scores.
#include <math.h>

#include "encoder.cuh"

namespace gtt {
namespace {

constexpr int kQT = 16;       // query rows per block
constexpr int kKT = 32;       // keys per shared-memory tile (one per lane)
constexpr int kMaxD = kAttnMaxD;
constexpr int kMaxBand = kAttnMaxBand;
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kQT / kWarps;
constexpr int kDPerLane = kMaxD / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// qkv: [batch * t, 3h] (q | k | v, head hd at columns hd*d of each third);
// out: [batch * t, h].
__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                     const float* __restrict__ rel_k, const float* __restrict__ rel_v,
                     float* __restrict__ out, float* __restrict__ stat_m,
                     float* __restrict__ stat_linv, int t, int n_heads, int d,
                     int window, float scale, const Dropout drop_all) {
  __shared__ float qs[kQT][kMaxD];
  __shared__ float ks[kKT][kMaxD + 1];  // +1: lane j reads row j, no bank conflict
  __shared__ float vs[kKT][kMaxD];
  __shared__ float qrel[kQT][kMaxBand];
  __shared__ float band[kQT][kMaxBand];
  __shared__ float kmask[kKT];

  const int b = blockIdx.z;
  const int hd = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const int h = n_heads * d;
  const int ld = 3 * h;
  const int nb = 2 * window + 1;
  const float* base = qkv + (long)b * t * ld;
  const float* mrow = mask + (long)b * t;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const Dropout drop = drop_all.at(hd);  // over this head's [t, t] probabilities

  for (int i = tid; i < kQT * d; i += kWarps * 32) {
    const int r = i / d, c = i % d;
    const int qi = q0 + r;
    qs[r][c] = qi < t ? base[(long)qi * ld + hd * d + c] : 0.f;
  }
  __syncthreads();

  // q . rel_k for the 2w+1 band offsets of this warp's rows
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    for (int o = 0; o < nb; ++o) {
      float p = 0.f;
      for (int c = lane; c < d; c += 32) p = fmaf(qs[r][c], rel_k[o * d + c], p);
      p = warp_sum(p);
      if (lane == 0) qrel[r][o] = p;
    }
  }

  // Online softmax state of this warp's 4 rows. The 4 rows advance
  // together so each key row read from shared memory feeds 4 independent
  // FMA chains (the loops run to runtime bounds, so ILP must come from
  // the rows).
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], qm[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPerLane];
  int qi[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.f;
    qi[rr] = q0 + warp * kRowsPerWarp + rr;
    // rows past t are computed as fully masked rows and never written
    qm[rr] = qi[rr] < t ? mrow[qi[rr]] : 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[rr][e] = 0.f;
  }
  const float* qrow = &qs[warp * kRowsPerWarp][0];

  for (int k0 = 0; k0 < t; k0 += kKT) {
    __syncthreads();  // previous tile fully consumed (and qrel written)
    for (int i = tid; i < kKT * d; i += kWarps * 32) {
      const int j = i / d, c = i % d;
      const int key = k0 + j;
      const bool ok = key < t;
      ks[j][c] = ok ? base[(long)key * ld + h + hd * d + c] : 0.f;
      vs[j][c] = ok ? base[(long)key * ld + 2 * h + hd * d + c] : 0.f;
    }
    if (tid < kKT) kmask[tid] = k0 + tid < t ? mrow[k0 + tid] : 0.f;
    __syncthreads();

    // lane = key: 4 dot products against this lane's key row
    const int key = k0 + lane;
    float dot[kRowsPerWarp] = {};
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float kc = ks[lane][c];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        dot[rr] = fmaf(qrow[rr * kMaxD + c], kc, dot[rr]);
    }
    float s[kRowsPerWarp], mt[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      s[rr] = -INFINITY;  // keys past t do not exist
      if (key < t) {
        s[rr] = dot[rr] * scale;
        const int o = key - qi[rr] + window;
        const bool in_band = o >= 0 && o < nb;
        if (in_band) s[rr] += qrel[warp * kRowsPerWarp + rr][o] * scale;
        if (qm[rr] == 0.f || kmask[lane] == 0.f) s[rr] = -1e4f;
        if (in_band) band[warp * kRowsPerWarp + rr][o] = s[rr];
      }
      mt[rr] = s[rr];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        mt[rr] = fmaxf(mt[rr], __shfl_xor_sync(0xffffffffu, mt[rr], o));
    float p[kRowsPerWarp], ps[kRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const float m_new = fmaxf(m_run[rr], mt[rr]);
      const float alpha = expf(m_run[rr] - m_new);
      p[rr] = expf(s[rr] - m_new);
      ps[rr] = p[rr];
      if (drop.on && key < t) p[rr] = site_drop(drop, b, qi[rr], t, key, p[rr]);
      m_run[rr] = m_new;
      l_run[rr] *= alpha;
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) acc[rr][e] *= alpha;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        ps[rr] += __shfl_xor_sync(0xffffffffu, ps[rr], o);
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) l_run[rr] += ps[rr];

    const int n_keys = min(kKT, t - k0);
    for (int j = 0; j < n_keys; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr)
        pj[rr] = __shfl_sync(0xffffffffu, p[rr], j);
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) {
        const int c = lane + 32 * e;
        if (c < d) {
          const float v = vs[j][c];
#pragma unroll
          for (int rr = 0; rr < kRowsPerWarp; ++rr)
            acc[rr][e] = fmaf(pj[rr], v, acc[rr][e]);
        }
      }
    }
  }
  __syncwarp();

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (qi[rr] >= t) continue;
    const float inv = 1.f / l_run[rr];
    if (stat_m && lane == 0) {
      const long at = ((long)b * n_heads + hd) * t + qi[rr];
      stat_m[at] = m_run[rr];
      stat_linv[at] = inv;
    }
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int c = lane + 32 * e;
      if (c >= d) continue;
      float v = acc[rr][e] * inv;
      for (int o = 0; o < nb; ++o) {
        const int key = qi[rr] + o - window;
        if (key < 0 || key >= t) continue;
        const float pb = expf(band[r][o] - m_run[rr]) * inv;
        v = fmaf(site_drop(drop, b, qi[rr], t, key, pb), rel_v[o * d + c], v);
      }
      out[((long)b * t + qi[rr]) * h + hd * d + c] = v;
    }
  }
}

}  // namespace

cudaError_t encoder_forward(const EncoderArgs& a, cudaStream_t stream) {
  const int h = a.h, batch = a.batch, t = a.t;
  const int H = a.n_heads;
  const int d = h / H;
  if (d > kMaxD || 2 * a.window + 1 > kMaxBand) return cudaErrorInvalidValue;
  const int rows = batch * t;
  cudaError_t err;

  const float* wqkv[3] = {a.wq, a.wk, a.wv};
  const float* bqkv[3] = {a.bq, a.bk, a.bv};
  for (int i = 0; i < 3; ++i) {
    ConvGemm g;
    g.a = a.x; g.lda = h; g.c_in = h; g.a_mask = a.mask;
    g.batch = batch; g.t = t;
    g.w = wqkv[i]; g.bias = bqkv[i]; g.n = h;
    g.epilogue = kBias; g.out = a.qkv + i * h; g.ldo = 3 * h;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return err;
  }

  const dim3 grid((t + kQT - 1) / kQT, H, batch);
  attention_kernel<<<grid, kWarps * 32, 0, stream>>>(
      a.qkv, a.mask, a.rel_k, a.rel_v, a.att, a.stat_m, a.stat_linv, t, H, d,
      a.window, 1.f / sqrtf((float)d), a.drop);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  {  // y = drop(att @ wo + bo), staged in `out`
    ConvGemm g;
    g.a = a.att; g.lda = h; g.c_in = h; g.batch = batch; g.t = t;
    g.w = a.wo; g.bias = a.bo; g.n = h; g.epilogue = kBias; g.out = a.out; g.ldo = h;
    g.drop = a.drop.at(H);
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return err;
  }
  {  // x1 = LN(x * mask + y)
    LayerNorm ln;
    ln.x = a.x; ln.x_mask = a.mask; ln.resid = a.out; ln.gamma = a.gamma1;
    ln.beta = a.beta1; ln.out = a.x1; ln.rows = rows; ln.n = h;
    ln.xhat = a.xhat1; ln.rstd = a.rstd1;
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
  }
  {  // ffn = drop(relu(conv(x1 * mask) + c1))
    ConvGemm g;
    g.a = a.x1; g.lda = h; g.c_in = h; g.a_mask = a.mask; g.taps = a.taps;
    g.batch = batch; g.t = t; g.w = a.w1; g.bias = a.c1; g.n = a.f;
    g.epilogue = kBiasRelu; g.out = a.ffn; g.ldo = a.f;
    g.drop = a.drop.at(H + 1);
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return err;
  }
  {  // y2 = drop((conv(ffn * mask) + c2) * mask), staged in `out`
    ConvGemm g;
    g.a = a.ffn; g.lda = a.f; g.c_in = a.f; g.a_mask = a.mask; g.taps = a.taps;
    g.batch = batch; g.t = t; g.w = a.w2; g.bias = a.c2; g.n = h;
    g.epilogue = kBiasMask; g.out = a.out; g.ldo = h; g.mask = a.mask;
    g.drop = a.drop.at(H + 2);
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return err;
  }
  {  // out = LN(x1 + y2)
    LayerNorm ln;
    ln.x = a.x1; ln.resid = a.out; ln.gamma = a.gamma2; ln.beta = a.beta2;
    ln.out = a.out; ln.rows = rows; ln.n = h;
    ln.xhat = a.xhat2; ln.rstd = a.rstd2;
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace gtt

extern "C" int gtt_encoder_layer(
    const float* x, const float* mask, const float* wq, const float* bq,
    const float* wk, const float* bk, const float* wv, const float* bv,
    const float* wo, const float* bo, const float* rel_k, const float* rel_v,
    const float* gamma1, const float* beta1, const float* gamma2,
    const float* beta2, const float* w1, const float* c1, const float* w2,
    const float* c2, float* out, float* qkv, float* att, float* x1,
    float* ffn, int batch, int t, int h, int n_heads, int window, int f,
    int taps, int drop, int seed, unsigned threshold, float scale,
    cudaStream_t stream) {
  gtt::EncoderArgs a;
  a.x = x; a.mask = mask; a.wq = wq; a.bq = bq; a.wk = wk; a.bk = bk;
  a.wv = wv; a.bv = bv; a.wo = wo; a.bo = bo; a.rel_k = rel_k; a.rel_v = rel_v;
  a.gamma1 = gamma1; a.beta1 = beta1; a.gamma2 = gamma2; a.beta2 = beta2;
  a.w1 = w1; a.c1 = c1; a.w2 = w2; a.c2 = c2;
  a.out = out; a.qkv = qkv; a.att = att; a.x1 = x1; a.ffn = ffn;
  a.batch = batch; a.t = t; a.h = h; a.n_heads = n_heads; a.window = window;
  a.f = f; a.taps = taps;
  a.drop = gtt::make_dropout(drop, seed, n_heads + 3, threshold, scale);
  const cudaError_t err = gtt::encoder_forward(a, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
