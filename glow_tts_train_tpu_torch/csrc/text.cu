// The text-side conv stacks, counterparts of
// glow_tts_train_tpu/ops/text_pallas.py::_prenet_fwd_kernel (math:
// _prenet_fwd_math) and ::_dp_fwd_kernel (math: _dp_fwd_math).
//
// Each TPU kernel keeps a sample's whole stack in VMEM; here each layer is a
// conv_gemm with its k-tap im2col gathered on load, then a row-wise
// layer_norm, so only [rows, width] activations pass through device memory
// (L2 at serving sizes).
//
// The prenet's products (M = batch * t, K = 5 * 192, N = 192 at base width)
// ask for the tensor cores (3xTF32, tc_gemm.cu) with split-K, as the
// encoder layer's do (text_product): at t_x <= 192 they are short and deep,
// so the K walk is cut into shares where that makes fewer waves.  The
// tensor-core conv-GEMM takes no input mask on a tap gather, so every conv
// input is stored masked: x * mask once (mask_rows), then each layer's
// LayerNorm writes its output times the mask.  A gather of a masked input
// is the same sum as the gather with the mask, so each product is the one
// it was, up to the tensor cores' rounding.  The chain's weights are split
// in one launch (presplit_weights).  A lone short sentence (b=1) has too
// few row tiles: its products are declined to the CUDA cores, as before.
// The duration stack's products (K = 3 * 256) stay on the CUDA cores.
//
// Training dropout is the TPU kernels' per-site keep mask, applied in the
// LayerNorm's store: the prenet's site l (of L) drops layer l's ReLU output
// [t, h]; the duration stack's site l (of 2) drops layer l's LayerNorm
// output [t, f].
#include <algorithm>

#include "text.cuh"

namespace gtt {

namespace {

// out = x * mask over [rows, n] (the first conv's input)
__global__ void mask_rows_kernel(const float* x, const float* mask, float* out, long rows,
                                 int n) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows * n) out[i] = x[i] * mask[i / n];
}

// 16-byte multiples, so every carved buffer stays aligned for the tensor cores
long round4(long floats) { return (floats + 3) / 4 * 4; }

}  // namespace

ConvGemm prenet_product(const PrenetScratch& s) {
  ConvGemm g;
  g.tc_scratch = s.tc;
  g.tc_scratch_floats = s.tc_floats;
  g.part = s.part;
  return g;
}

long prenet_scratch(float* base, const PrenetDims& d, bool backward, PrenetScratch* s) {
  long used = 0;
  auto take = [&](float*& p, long floats) {
    p = base ? base + used : nullptr;
    used += round4(floats);
  };
  const long rows = d.rows(), h = d.h, L = d.n_layers;
  take(s->xm, rows * h);
  take(s->pre, rows * h);
  take(s->curm, (backward ? std::max(L, 1L) : 1) * rows * h);
  // the K-major splits of the L convs' and the projection's weights, for
  // the forward's products and the backward's transposed ones (16 floats of
  // alignment each), and the split-K partial sums
  s->tc_floats = 2 * (2 * (L * d.taps * h * h + h * h) + (L + 1) * 16);
  take(s->tc, s->tc_floats);
  take(s->part, kSplitKCols * rows);
  if (backward) {
    take(s->xhat, std::max(L, 1L) * rows * h);
    take(s->rstd, std::max(L, 1L) * rows);
    take(s->dcur, rows * h);
    take(s->dpre, rows * h);
    take(s->col_part, (long)d.batch * h);
    s->wg_floats = std::max(1L << 22, d.taps * h * h);
    take(s->wg, s->wg_floats);
  }
  return used;
}

// ConvReluNorm prenet: n_layers x [conv(x * mask) -> LN -> ReLU -> drop],
// then out = (x + cur @ wp + bp) * mask.
cudaError_t prenet_forward(const PrenetArgs& a, cudaStream_t stream) {
  const PrenetDims& d = a.dims;
  const PrenetScratch& s = a.s;
  const long rows = d.rows();
  const int h = d.h, L = d.n_layers;
  if (L > kMaxPrenetLayers) return cudaErrorInvalidValue;
  // layer l's masked output: the next conv's input
  auto curm = [&](int l) { return a.save ? s.curm + l * rows * h : s.curm; };
  ConvGemm g[kMaxPrenetLayers + 1];
  ConvGemm* products[kMaxPrenetLayers + 1];
  for (int l = 0; l <= L; ++l) {
    g[l] = prenet_product(s);
    g[l].lda = h; g[l].c_in = h; g[l].batch = d.batch; g[l].t = d.t; g[l].n = h;
    g[l].ldo = h;
    products[l] = &g[l];
  }
  for (int l = 0; l < L; ++l) {  // pre = conv(x * mask) + b
    g[l].a = l ? curm(l - 1) : s.xm; g[l].taps = d.taps;
    g[l].w = a.w + (long)l * d.taps * h * h; g[l].bias = a.b + l * h;
    g[l].epilogue = kBias; g[l].out = s.pre;
  }
  ConvGemm& proj = g[L];  // out = (x + cur @ wp + bp) * mask (cur masked: same rows)
  proj.a = L ? curm(L - 1) : a.x; proj.w = a.wp; proj.bias = a.bp;
  proj.epilogue = kResidMask; proj.out = a.out; proj.mask = a.mask; proj.aux = a.x;
  proj.ld_aux = h;
  cudaError_t err = presplit_weights(products, L + 1, s.tc, s.tc_floats / 2, stream);
  if (err != cudaSuccess) return err;

  if (L > 0) {
    const long n = rows * h;
    mask_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a.x, a.mask, s.xm, rows, h);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  for (int l = 0; l < L; ++l) {
    if ((err = conv_gemm(g[l], stream)) != cudaSuccess) return err;
    LayerNorm ln;
    ln.x = s.pre; ln.gamma = a.gamma + l * h; ln.beta = a.beta + l * h;
    ln.out = a.save ? a.cur + l * rows * h : nullptr;
    ln.out_masked = curm(l); ln.out_mask = a.mask;
    ln.rows = (int)rows; ln.n = h; ln.relu_after = 1;
    ln.t = d.t; ln.drop = a.drop.at(l);
    if (a.save) { ln.xhat = s.xhat + l * rows * h; ln.rstd = s.rstd + l * rows; }
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
  }
  return conv_gemm(proj, stream);
}

// Duration-predictor stack without its 1-channel projection:
// 2 x [conv(x * mask) -> ReLU -> LN -> drop].
cudaError_t duration_forward(const DurationArgs& a, cudaStream_t stream) {
  cudaError_t err;
  const long rows = (long)a.batch * a.t;
  const bool save = a.xhat != nullptr;
  const float* src = a.x;
  int width = a.c_in;
  for (int l = 0; l < 2; ++l) {
    float* relu = save ? a.relu + l * rows * a.f : a.relu;
    ConvGemm g;
    g.a = src; g.lda = width; g.c_in = width; g.a_mask = a.mask; g.taps = a.taps;
    g.batch = a.batch; g.t = a.t; g.w = a.w[l]; g.bias = a.b[l]; g.n = a.f;
    g.epilogue = kBiasRelu; g.out = relu; g.ldo = a.f;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return err;
    // without saves layer 0 writes `out`, which layer 1's conv reads before
    // layer 1's norm overwrites it
    float* dst = (save && l == 0) ? a.mid : a.out;
    LayerNorm ln;
    ln.x = relu; ln.gamma = a.gamma[l]; ln.beta = a.beta[l]; ln.out = dst;
    ln.rows = (int)rows; ln.n = a.f; ln.t = a.t; ln.drop = a.drop.at(l);
    if (save) { ln.xhat = a.xhat + l * rows * a.f; ln.rstd = a.rstd + l * rows; }
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
    src = dst;
    width = a.f;
  }
  return cudaSuccess;
}

}  // namespace gtt

namespace {

gtt::PrenetDims prenet_dims(int batch, int t, int h, int n_layers, int taps) {
  gtt::PrenetDims d;
  d.batch = batch; d.t = t; d.h = h; d.n_layers = n_layers; d.taps = taps;
  return d;
}

}  // namespace

// Floats of one call's scratch block (backward 0: gtt_prenet, 1:
// gtt_prenet_bwd).
extern "C" long long gtt_prenet_scratch_floats(int batch, int t, int h, int n_layers, int taps,
                                               int backward) {
  gtt::PrenetScratch s;
  return gtt::prenet_scratch(nullptr, prenet_dims(batch, t, h, n_layers, taps), backward != 0,
                             &s);
}

// Scratch: one block of gtt_prenet_scratch_floats(..., 0) floats.
extern "C" int gtt_prenet(const float* x, const float* mask, const float* w,
                          const float* b, const float* gamma,
                          const float* beta, const float* wp, const float* bp,
                          float* out, float* scratch, long long scratch_floats, int batch,
                          int t, int h, int n_layers, int taps, int drop, int seed,
                          unsigned threshold, float scale, cudaStream_t stream) {
  gtt::PrenetArgs a;
  a.x = x; a.mask = mask; a.w = w; a.b = b; a.gamma = gamma; a.beta = beta;
  a.wp = wp; a.bp = bp; a.out = out;
  a.dims = prenet_dims(batch, t, h, n_layers, taps);
  if (gtt::prenet_scratch(scratch, a.dims, false, &a.s) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = gtt::make_dropout(drop, seed, n_layers, threshold, scale);
  const cudaError_t err = gtt::prenet_forward(a, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int gtt_duration_stack(const float* x, const float* mask,
                                  const float* w1, const float* b1,
                                  const float* gamma1, const float* beta1,
                                  const float* w2, const float* b2,
                                  const float* gamma2, const float* beta2,
                                  float* out, float* pre, int batch, int t,
                                  int c_in, int f, int taps, int drop, int seed,
                                  unsigned threshold, float scale,
                                  cudaStream_t stream) {
  gtt::DurationArgs a;
  a.x = x; a.mask = mask;
  a.w[0] = w1; a.b[0] = b1; a.gamma[0] = gamma1; a.beta[0] = beta1;
  a.w[1] = w2; a.b[1] = b2; a.gamma[1] = gamma2; a.beta[1] = beta2;
  a.out = out; a.relu = pre;
  a.batch = batch; a.t = t; a.c_in = c_in; a.f = f; a.taps = taps;
  a.drop = gtt::make_dropout(drop, seed, 2, threshold, scale);
  const cudaError_t err = gtt::duration_forward(a, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
