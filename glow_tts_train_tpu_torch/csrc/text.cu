// The text-side conv stacks, counterparts of
// glow_tts_train_tpu/ops/text_pallas.py::_prenet_fwd_kernel (math:
// _prenet_fwd_math) and ::_dp_fwd_kernel (math: _dp_fwd_math).
//
// Each TPU kernel keeps a sample's whole stack in VMEM; here each layer is a
// conv_gemm with its k-tap im2col gathered on load from the masked input,
// then a row-wise layer_norm, so only [rows, width] activations pass through
// device memory (L2 at serving sizes). Both stacks are small GEMMs
// (M = batch * t_x, N = 192 or 256, K = 5 * 192 or 3 * 256): launch- and
// latency-bound at serving batch sizes.
//
// Training dropout is the TPU kernels' per-site keep mask, applied in the
// LayerNorm's store: the prenet's site l (of L) drops layer l's ReLU output
// [t, h]; the duration stack's site l (of 2) drops layer l's LayerNorm
// output [t, f].
#include "text.cuh"

namespace gtt {

// ConvReluNorm prenet: n_layers x [conv(x * mask) -> LN -> ReLU -> drop],
// then out = (x + cur @ wp + bp) * mask.
cudaError_t prenet_forward(const PrenetArgs& a, cudaStream_t stream) {
  cudaError_t err;
  const long rows = (long)a.batch * a.t;
  const bool save = a.xhat != nullptr;
  const float* src = a.x;
  for (int l = 0; l < a.n_layers; ++l) {
    ConvGemm g;
    g.a = src; g.lda = a.h; g.c_in = a.h; g.a_mask = a.mask; g.taps = a.taps;
    g.batch = a.batch; g.t = a.t; g.w = a.w + (long)l * a.taps * a.h * a.h;
    g.bias = a.b + l * a.h; g.n = a.h; g.epilogue = kBias; g.out = a.pre; g.ldo = a.h;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return err;
    float* cur = save ? a.cur + l * rows * a.h : a.cur;
    LayerNorm ln;
    ln.x = a.pre; ln.gamma = a.gamma + l * a.h; ln.beta = a.beta + l * a.h; ln.out = cur;
    ln.rows = (int)rows; ln.n = a.h; ln.relu_after = 1;
    ln.t = a.t; ln.drop = a.drop.at(l);
    if (save) { ln.xhat = a.xhat + l * rows * a.h; ln.rstd = a.rstd + l * rows; }
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
    src = cur;
  }
  ConvGemm g;
  g.a = src; g.lda = a.h; g.c_in = a.h; g.batch = a.batch; g.t = a.t;
  g.w = a.wp; g.bias = a.bp; g.n = a.h; g.epilogue = kResidMask;
  g.out = a.out; g.ldo = a.h; g.mask = a.mask; g.aux = a.x; g.ld_aux = a.h;
  return conv_gemm(g, stream);
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

extern "C" int gtt_prenet(const float* x, const float* mask, const float* w,
                          const float* b, const float* gamma,
                          const float* beta, const float* wp, const float* bp,
                          float* out, float* pre, float* cur, int batch, int t,
                          int h, int n_layers, int taps, int drop, int seed,
                          unsigned threshold, float scale, cudaStream_t stream) {
  gtt::PrenetArgs a;
  a.x = x; a.mask = mask; a.w = w; a.b = b; a.gamma = gamma; a.beta = beta;
  a.wp = wp; a.bp = bp; a.out = out; a.pre = pre; a.cur = cur;
  a.batch = batch; a.t = t; a.h = h; a.n_layers = n_layers; a.taps = taps;
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
