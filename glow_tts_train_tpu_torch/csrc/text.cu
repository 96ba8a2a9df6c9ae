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
#include "common.cuh"

// ConvReluNorm prenet: n_layers x [conv(x * mask) -> LN -> ReLU], then
// out = (x + cur @ wp + bp) * mask.
extern "C" int gtt_prenet(const float* x, const float* mask, const float* w,
                          const float* b, const float* gamma,
                          const float* beta, const float* wp, const float* bp,
                          float* out, float* pre, float* cur, int batch, int t,
                          int h, int n_layers, int taps, cudaStream_t stream) {
  using namespace gtt;
  cudaError_t err;
  const float* src = x;
  for (int l = 0; l < n_layers; ++l) {
    ConvGemm g;
    g.a = src; g.lda = h; g.c_in = h; g.a_mask = mask; g.taps = taps;
    g.batch = batch; g.t = t; g.w = w + (long)l * taps * h * h; g.bias = b + l * h;
    g.n = h; g.epilogue = kBias; g.out = pre; g.ldo = h;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
    LayerNorm ln;
    ln.x = pre; ln.gamma = gamma + l * h; ln.beta = beta + l * h; ln.out = cur;
    ln.rows = batch * t; ln.n = h; ln.relu_after = 1;
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return (int)err;
    src = cur;
  }
  ConvGemm g;
  g.a = src; g.lda = h; g.c_in = h; g.batch = batch; g.t = t;
  g.w = wp; g.bias = bp; g.n = h; g.epilogue = kResidMask;
  g.out = out; g.ldo = h; g.mask = mask; g.aux = x; g.ld_aux = h;
  if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Duration-predictor stack without its 1-channel projection:
// 2 x [conv(x * mask) -> ReLU -> LN].
extern "C" int gtt_duration_stack(const float* x, const float* mask,
                                  const float* w1, const float* b1,
                                  const float* gamma1, const float* beta1,
                                  const float* w2, const float* b2,
                                  const float* gamma2, const float* beta2,
                                  float* out, float* pre, int batch, int t,
                                  int c_in, int f, int taps,
                                  cudaStream_t stream) {
  using namespace gtt;
  cudaError_t err;
  const float* ws[2] = {w1, w2};
  const float* bs[2] = {b1, b2};
  const float* gs[2] = {gamma1, gamma2};
  const float* bes[2] = {beta1, beta2};
  const float* src = x;
  int width = c_in;
  for (int l = 0; l < 2; ++l) {
    ConvGemm g;
    g.a = src; g.lda = width; g.c_in = width; g.a_mask = mask; g.taps = taps;
    g.batch = batch; g.t = t; g.w = ws[l]; g.bias = bs[l]; g.n = f;
    g.epilogue = kBiasRelu; g.out = pre; g.ldo = f;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
    LayerNorm ln;
    ln.x = pre; ln.gamma = gs[l]; ln.beta = bes[l]; ln.out = out;
    ln.rows = batch * t; ln.n = f;
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return (int)err;
    src = out;
    width = f;
  }
  return (int)cudaGetLastError();
}
