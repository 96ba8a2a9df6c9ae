// Inverse of one flow block, the counterpart of
// glow_tts_train_tpu/ops/block_pallas.py::_block_inv_kernel (WN layer math:
// wn_pallas.py::_layer_fwd):
//
//   h0      = (x0 @ W_s + b_s) * mask
//   skip    = WN stack of h0 (dilated K-tap conv, + g, tanh * sigmoid,
//             1x1 res/skip)
//   m, logs = (skip * mask) @ W_e + b_e        (+ optional sigmoid_scale)
//   z1      = (x1 - m) * exp(-logs) * mask
//   y       = (concat(x0, z1) @ A_inv + bA_inv) * mask
//
// The TPU kernel keeps a sample's block, weights included (W_in alone is
// 4 x 960 x 384 f32 = 5.9 MB at base width), in VMEM. Here the block is
// 3 + 2L conv_gemm launches: the WN gate and the res/skip split are fused
// into their GEMMs' epilogues, the coupling inverse into the end conv's, so
// the only activations that touch device memory are the [rows, h] WN state,
// gate output and skip sum, and the [rows, c] block buffers. Every GEMM is
// f32 on the CUDA cores; the in-layer conv (K = 5 * 192, N = 384) is 80%
// of the FLOPs and bounds the block.
#include <cuda_runtime.h>

#include "common.cuh"

extern "C" int gtt_block_inverse(
    const float* x, const float* mask, const float* a_inv,
    const float* ba_inv, const float* w_s, const float* b_s, const float* w_e,
    const float* b_e, const float* w_in, const float* b_in, const float* w_rs,
    const float* b_rs, const float* g_all, float* y, float* zbuf,
    float* xcur, float* acts, float* skip, float* tc_scratch,
    int tc_scratch_floats, int g_stride, int batch, int t,
    int c, int h, int n_layers, int taps, int dilation_rate,
    int sigmoid_scale, cudaStream_t stream) {
  using namespace gtt;
  const int rows = batch * t;
  const int c2 = c / 2;
  cudaError_t err;

  // z starts as x; the coupling epilogue overwrites its second half with z1
  if ((err = cudaMemcpyAsync(zbuf, x, sizeof(float) * rows * c,
                             cudaMemcpyDeviceToDevice, stream)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(skip, 0, sizeof(float) * rows * h, stream)) !=
      cudaSuccess)
    return (int)err;

  {  // h0 = (x0 @ W_s + b_s) * mask
    ConvGemm g;
    g.a = x; g.lda = c; g.c_in = c2; g.batch = batch; g.t = t;
    g.w = w_s; g.bias = b_s; g.n = h; g.epilogue = kBiasMask;
    g.out = xcur; g.ldo = h; g.mask = mask;
    g.tc_scratch = tc_scratch; g.tc_scratch_floats = tc_scratch_floats;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
  }
  {  // skip = WN stack of h0, no dropout, nothing saved
    WnLayers wn;
    wn.x = xcur; wn.acts = acts; wn.skip = skip; wn.mask = mask;
    wn.w_in = w_in; wn.b_in = b_in; wn.w_rs = w_rs; wn.b_rs = b_rs;
    wn.g_all = g_all; wn.g_stride = g_stride; wn.batch = batch; wn.t = t;
    wn.h = h; wn.n_layers = n_layers; wn.taps = taps;
    wn.dilation_rate = dilation_rate;
    wn.tc_scratch = tc_scratch; wn.tc_scratch_floats = tc_scratch_floats;
    if ((err = wn_layers(wn, stream)) != cudaSuccess) return (int)err;
  }
  {  // z1 = (x1 - m) * exp(-logs) * mask, written over zbuf[:, c2:]
    ConvGemm g;
    g.a = skip; g.lda = h; g.c_in = h; g.a_mask = mask; g.batch = batch; g.t = t;
    g.w = w_e; g.bias = b_e; g.n = c; g.split = c2; g.epilogue = kCouplingInv;
    g.out = zbuf + c2; g.ldo = c; g.mask = mask; g.flag = sigmoid_scale;
    g.tc_scratch = tc_scratch; g.tc_scratch_floats = tc_scratch_floats;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
  }
  {  // y = (z @ A_inv + bA_inv) * mask
    ConvGemm g;
    g.a = zbuf; g.lda = c; g.c_in = c; g.batch = batch; g.t = t;
    g.w = a_inv; g.bias = ba_inv; g.n = c; g.epilogue = kBiasMask;
    g.out = y; g.ldo = c; g.mask = mask;
    g.tc_scratch = tc_scratch; g.tc_scratch_floats = tc_scratch_floats;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
