// Shared device building blocks of the serving kernels (f32 throughout).
//
// Every TPU kernel of the serving path (prenet, encoder layer, duration
// predictor, inverse flow block) is a chain of the same two pieces here plus,
// for the encoder, the attention core in encoder.cu:
//
//  * conv_gemm: a tiled f32 GEMM whose A operand is an im2col view gathered
//    on load (tap offsets dilation*(k - K/2), zeros outside [0, t), optional
//    input mask), with the elementwise tail of each TPU kernel fused into its
//    epilogue (bias, ReLU, mask, residual, WaveNet gate, residual/skip split,
//    inverse affine coupling).
//  * layer_norm: one warp per row over the channel axis (eps 1e-4, biased
//    variance), with an optional masked residual sum and ReLU before or after.
//
// Activations are channels-last [batch * t, channels] row-major; weights are
// the JAX folds' [taps * c_in, n] row-major matrices, so no weight is
// re-laid-out for the card.
#pragma once

#include <cuda_runtime.h>

namespace gtt {

enum Epilogue : int {
  kBias = 0,         // out = acc + bias
  kBiasRelu = 1,     // out = max(acc + bias, 0)
  kBiasMask = 2,     // out = (acc + bias) * mask
  kResidMask = 3,    // out = (aux + acc + bias) * mask
  kGate = 4,         // out[:, j] = tanh(u_j + b + g) * sigmoid(v_j + b + g)
  kResSkip = 5,      // out[:, :split] = (out + acc + b) * mask; out2 += acc + b
  kCouplingInv = 6,  // out[:, j] = (out[:, j] - m_j) * exp(-logs_j) * mask
};

struct ConvGemm {
  // A: rows of a channels-last source [batch * t, lda]; the im2col column
  // tap * c_in + c of row (b, i) reads source row (b, i + (tap - taps/2) *
  // dilation), channel c, times a_mask of that source row when given.
  const float* a = nullptr;
  int lda = 0;
  int c_in = 0;
  const float* a_mask = nullptr;
  int taps = 1;
  int dilation = 1;
  int batch = 0;
  int t = 0;
  // B: [taps * c_in, n] row-major, bias [n].
  const float* w = nullptr;
  const float* bias = nullptr;
  int n = 0;
  // kGate / kCouplingInv read output pairs (j, j + split) of B side by side
  // (logical column 2j + e is physical column j + e * split); kResSkip splits
  // the columns at `split` into a residual and a skip half.
  int split = 0;
  int epilogue = kBias;
  float* out = nullptr;
  int ldo = 0;
  const float* mask = nullptr;  // [batch * t] epilogue row mask
  // kResidMask: residual rows [batch * t, ld_aux]; kGate: per-sample
  // conditioning [batch, ld_aux] (row b at aux + b * ld_aux), or null.
  const float* aux = nullptr;
  int ld_aux = 0;
  float* out2 = nullptr;  // kResSkip skip accumulator [batch * t, ldo2]
  int ldo2 = 0;
  // kResSkip: update the residual half; kCouplingInv: sigmoid_scale.
  int flag = 0;
};

cudaError_t conv_gemm(const ConvGemm& g, cudaStream_t stream);

struct LayerNorm {
  // out = LN(relu_before? (x * x_mask + resid)) [relu_after], per row
  const float* x = nullptr;
  const float* x_mask = nullptr;  // [rows] or null
  const float* resid = nullptr;   // [rows, n] or null
  const float* gamma = nullptr;
  const float* beta = nullptr;
  float* out = nullptr;  // may alias x or resid
  int rows = 0;
  int n = 0;
  int relu_before = 0;
  int relu_after = 0;
};

cudaError_t layer_norm(const LayerNorm& a, cudaStream_t stream);

}  // namespace gtt
