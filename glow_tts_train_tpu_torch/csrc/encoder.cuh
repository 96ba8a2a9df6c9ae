// The forward chain of one text-encoder layer (encoder.cu), shared by the
// forward entry point and by the backward entry point's recompute
// (encoder_train.cu).
#pragma once

#include "common.cuh"

namespace gtt {

constexpr int kAttnMaxD = 128;    // head width the attention kernels take
constexpr int kAttnMaxBand = 33;  // 2 * window + 1

struct EncoderArgs {
  const float* x = nullptr;     // [batch * t, h]
  const float* mask = nullptr;  // [batch * t]
  const float *wq = nullptr, *bq = nullptr, *wk = nullptr, *bk = nullptr;
  const float *wv = nullptr, *bv = nullptr, *wo = nullptr, *bo = nullptr;
  const float *rel_k = nullptr, *rel_v = nullptr;  // [2w+1, d]
  const float *gamma1 = nullptr, *beta1 = nullptr, *gamma2 = nullptr, *beta2 = nullptr;
  const float *w1 = nullptr, *c1 = nullptr, *w2 = nullptr, *c2 = nullptr;
  float* out = nullptr;  // [batch * t, h]
  float* qkv = nullptr;  // [batch * t, 3h]
  float* att = nullptr;  // [batch * t, h] heads' outputs before the projection
  float* x1 = nullptr;   // [batch * t, h] the first residual norm's output
  float* ffn = nullptr;  // [batch * t, f] the FFN's (dropped) ReLU output
  // kept for the backward, or null: the norms' normalised inputs and inverse
  // stds, and the softmax's row max and inverse row sum [batch, heads, t]
  float *xhat1 = nullptr, *rstd1 = nullptr, *xhat2 = nullptr, *rstd2 = nullptr;
  float *stat_m = nullptr, *stat_linv = nullptr;
  int batch = 0, t = 0, h = 0, n_heads = 0, window = 0, f = 0, taps = 1;
  // n_sites = n_heads + 3: site hd on head hd's probabilities [t, t], then
  // the attention output [t, h], the FFN's ReLU [t, f] and its output [t, h]
  Dropout drop;
};

cudaError_t encoder_forward(const EncoderArgs& a, cudaStream_t stream);

}  // namespace gtt
