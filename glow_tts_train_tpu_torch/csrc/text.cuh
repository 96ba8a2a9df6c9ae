// The forward chains of the text-side conv stacks (text.cu), shared by the
// forward entry points and by the backward entry points' recompute
// (text_train.cu).
#pragma once

#include "common.cuh"

namespace gtt {

struct PrenetArgs {
  const float* x = nullptr;     // [batch * t, h]
  const float* mask = nullptr;  // [batch * t]
  const float* w = nullptr;     // [L, taps * h, h]
  const float* b = nullptr;     // [L, h]
  const float* gamma = nullptr;
  const float* beta = nullptr;
  const float* wp = nullptr;  // [h, h]
  const float* bp = nullptr;
  float* out = nullptr;  // [batch * t, h]
  float* pre = nullptr;  // [batch * t, h] scratch
  // layer outputs: one [batch * t, h] buffer, or [L, batch * t, h] (layer l
  // kept at cur + l * rows * h) when xhat is given
  float* cur = nullptr;
  float* xhat = nullptr;  // [L, batch * t, h] or null
  float* rstd = nullptr;  // [L, batch * t] or null
  int batch = 0, t = 0, h = 0, n_layers = 0, taps = 1;
  Dropout drop;  // site l of n_layers over [t, h], after layer l's ReLU
};

cudaError_t prenet_forward(const PrenetArgs& a, cudaStream_t stream);

struct DurationArgs {
  const float* x = nullptr;  // [batch * t, c_in]
  const float* mask = nullptr;
  const float* w[2] = {nullptr, nullptr};  // [taps * c_in, f], [taps * f, f]
  const float* b[2] = {nullptr, nullptr};
  const float* gamma[2] = {nullptr, nullptr};
  const float* beta[2] = {nullptr, nullptr};
  float* out = nullptr;  // [batch * t, f]
  // ReLU outputs: one [batch * t, f] buffer, or [2, batch * t, f] when xhat
  // is given
  float* relu = nullptr;
  float* mid = nullptr;   // [batch * t, f]: layer 0's output when saving, else unused
  float* xhat = nullptr;  // [2, batch * t, f] or null
  float* rstd = nullptr;  // [2, batch * t] or null
  int batch = 0, t = 0, c_in = 0, f = 0, taps = 1;
  Dropout drop;  // site l of 2 over [t, f], after layer l's LayerNorm
};

cudaError_t duration_forward(const DurationArgs& a, cudaStream_t stream);

}  // namespace gtt
