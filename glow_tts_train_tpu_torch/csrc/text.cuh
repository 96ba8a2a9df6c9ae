// The forward chains of the text-side conv stacks (text.cu), shared by the
// forward entry points and by the backward entry points' recompute
// (text_train.cu).
#pragma once

#include "common.cuh"

namespace gtt {

// The prenet's shapes, and every buffer of one call carved from the
// caller's one scratch block (prenet_scratch).  Forward: x * mask, the
// conv's raw output, the layers' masked outputs (one [rows, h] buffer, or
// [L, rows, h] when saving: layer l at curm + l * rows * h) and the
// products' tensor-core scratch; the backward adds the norms' saves, its
// own buffers and the transposed products' weight splits.
struct PrenetDims {
  int batch = 0, t = 0, h = 0, n_layers = 0, taps = 1;
  long rows() const { return (long)batch * t; }
};

struct PrenetScratch {
  float *xm = nullptr, *pre = nullptr, *curm = nullptr;
  float *tc = nullptr, *part = nullptr;
  long tc_floats = 0;
  // backward
  float *xhat = nullptr, *rstd = nullptr, *dcur = nullptr, *dpre = nullptr;
  float *col_part = nullptr, *wg = nullptr;
  long wg_floats = 0;
};

// Carve `base` (16-byte aligned) into s and return the floats used; with
// base null, only count.
long prenet_scratch(float* base, const PrenetDims& d, bool backward, PrenetScratch* s);

// A product of the prenet's chains: on the tensor cores where the shape
// fits, split-K allowed (conv_gemm_tc_splits).
ConvGemm prenet_product(const PrenetScratch& s);

// A chain's L convs and projection have their weights split in one launch
// (presplit_weights), which takes at most kMaxSplits products.
constexpr int kMaxPrenetLayers = kMaxSplits - 1;

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
  // when saving: the layers' outputs before the mask [L, batch * t, h]
  // (the backward's ReLU gates, handed out), the norms' normalised inputs
  // and inverse stds (s.xhat, s.rstd) and every layer's masked output
  float* cur = nullptr;
  bool save = false;
  PrenetScratch s;
  PrenetDims dims;
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
