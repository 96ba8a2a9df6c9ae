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
// own buffers and the transposed products' weight splits.  The scratch is
// f32 but for the products' operands in a bf16 call: xm and curm then hold
// bf16 elements (the first half of each buffer), and the backward's bf16
// buffers dpre16 (dpre's copy) and dout16 (dout * mask) serve it alone.
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
  float *dpre16 = nullptr, *dout16 = nullptr;
};

// Carve `base` (16-byte aligned) into s and return the floats used; with
// base null, only count.
long prenet_scratch(float* base, const PrenetDims& d, bool backward, PrenetScratch* s);


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
  // bf16 (fp16_run): x, out, w and wp bf16 (and in the backward dout, dx,
  // dw and dwp), and the products' operands in the scratch (PrenetScratch);
  // the rest f32
  bool bf16 = false;
};

cudaError_t prenet_forward(const PrenetArgs& a, cudaStream_t stream);

// The duration stack's shapes, and every buffer of one call carved from
// the caller's one scratch block (duration_scratch).  Forward: x * mask,
// the conv's ReLU output (the ReLU outputs go to the caller's `relu` when
// saving), layer 0's masked output (layer 1's conv input), the products'
// tensor-core scratch (the K-major splits of the two convs' weights and,
// for the backward, of its two transposed convs) and the split-K partial
// sums; the backward adds the norms' saves and its own buffers.  As the
// prenet's: xm and curm hold bf16 elements in a bf16 call, and the
// backward's bf16 dpre16 serves it alone.
struct DurationDims {
  int batch = 0, t = 0, c_in = 0, f = 0, taps = 1;
  long rows() const { return (long)batch * t; }
};

struct DurationScratch {
  float *xm = nullptr, *pre = nullptr, *curm = nullptr;
  float *tc = nullptr, *part = nullptr;
  long tc_floats = 0;
  // backward
  float *xhat = nullptr, *rstd = nullptr, *dcur = nullptr, *dpre = nullptr, *wg = nullptr;
  long wg_floats = 0;
  float* dpre16 = nullptr;
};

long duration_scratch(float* base, const DurationDims& d, bool backward, DurationScratch* s);

// A product of the prenet's or the duration stack's chains: on the tensor
// cores where the shape fits, split-K allowed (conv_gemm_tc_plan; bf16: the
// TMA-fed wgmma kernel by tma_conv_plan, its operands bf16).
template <class Scratch>
ConvGemm text_chain_product(const Scratch& s, bool bf16) {
  ConvGemm g;
  g.tc_scratch = s.tc;
  g.tc_scratch_floats = s.tc_floats;
  g.part = s.part;
  g.tma_ring = bf16 ? 1 : 0;
  return g;
}

struct DurationArgs {
  const float* x = nullptr;  // [batch * t, c_in]
  const float* mask = nullptr;
  const float* w[2] = {nullptr, nullptr};  // [taps * c_in, f], [taps * f, f]
  const float* b[2] = {nullptr, nullptr};
  const float* gamma[2] = {nullptr, nullptr};
  const float* beta[2] = {nullptr, nullptr};
  float* out = nullptr;  // [batch * t, f]
  // when saving: the ReLU outputs [2, batch * t, f] (the backward's ReLU
  // gates, handed out) and the norms' normalised inputs and inverse stds
  // (s.xhat, s.rstd)
  float* relu = nullptr;
  bool save = false;
  DurationScratch s;
  DurationDims dims;
  Dropout drop;  // site l of 2 over [t, f], after layer l's LayerNorm
  // bf16 (fp16_run): x, out and w bf16 (and in the backward dout, dx and
  // dw), and the products' operands in the scratch (DurationScratch); the
  // rest f32
  bool bf16 = false;
};

// The stack's two convs as its chain runs them: each reads its input
// stored masked (x * mask, then layer 0's masked output), on the tensor
// cores where the shape fits, split-K allowed.  In an f32 call the caller
// splits their weights (presplit_weights) before duration_forward runs
// them.
void duration_convs(const DurationArgs& a, ConvGemm (&g)[2]);

cudaError_t duration_forward(const DurationArgs& a, const ConvGemm (&g)[2],
                             cudaStream_t stream);

// out = x * mask over [rows, n], x and out f32 or (bf16) both bf16 (exact:
// the mask is 0 or 1): the first conv's input, stored masked, and the
// prenet backward's dout * mask
cudaError_t mask_rows(const float* x, const float* mask, float* out, long rows, int n,
                      bool bf16, cudaStream_t stream);

}  // namespace gtt
