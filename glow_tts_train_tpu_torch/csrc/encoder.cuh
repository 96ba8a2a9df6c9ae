// The forward chain of one text-encoder layer (encoder.cu), shared by the
// forward entry point and by the backward entry point's recompute
// (encoder_train.cu), and the layer's scratch layout.
#pragma once

#include "common.cuh"

namespace gtt {

constexpr int kAttnMaxD = 128;    // head width the attention kernels take
constexpr int kAttnMaxBand = 33;  // 2 * window + 1

// The shapes of one layer call.
struct EncoderDims {
  int batch = 0, t = 0, h = 0, n_heads = 0, window = 0, f = 0, taps = 1;
  long rows() const { return (long)batch * t; }
  int band() const { return 2 * window + 1; }
};

// Every buffer of one call, carved from the caller's one scratch block
// (encoder_scratch).  Forward: the chain's activations and the products'
// scratch; the backward adds the forward's saves and its own buffers.
struct EncoderScratch {
  float *qkv = nullptr, *att = nullptr, *x1 = nullptr, *x1m = nullptr, *ffn = nullptr;
  float *xhat1 = nullptr, *rstd1 = nullptr, *xhat2 = nullptr, *rstd2 = nullptr;
  float *stat_m = nullptr, *stat_linv = nullptr;
  float *tc = nullptr, *part = nullptr;
  long tc_floats = 0;
  // bf16: the attention and FFN branches' f32 outputs (the f32 layer
  // stages them in its output); qkv and x1m are bf16, and each operand of
  // the products has its bf16 copy, written by the kernel that produces it
  // (masked where the product reads it masked): xm16 = x * mask, att16 the
  // heads' outputs, rm16 the FFN's dropped, masked ReLU output (ffn holds
  // it in f32 for the backward's gates)
  float* y = nullptr;
  float *xm16 = nullptr, *att16 = nullptr, *rm16 = nullptr;
  // backward
  float *da = nullptr, *db = nullptr, *dc = nullptr, *datt = nullptr, *dffn = nullptr;
  float *dqkv = nullptr, *dqrel = nullptr, *pb = nullptr;
  float *ds = nullptr, *pd = nullptr, *wg = nullptr;
  long wg_floats = 0;
  // bf16 backward: ds and pd are bf16, and the cotangents' bf16 copies
  // (db: the FFN's output cotangent dconv2, dc: the attention output's dy,
  // datt: dout of the heads, dffn, dqkv)
  float *db16 = nullptr, *dc16 = nullptr, *datt16 = nullptr, *dffn16 = nullptr;
  float* dqkv16 = nullptr;
};

// Carve `base` (16-byte aligned) into s and return the floats used; with
// base null, only count.  `ffn` given: the FFN activation lives there
// (the backward hands it out) instead of in the scratch.
long encoder_scratch(float* base, const EncoderDims& d, bool backward, float* ffn,
                     EncoderScratch* s, bool bf16 = false);

// The bf16 attention core's launch: the heads' outputs bf16 (out16) and,
// where out is given, f32; the softmax's statistics where given.
cudaError_t attention_bf16(const float* qkv16, const float* mask, const float* rel_k,
                           const float* rel_v, float* out, float* out16, float* stat_m,
                           float* stat_linv, int batch, int t, int n_heads, int d, int window,
                           const Dropout& drop, cudaStream_t stream);

// What the attention cores (tensor cores, mma.sync) take: a head width
// that is a multiple of 8 and at most kAttnMaxD, 2 * window + 1 <=
// kAttnMaxBand, 16-byte aligned rel-pos tables.  Both entry points refuse
// anything else.
bool attention_fits(int d, int window, const float* rel_k, const float* rel_v);

struct EncoderArgs {
  const float* x = nullptr;     // [batch * t, h]
  const float* mask = nullptr;  // [batch * t]
  const float *wqkv = nullptr, *bqkv = nullptr;  // [h, 3h], [3h]: q | k | v
  const float *wo = nullptr, *bo = nullptr;
  const float *rel_k = nullptr, *rel_v = nullptr;  // [2w+1, d]
  const float *gamma1 = nullptr, *beta1 = nullptr, *gamma2 = nullptr, *beta2 = nullptr;
  const float *w1 = nullptr, *c1 = nullptr, *w2 = nullptr, *c2 = nullptr;
  float* out = nullptr;  // [batch * t, h]
  // qkv [rows, 3h]; att [rows, h] the heads' outputs before the
  // projection; x1 / x1m [rows, h] the first residual norm's output and
  // its masked copy; ffn [rows, f] the FFN's dropped, masked ReLU output;
  // when `save`, the norms' normalised inputs and inverse stds and the
  // softmax's row max and inverse row sum [batch, heads, t]; the products'
  // tensor-core scratch
  EncoderScratch s;
  bool save = false;
  EncoderDims dims;
  // n_sites = n_heads + 3: site hd on head hd's probabilities [t, t], then
  // the attention output [t, h], the FFN's ReLU [t, f] and its output [t, h]
  Dropout drop;
  // bf16 (fp16_run; encoder_pallas with dtype bf16): x, out, the weights
  // and the rel-pos tables bf16 (and in the backward dout, dx and the
  // weights' and tables' gradients); the rest and the scratch f32
  bool bf16 = false;
};

cudaError_t encoder_forward(const EncoderArgs& a, cudaStream_t stream);

// A product of the text chains: on the tensor cores where the shape fits,
// split-K allowed (conv_gemm_tc_plan; bf16: the TMA-fed wgmma kernel by
// tma_conv_plan, its operands bf16).
ConvGemm text_product(const EncoderScratch& s, bool bf16 = false);

}  // namespace gtt
