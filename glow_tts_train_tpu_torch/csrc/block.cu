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
// 3 + 2L conv-GEMMs: the WN gate and the res/skip split are fused into their
// GEMMs' epilogues (layer 0's res/skip writes the skip sum, so nothing is
// zeroed first), the coupling inverse into the end conv's, which also
// copies x0 beside z1 (so x is never copied whole), so the only activations
// that touch device memory are the [rows, h] WN state, gate output and skip
// sum, and the [rows, c] z.
//
// Bound on the card: the operations of the in-layer convs (K = 5 * 192,
// N = 384: 80% of the FLOPs) on the tensor cores (3xTF32, tc_gemm.cu), or,
// at a lone sentence, one block's serial K walk and the launches.  The
// design against the latter: every product asks for the tensor cores with
// split-K scratch and ConvGemm::small_batch, so a product of a lone
// sentence (832 rows for 250 phonemes: 21 tiles of the in-layer conv, 7
// row tiles of the 1x1 products) walks its K in shares as short as 64
// deep, in 128- or 64-row tiles, and fills the card; a batch keeps the
// chains' share limits.  The
// weights' K-major 3xTF32 splits are made once at load
// (block_cuda.split_inverse_weights) and passed in, so no product splits
// its weights at serve time.  Every buffer comes from the caller's one
// scratch block (gtt_block_inverse_scratch_floats).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using namespace gtt;

long round4(long floats) { return (floats + 3) / 4 * 4; }

// The call's buffers, carved from `base` (16-byte aligned; null: only
// count): the WN state, gate output and skip sum [rows, h], z [rows, c] and
// the split-K partial sums.
struct InverseScratch {
  float *xcur = nullptr, *acts = nullptr, *skip = nullptr, *zbuf = nullptr, *part = nullptr;
};

long inverse_scratch(float* base, long rows, int c, int h, InverseScratch* s) {
  long used = 0;
  auto take = [&](float*& p, long floats) {
    p = base ? base + used : nullptr;
    used += round4(floats);
  };
  take(s->xcur, rows * h);
  take(s->acts, rows * h);
  take(s->skip, rows * h);
  take(s->zbuf, rows * c);
  take(s->part, rows * kLoneSplitKCols);
  return used;
}

// A product of the chain: on the tensor cores with its weights split at
// load, in the serving plan's tile and K shares.
ConvGemm inverse_product(const InverseScratch& s, const float* w_split) {
  ConvGemm g;
  g.w_split = w_split;
  g.part = s.part;
  g.small_batch = 1;
  return g;
}

}  // namespace

extern "C" long long gtt_block_inverse_scratch_floats(int batch, int t, int c, int h) {
  InverseScratch s;
  return inverse_scratch(nullptr, (long)batch * t, c, h, &s);
}

// *_split: the weights' K-major splits (big [n, K], small after it; W_in
// and W_rs per layer, layer-major).  Scratch: one block of
// gtt_block_inverse_scratch_floats floats.
extern "C" int gtt_block_inverse(
    const float* x, const float* mask, const float* a_inv,
    const float* ba_inv, const float* w_s, const float* b_s, const float* w_e,
    const float* b_e, const float* w_in, const float* b_in, const float* w_rs,
    const float* b_rs, const float* g_all, const float* a_split,
    const float* w_s_split, const float* w_e_split, const float* w_in_split,
    const float* w_rs_split, float* y, float* scratch, long long scratch_floats,
    int g_stride, int batch, int t, int c, int h, int n_layers, int taps,
    int dilation_rate, int sigmoid_scale, cudaStream_t stream) {
  const int c2 = c / 2;
  InverseScratch s;
  if (inverse_scratch(scratch, (long)batch * t, c, h, &s) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  {  // h0 = (x0 @ W_s + b_s) * mask
    ConvGemm g = inverse_product(s, w_s_split);
    g.a = x; g.lda = c; g.c_in = c2; g.batch = batch; g.t = t;
    g.w = w_s; g.bias = b_s; g.n = h; g.epilogue = kBiasMask;
    g.out = s.xcur; g.ldo = h; g.mask = mask;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
  }
  {  // skip = WN stack of h0, no dropout, nothing saved
    WnLayers wn;
    wn.x = s.xcur; wn.acts = s.acts; wn.skip = s.skip; wn.mask = mask;
    wn.w_in = w_in; wn.b_in = b_in; wn.w_rs = w_rs; wn.b_rs = b_rs;
    wn.g_all = g_all; wn.g_stride = g_stride; wn.batch = batch; wn.t = t;
    wn.h = h; wn.n_layers = n_layers; wn.taps = taps;
    wn.dilation_rate = dilation_rate;
    wn.w_in_split = w_in_split; wn.w_rs_split = w_rs_split;
    wn.part = s.part; wn.small_batch = 1;
    if ((err = wn_layers(wn, stream)) != cudaSuccess) return (int)err;
  }
  {  // z = [x0 | (x1 - m) * exp(-logs) * mask]
    ConvGemm g = inverse_product(s, w_e_split);
    g.a = s.skip; g.lda = h; g.c_in = h; g.a_mask = mask; g.batch = batch; g.t = t;
    g.w = w_e; g.bias = b_e; g.n = c; g.split = c2; g.epilogue = kCouplingInv;
    g.aux = x; g.ld_aux = c; g.out = s.zbuf; g.ldo = c; g.mask = mask;
    g.flag = sigmoid_scale;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
  }
  {  // y = (z @ A_inv + bA_inv) * mask
    ConvGemm g = inverse_product(s, a_split);
    g.a = s.zbuf; g.lda = c; g.c_in = c; g.batch = batch; g.t = t;
    g.w = a_inv; g.bias = ba_inv; g.n = c; g.epilogue = kBiasMask;
    g.out = y; g.ldo = c; g.mask = mask;
    if ((err = conv_gemm(g, stream)) != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
