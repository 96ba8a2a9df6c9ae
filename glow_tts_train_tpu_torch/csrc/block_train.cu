// The training direction of the flow block and of the WN stack alone:
//
//  * gtt_wn_forward      <- glow_tts_train_tpu/ops/wn_pallas.py::_fwd_kernel
//  * gtt_wn_fwd_save     <- ops/wn_pallas.py::_fwd_save_kernel
//  * gtt_wn_bwd_store    <- ops/wn_pallas.py::_bwd_store_kernel
//  * gtt_wn_bwd          <- ops/wn_pallas.py::_bwd_kernel (recompute)
//  * gtt_block_fwd       <- ops/block_pallas.py::_block_fwd_kernel
//  * gtt_block_fwd_save  <- ops/block_pallas.py::_block_fwd_save_kernel
//  * gtt_block_bwd_store <- ops/block_pallas.py::_block_bwd_store_kernel
//  * gtt_block_bwd       <- ops/block_pallas.py::_block_bwd_kernel (recompute)
//
// and each in bf16 (fp16_run; the TPU kernels with dtype bf16):
// gtt_wn_forward_bf16, gtt_wn_fwd_save_bf16, gtt_wn_bwd_store_bf16,
// gtt_wn_bwd_bf16, gtt_block_fwd_bf16, gtt_block_fwd_save_bf16,
// gtt_block_bwd_store_bf16 and gtt_block_bwd_bf16.
//
// All sixteen are assemblies of three launch chains, as the TPU kernels are
// of _layer_fwd, _reverse_walk and _block_bwd_math: the forward chain
// (with or without the saves), the WN reverse walk, and the block backward
// around it.  A recompute backward runs the forward-save chain into scratch
// and then the store backward's chain: the same products on the same
// inputs as store mode, so its gradients are store mode's bit for bit.
//
// Forward of one block (per row of the [batch * t, c] activations):
//
//   zp      = (x @ A + bA) * mask                      x0, x1 = zp halves
//   xs[0]   = (x0 @ W_s + b_s) * mask
//   layer l: u|v = drop(conv_K(xs[l]) + b_in) + g;  th, sg = tanh u, sigmoid v
//            rs = (th * sg) @ W_rs + b_rs
//            xs[l+1] = (xs[l] + rs[:, :h]) * mask;  skip += rs[:, h:]
//   skipm   = skip * mask
//   m, logs = skipm @ W_e + b_e                        (+ sigmoid_scale)
//   z       = [x0 | (m + e^logs * x1) * mask];  ld[b] = sum(logs * mask)
//
// Each line is one conv_gemm launch with the elementwise tail in its
// epilogue; zp, skipm and the per-layer xs/th/sg ([L, rows, h], layer-major
// so each layer's slice is one GEMM operand) are written for the backward,
// the keep masks are not: the backward replays them from the seed.
//
// Backward (the TPU kernel's order): the end conv's logs are rebuilt from
// skipm with one GEMM whose epilogue is the coupling backward (dm, dlogs
// with dld, dx1); dW_e and db_e; dskip = (dout @ W_e^T) * mask; then the WN
// reverse walk from layer L-1 down, per layer
//
//   da      = [gx * mask | dskip] @ W_rs^T  -> gate backward in the epilogue
//             (d_xin = drop(d_in_act), acts = th * sg; d_in_act only for
//             the conditioned model's dg, per-sample sums)
//   dW_rs, db_rs = [acts | 1]^T [gx * mask | dskip]
//   dW_in, db_in = [im2col(xs[l]) | 1]^T d_xin
//   gx      = gx * mask + sum_k d_xin[t - off_k] W_k^T   (transposed conv)
//
// then the start conv (dW_s, db_s, dx0 = dz0 + (gx * mask) @ W_s^T) and the
// folded A (dA, dbA, dx = dzp @ A^T).
//
// The backward's design (the WN walk's; the block chain takes it by
// calling the walk):
//  * Weights as the forward holds them.  Every transposed product (W_rs^T,
//    W_in^T per tap, W_e^T, W_s^T, A^T) reads the forward's weights through
//    ConvGemm::w_t, and the K-major 3xTF32 splits of all of a call's
//    products, a recompute's forward ones included, are made in one
//    presplit_weights launch at its start: no layout copy on the host, no
//    split launch inside the chain.
//  * Bias gradients inside the weight-gradient products.  A bias gradient
//    is the weight gradient of an input column of ones (WGrad::bias_out):
//    the tensor-core kernel fills one spare im2col column with ones and
//    writes that output row, through its own split-ordered second pass, to
//    the bias gradient.  No column-sum launch and no second read of g_rs,
//    d_xin, dout, gx or dzp; the gate backward writes d_in_act only for dg.
//  * The transposed conv stages A once for all taps (conv_gemm_tap_kernel,
//    ConvGemm::tap_staged): K walked channel slice outer and tap inner, a
//    tile's rows and their dilated halo copied once a channel slice.
//  * dW_in reads d_xin's K-major split (WGrad::dy_t), which the gate
//    backward's epilogue writes beside d_xin (ConvGemm::out4), as the
//    conv-GEMM reads its weights: no transposition and no split of dY in
//    the weight-gradient kernel.
// Weight gradients reduce over all rows by split partial sums and a second
// pass in a fixed order: no float atomics, so a gradient is the same bits
// from run to run.  Every buffer of a backward call comes from the caller's
// one scratch block (bwd_scratch).
//
// Bound on the card: the operations of the in-layer conv products
// (forward one, backward three per layer at K = 5 * 192, N = 384).  Every
// product of these chains but one asks for the tensor cores (tc_gemm.cu):
// conv-GEMMs and weight gradients run as wgmma TF32 products, f32-accurate
// by the 3xTF32 split, so the bound is their operations over a third of
// the TF32 peak (165 TFLOP/s)
// where the shape fits and over the f32 CUDA-core peak where it does not
// (narrow test widths, a few hundred rows).  The one is the forward's
// zp = x @ A: a tensor-core product reads 1e-7 low in every output alike,
// and the ActNorm scale's gradient is a small difference of large sums of
// zp's squares (block_fwd_chain says more); it is 1.4% of a block's
// operations.  The TPU kernels keep a
// sample's block and its weight-gradient accumulators in VMEM; here every
// product streams its operands through L2 and only the [rows, h] /
// [rows, 2h] activations and the saved residuals reach device memory.
//
// The bf16 chains (the *_bf16 entry points; wn_pallas and block_pallas
// with dtype bf16): every product but the folded A asks for
// the TMA-fed wgmma bf16 kernels (bf16_gemm.cu, ConvGemm::tma_ring,
// WGrad::tma_ring), which copy operands as they lie, so every operand they
// read is bf16: the gate product acts is written bf16, and each f32
// cotangent (g_rs, d_xin, dout, d_pre = gx * mask, dzp) is written as the
// bf16 copy that the epilogue producing it rounds (ConvGemm::out_c,
// out2_c), the JAX kernels' one ``.astype(bf16)`` before their two dots.
// Their f32 values, which only the bias gradients (and dg) read, are not
// written: the same epilogues keep their column sums per sample and 64-row
// tile (ConvGemm::sums, BwdScratch), and each weight gradient's one
// reduction launch adds its row splits, its bias's tile sums and, for
// dW_in, dg's (WGrad::bias_lo / bias_hi / g_sums): two launches a weight
// gradient, a fixed order, no atomics.  g_rs's skip half is the same in
// every layer, so its sums are taken once (dskip's epilogue, or the WN
// stack's cotangent kernel) for all L layers' db_rs.  The WN stack alone
// sums its skip in f32 and writes one rounded, masked bf16 output (the
// last layer's skipm: JAX's ``skip.astype(bf16) * x_mask``); its backward
// takes the output's bf16 cotangent into g_rs's copy, keeps gx in f32 and
// returns it rounded (the last transposed conv's out_c).  A recompute
// call (gtt_block_bwd_bf16, gtt_wn_bwd_bf16) runs the bf16 forward-save
// chain into its scratch, bf16 saves on 16-byte boundaries as the TMA
// tensor maps read them, g_rs [rows, h] its f32 skip sum, then the store
// backward's chain: its gradients are the store call's bit for bit.
// Bound: the same operations over the dense BF16 peak (989 TFLOP/s).
//
// The forward's design: every product's weights of a call are split in
// one presplit_weights launch, its first operation, into the caller's one
// scratch block (fwd_split_floats); the WN layers' products ask for the
// TMA-fed kernel (ConvGemm::tma_ring: conv_gemm_tma_kernel, B and A
// brought by TMA into an mbarrier ring, A staged once a channel slice for
// all taps), whose split is written in tile order.  A recompute
// backward runs the same products by the same plan, so its forward is
// the store call's bit for bit.
#include <cuda_runtime.h>

#include <algorithm>
#include <vector>

#include "common.cuh"

using namespace gtt;

namespace {

#define GTT_TRY(expr)                               \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

long round4(long floats) { return (floats + 3) / 4 * 4; }

// Whether a bf16 chain's folded A stays on the CUDA cores (gtt_bf16_core_zp:
// the f32 chains' unit, for a measurement of both in one run); default:
// the TMA-fed wgmma kernel.
bool& core_zp() {
  static bool on = false;
  return on;
}

// Sizes and the dropout of one call.
struct Dims {
  int batch, t, c, h, n_layers, taps, dilation_rate;
  Dropout drop;
  // scratch of the tensor-core conv-GEMM's weight split (ConvGemm::tc_scratch)
  float* tc_scratch;
  long tc_scratch_floats;
  // a bf16 call (fp16_run): x, zp, skipm, xs / th / sg, z, dz, dx, g_all
  // and the products' weights and their gradients bf16, the rest f32; the
  // forward's skip sum [rows, h] f32
  int bf16 = 0;
  float* skip = nullptr;
};

// The bf16 bits of a product of call d: kBf16 and `bits` in a bf16 call,
// nothing in an f32 one.
unsigned b16(const Dims& d, unsigned bits) { return d.bf16 ? kBf16 | bits : 0u; }

// A product over the call's rows, on the tensor cores where it fits.
ConvGemm rows_gemm(const Dims& d, const float* a, int lda, int c_in,
                   const float* w, const float* bias, int n, int epilogue,
                   float* out, int ldo, const float* mask) {
  ConvGemm g;
  g.a = a; g.lda = lda; g.c_in = c_in; g.batch = d.batch; g.t = d.t;
  g.w = w; g.bias = bias; g.n = n; g.epilogue = epilogue;
  g.out = out; g.ldo = ldo; g.mask = mask;
  g.tc_scratch = d.tc_scratch; g.tc_scratch_floats = d.tc_scratch_floats;
  return g;
}

// A weight gradient over the call's rows, on the tensor cores where it fits.
WGrad wgrad_of(const float* a, int lda, int c_in, int batch, int t,
               const float* dy, int ldy, int n, float* out,
               float* scratch, long scratch_floats) {
  WGrad w;
  w.a = a; w.lda = lda; w.c_in = c_in; w.batch = batch; w.t = t;
  w.dy = dy; w.ldy = ldy; w.n = n; w.out = out;
  w.scratch = scratch; w.scratch_floats = scratch_floats;
  w.tc = 1;
  return w;
}

// The WN stack's weights and conditioning as the forward reads them.
struct WnWeights {
  const float *w_in, *b_in, *w_rs, *b_rs, *g_all;
  int g_stride;
};

WnLayers wn_stack(const Dims& d, const WnWeights& w, const float* mask, float* x,
                  float* th, float* sg, float* acts, float* skip, int skip_mask) {
  WnLayers a;
  a.x = x; a.th = th; a.sg = sg; a.acts = acts; a.skip = skip;
  a.skip_mask = skip_mask; a.mask = mask;
  a.w_in = w.w_in; a.b_in = w.b_in; a.w_rs = w.w_rs; a.b_rs = w.b_rs;
  a.g_all = w.g_all; a.g_stride = w.g_stride;
  a.batch = d.batch; a.t = d.t; a.h = d.h; a.n_layers = d.n_layers;
  a.taps = d.taps; a.dilation_rate = d.dilation_rate; a.drop = d.drop;
  a.tc_scratch = d.tc_scratch; a.tc_scratch_floats = d.tc_scratch_floats;
  a.tma_ring = 1;
  a.bf16 = d.bf16;
  return a;
}

// The WN stack's 2L products in order.
void wn_products(const WnLayers& a, std::vector<ConvGemm>* out) {
  int dilation = 1;
  for (int l = 0; l < a.n_layers; ++l) {
    ConvGemm in, rs;
    wn_layer_products(a, l, dilation, &in, &rs);
    out->push_back(in);
    out->push_back(rs);
    dilation *= a.dilation_rate;
  }
}

int run_products(const std::vector<ConvGemm>& gs, cudaStream_t stream) {
  for (const ConvGemm& g : gs) GTT_TRY(conv_gemm(g, stream));
  return 0;
}

void add_products(std::vector<ConvGemm*>* list, std::vector<ConvGemm>* gs) {
  for (ConvGemm& g : *gs) list->push_back(&g);
}

// The block forward's products up to skipm: zp = (x @ A + bA) * mask, xs[0]
// = (x0 @ W_s + b_s) * mask, the WN layers (skipm = skip * mask once the
// sum is complete).  With saves (th set) xs / th / sg are layer-major [L,
// rows, h]; without, xs is the [rows, h] WN state.
void block_fwd_products(const Dims& d, const float* x, const float* mask, const float* a,
                        const float* ba, const float* w_s, const float* b_s,
                        const WnWeights& wn, float* zp, float* skipm, float* xs, float* th,
                        float* sg, float* acts, std::vector<ConvGemm>* out) {
  const int c = d.c, h = d.h;
  {
    // f32: on the CUDA cores.  A tensor-core product is short by about 1e-7
    // of each output (its accumulator rounds toward zero), all outputs
    // alike, and the ActNorm scale's gradient is the small difference of
    // sum(z^2) and the frame count, which turns that into 1e-3 of the
    // gradient.  bf16: on the TMA-fed wgmma kernel, as JAX rounds zp to
    // bf16 right after the product (a step of 2^-8 of it, 1e-7 is
    // 1/20,000 of that); PERF.md holds the check of both against JAX's
    // bf16 gap.  core_zp (gtt_bf16_core_zp, a measurement switch) keeps
    // it on the CUDA cores in bf16 too.
    ConvGemm g = rows_gemm(d, x, c, c, a, ba, c, kBiasMask, zp, c, mask);
    g.tc_scratch = nullptr;
    g.bf16 = b16(d, (core_zp() ? kBf16Core : 0u) | kA16 | kW16 | kOut16);
    g.tma_ring = d.bf16;
    out->push_back(g);
  }
  ConvGemm start = rows_gemm(d, zp, c, c / 2, w_s, b_s, h, kBiasMask, xs, h, mask);
  start.bf16 = b16(d, kA16 | kW16 | kOut16);
  start.tma_ring = d.bf16;
  out->push_back(start);
  // bf16: the skip sum in f32 (d.skip), skipm its masked, rounded copy
  WnLayers layers = wn_stack(d, wn, mask, xs, th, sg, acts, d.bf16 ? d.skip : skipm, 1);
  layers.skipm = skipm;
  wn_products(layers, out);
}

// Floats of a forward call's one scratch block: the K-major splits of its
// products as presplit_weights lays them out (c 0: the WN stack alone; the
// block's zp stays on the CUDA cores and splits nothing).
long fwd_split_floats(int c, int h, int n_layers, int taps) {
  const long h2 = 2L * h;
  long floats = n_layers * (round4(2L * taps * h * h2) + round4(2L * h * h2));
  if (c > 0) floats += round4(2L * (c / 2) * h) + round4(2L * h * c);
  return floats;
}

// Forward of one block.  zp may be z itself (nothing kept).  Its products'
// weights are split in one launch first, into d.tc_scratch.
int block_fwd_chain(const Dims& d, const float* x, const float* mask,
                    const float* a, const float* ba, const float* w_s,
                    const float* b_s, const float* w_e, const float* b_e,
                    const WnWeights& wn, int sigmoid_scale, float* z, float* ld,
                    float* zp, float* skipm, float* xs, float* th, float* sg,
                    float* acts, float* logsm, float* ld_part,
                    cudaStream_t stream) {
  const int batch = d.batch, t = d.t, c = d.c, h = d.h;
  const int rows = batch * t;
  const int c2 = c / 2;
  std::vector<ConvGemm> fwd;
  block_fwd_products(d, x, mask, a, ba, w_s, b_s, wn, zp, skipm, xs, th, sg, acts, &fwd);
  // z = [x0 | (m + e^logs * x1) * mask], logsm = logs * mask
  ConvGemm e = rows_gemm(d, skipm, h, h, w_e, b_e, c, kCouplingFwd, elem_at(z, c2, d.bf16),
                         c, mask);
  e.split = c2; e.flag = sigmoid_scale; e.out2 = logsm; e.ldo2 = c2;
  e.bf16 = b16(d, kA16 | kW16 | kOut16);
  e.tma_ring = d.bf16;
  std::vector<ConvGemm*> list;
  add_products(&list, &fwd);
  list.push_back(&e);
  GTT_TRY(presplit_weights(list.data(), (int)list.size(), d.tc_scratch, d.tc_scratch_floats,
                           stream));
  {
    const int err = run_products(fwd, stream);
    if (err != 0) return err;
  }
  if (z != zp)
    GTT_TRY(cudaMemcpyAsync(z, zp, (d.bf16 ? 2 : 4) * (long)rows * c, cudaMemcpyDeviceToDevice,
                            stream));
  GTT_TRY(conv_gemm(e, stream));
  // ld[b] = sum over the sample's rows and columns of logs * mask
  GTT_TRY(col_sum(logsm, c2, c2, nullptr, batch, t, ld_part, c2, stream));
  GTT_TRY(col_sum(ld_part, 1, 1, nullptr, batch, c2, ld, 1, stream));
  return (int)cudaGetLastError();
}

// Every buffer of one backward call, carved from the caller's one block
// (bwd_scratch): the walk's res/skip cotangent g_rs, d_in_act (dia, for dg
// only), d_xin and its K-major split (big [2h, ldt], small after it), the
// gate product acts, the weight gradients' split partial sums (wg, also
// what a product would split its own weights into: none does) and the
// K-major splits of every product's weights; the block's dout, dzp [rows,
// c] and the stack-input cotangent gx [rows, h]; a recompute's forward
// residuals xs / th / sg [L, rows, h] and the block's zp [rows, c] and
// skipm [rows, h].
//
// A bf16 call's cotangents g_rs, d_xin and the block's dout, dzp are
// written only as bf16 copies, by the epilogues that produce them, for
// their products: g_rs16 [rows, 2h], dxin16 [rows, 2h], dout16, dzp16
// [rows, c], and gx16 [rows, h] (gx * mask); their f32 values, which only
// the bias and conditioning gradients read, are summed in those epilogues
// instead (TileSums [batch, ceil(t / 64), n]): xin_sums (d_xin, 2h),
// g_sums (d_in_act, 2h: dg), rs_sums (g_rs's res half, h, written by each
// transposed conv for the next layer's dW_rs; the block's layer 0: gx *
// mask, for dW_s), skip_sums (g_rs's skip half, h, once for every layer)
// and the block's dout_sums and dzp_sums (c).  gx [rows, h] stays f32 (the
// transposed convs accumulate it; the WN stack's dx is gx rounded); g_rs
// is f32 [rows, h] only in a recompute call, as its forward's skip sum.
// acts [rows, h] is bf16, and so are a recompute's residuals (two
// elements a float).
struct BwdScratch {
  float *g_rs = nullptr, *dia = nullptr, *dxin = nullptr, *dxin_t = nullptr, *acts = nullptr;
  float *wg = nullptr, *splits = nullptr;
  long ldt = 0, wg_floats = 0, split_floats = 0;
  float *dout = nullptr, *dzp = nullptr, *gx = nullptr;
  float *xs = nullptr, *th = nullptr, *sg = nullptr, *zp = nullptr, *skipm = nullptr;
  float *g_rs16 = nullptr, *dxin16 = nullptr, *dout16 = nullptr, *dzp16 = nullptr,
        *gx16 = nullptr;
  float *xin_sums = nullptr, *g_sums = nullptr, *rs_sums = nullptr, *skip_sums = nullptr,
        *dout_sums = nullptr, *dzp_sums = nullptr;
};

// c 0: the WN stack alone.
long bwd_scratch(float* base, int batch, int t, int c, int h, int n_layers, int taps,
                 bool recompute, bool with_g, BwdScratch* s, bool bf16 = false) {
  const long rows = (long)batch * t;
  const long h2 = 2L * h, c2 = c / 2, L = n_layers;
  long used = 0;
  auto take = [&](float*& p, long floats) {
    p = base ? base + used : nullptr;
    used += round4(floats);
  };
  // a bf16 call's residuals: two elements a float
  auto res = [&](long elems) { return bf16 ? (elems + 1) / 2 : elems; };
  s->ldt = round4(rows);
  // the splits, product by product as presplit_weights lays them out
  long splits = L * (round4(2 * h2 * h) + round4(2 * taps * h2 * h));
  if (recompute) splits += L * (round4(2 * taps * h * h2) + round4(2 * h * h2));
  if (c > 0) {
    splits += round4(2 * h * c2) + round4(2L * c * h) + round4(2 * h * c2) + round4(2L * c * c);
    if (recompute) splits += round4(2 * c2 * h);
  }
  // bf16: no weight splits, and dW_in reads d_xin as it lies
  s->split_floats = bf16 ? 0 : splits;
  s->wg_floats = std::max(1L << 22, 2L * (taps * h + 1) * h2);
  if (!bf16) {
    take(s->g_rs, rows * h2);
    if (with_g) take(s->dia, rows * h2);
    take(s->dxin, rows * h2);
    take(s->dxin_t, 2 * h2 * s->ldt);
  } else if (recompute) {
    take(s->g_rs, rows * h);  // the forward's skip sum
  }
  take(s->acts, rows * h);
  take(s->wg, s->wg_floats);
  take(s->splits, s->split_floats);
  if (c > 0 && !bf16) {
    take(s->dout, rows * c);
    take(s->dzp, rows * c);
  }
  if (c > 0 || bf16) take(s->gx, rows * h);
  if (bf16) {  // bf16 copies: two elements a float
    take(s->g_rs16, rows * h);
    take(s->dxin16, rows * h);
    if (c > 0) {
      take(s->dout16, rows * c2);
      take(s->dzp16, rows * c2);
      take(s->gx16, (rows * h + 1) / 2);
    }
    // the tile sums
    const long tiles = (long)batch * ((t + kSumTileRows - 1) / kSumTileRows);
    take(s->xin_sums, tiles * h2);
    if (with_g) take(s->g_sums, tiles * h2);
    take(s->rs_sums, tiles * h);
    take(s->skip_sums, tiles * h);
    if (c > 0) {
      take(s->dout_sums, tiles * c);
      take(s->dzp_sums, tiles * c);
    }
  }
  if (recompute) {
    take(s->xs, res(L * rows * h));
    take(s->th, res(L * rows * h));
    take(s->sg, res(L * rows * h));
    if (c > 0) {
      take(s->zp, res(rows * c));
      take(s->skipm, res(rows * h));
    }
  }
  return used;
}

// Operands of the WN reverse walk (wn_pallas._reverse_walk): the forward's
// weights and residuals, the stack-input cotangent gx [rows, h] (on return
// g_x * mask + dx_conv of layer 0, not masked again) and the gradients.
struct WnWalk {
  const float *mask, *w_in, *w_rs, *xs, *th, *sg;
  float* gx;
  float *dwin, *dbin, *dwrs, *dbrs, *dg;  // dg null: unconditioned
  // the WN stack alone in bf16: dx [rows, h] bf16, gx rounded by the last
  // transposed conv's epilogue
  float* dx16 = nullptr;
};

// The walk's products, by layer: the gate backward and the transposed conv
// (conv-GEMMs, their weights split by the call's presplit_weights) and the
// two weight gradients with their bias rows.
struct WalkProducts {
  std::vector<ConvGemm> gate, tconv;
  std::vector<WGrad> drs, din;
};

cudaError_t walk_products(const Dims& d, const WnWalk& w, const BwdScratch& s, WalkProducts* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int batch = d.batch, t = d.t, h = d.h, taps = d.taps, h2 = 2 * h;
  const long rh = (long)batch * t * h;
  const bool bf = d.bf16 != 0;
  int dilation = 1;
  for (int l = 0; l < d.n_layers; ++l) {
    {  // da = g_rs @ W_rs^T, the gate backward in the epilogue
      ConvGemm g = rows_gemm(d, bf ? s.g_rs16 : s.g_rs, h2, h2,
                             elem_at(w.w_rs, (long)l * h * h2, bf), nullptr, h, kGateBwd,
                             w.dg ? s.dia : nullptr, h2, nullptr);
      g.w_t = 1;
      g.split = h; g.aux = elem_at(w.th, l * rh, bf); g.aux2 = elem_at(w.sg, l * rh, bf);
      g.ld_aux = h;
      g.out2 = s.dxin; g.ldo2 = h2; g.out3 = s.acts; g.ldo3 = h;
      g.drop = d.drop.at(l);
      g.bf16 = b16(d, kA16 | kW16 | kAux16 | kAux2_16 | kOut3_16);
      g.out2_c = s.dxin16; g.tma_ring = bf;
      if (bf) {  // d_xin's and d_in_act's sums, for db_in and dg
        g.sums = {s.xin_sums, h2};
        if (w.dg) g.sums2 = {s.g_sums, h2};
      }
      p->gate.push_back(g);
    }
    {  // gx = gx * mask + transposed conv of d_xin; g_rs[:, :h] = gx * mask
      ConvGemm g = rows_gemm(d, bf ? s.dxin16 : s.dxin, h2, h2,
                             elem_at(w.w_in, (long)l * taps * h * h2, bf), nullptr, h, kAccumMask,
                             w.gx, h, w.mask);
      g.w_t = 1; g.taps = taps; g.dilation = dilation; g.tap_sign = -1; g.tap_staged = 1;
      g.out2 = s.g_rs; g.ldo2 = h2;
      g.bf16 = b16(d, kA16 | kW16);
      g.tma_ring = bf;
      if (bf && l == 0 && s.gx16) {  // the block's d_pre = gx * mask, for dW_s and dzp
        g.out2 = s.gx16; g.ldo2 = h; g.bf16 |= kOut2_16;
        g.sums = {s.rs_sums, h};
      } else if (bf && l > 0) {  // the next layer's g_rs res half: its copy and sums
        g.out2 = nullptr; g.out2_c = s.g_rs16;
        g.sums = {s.rs_sums, h};
      } else if (bf) {  // the WN stack's layer 0: no next layer
        g.out2 = nullptr;
      }
      if (bf && l == 0) g.out_c = w.dx16;
      p->tconv.push_back(g);
    }
    WGrad rs = wgrad_of(s.acts, h, h, batch, t, s.g_rs, h2, h2,
                        elem_at(w.dwrs, (long)l * h * h2, bf), s.wg, s.wg_floats);
    rs.bias_out = w.dbrs + l * h2;
    rs.bf16 = b16(d, kA16 | kOut16);
    rs.dy16 = s.g_rs16; rs.tma_ring = bf;
    if (bf) {  // db_rs: the res half's sums (none at the last layer: zero), the skip half's
      rs.dy = nullptr;
      if (l < d.n_layers - 1) rs.bias_lo = {s.rs_sums, h};
      rs.bias_hi = {s.skip_sums, h};
      rs.bias_split = h;
    }
    p->drs.push_back(rs);
    WGrad in = wgrad_of(elem_at(w.xs, l * rh, bf), h, h, batch, t, s.dxin, h2, h2,
                        elem_at(w.dwin, (long)l * taps * h * h2, bf), s.wg, s.wg_floats);
    in.taps = taps; in.dilation = dilation; in.bias_out = w.dbin + l * h2;
    in.bf16 = b16(d, kA16 | kOut16);
    in.dy16 = s.dxin16; in.tma_ring = bf;
    if (bf) {  // db_in from d_xin's sums; dg from d_in_act's, per sample
      in.bias_lo = {s.xin_sums, h2};
      in.bias_split = h2;
      if (w.dg) {
        in.g_sums = {s.g_sums, h2};
        in.dg = elem_at(w.dg, (long)l * h2, true);
        in.dg_ld = (long)d.n_layers * h2;
      }
    }
    p->din.push_back(in);
    dilation *= d.dilation_rate;
  }
  if (bf) return cudaSuccess;  // no K-major split of d_xin: dW_in reads it as it lies
  // dW_in from d_xin's K-major split where the gate backward that writes it
  // and dW_in both take the tensor cores: at [960, 11264, 384] 123 us on
  // the device against 162 reading d_xin raw (scripts/torch-wn-walk-sweep.py,
  // PERF.md)
  for (int l = 0; l < d.n_layers; ++l) {
    ConvGemm g = p->gate[l];
    g.out4 = s.dxin_t; g.ldo4 = s.ldt;
    WGrad in = p->din[l];
    in.dy_t = s.dxin_t; in.ldt = s.ldt;
    if (conv_gemm_tc_fits(g, sms) && wgrad_tc_fits(in)) {
      p->gate[l] = g;
      p->din[l] = in;
    }
  }
  return cudaSuccess;
}

int wn_reverse_walk(const Dims& d, const WnWalk& w, const BwdScratch& s, const WalkProducts& p,
                    cudaStream_t stream) {
  const int h2 = 2 * d.h;
  for (int l = d.n_layers - 1; l >= 0; --l) {
    GTT_TRY(conv_gemm(p.gate[l], stream));
    GTT_TRY(wgrad(p.drs[l], stream));
    if (w.dg && !d.bf16)  // bf16: in dW_in's reduction
      GTT_TRY(col_sum(s.dia, h2, h2, nullptr, d.batch, d.t, elem_at(w.dg, (long)l * h2, false),
                      d.n_layers * h2, stream));
    GTT_TRY(wgrad(p.din[l], stream));
    GTT_TRY(conv_gemm(p.tconv[l], stream));
  }
  return (int)cudaGetLastError();
}

// g_rs16 [rows, 2h] = [0 | dout * mask], g_rs's bf16 copy, from the bf16
// cotangent dout [rows, h] of the WN stack's masked output (JAX's
// ``dout.astype(f32)`` after the caller's ``* x_mask``, and the walk's
// ``g_rs.astype(bf16)``), and the tile sums of its skip half in f32
// (sums [batch, tiles, h], for every layer's db_rs): a block a 64-row tile
// of one sample, a thread a pair of columns walking the tile's rows.
__global__ void walk_cotangent_kernel(const __nv_bfloat162* dout, const float* mask,
                                      __nv_bfloat162* g_rs16, float2* sums, int t, int h) {
  const int tiles = (t + kSumTileRows - 1) / kSumTileRows;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * kSumTileRows;
  const int t1 = min(t, t0 + kSumTileRows);
  const int half = h / 2;  // dout's pairs a row; [0 | dout] has h
  for (int j = threadIdx.x; j < h; j += blockDim.x) {  // columns 2j, 2j + 1 of [0 | dout]
    float2 sum = make_float2(0.f, 0.f);
    for (int tt = t0; tt < t1; ++tt) {
      const long r = (long)b * t + tt;
      const __nv_bfloat162 v = j < half || mask[r] == 0.f ? __float2bfloat162_rn(0.f)
                                                          : dout[r * half + j - half];
      g_rs16[r * h + j] = v;
      const float2 f = __bfloat1622float2(v);
      sum.x += f.x;
      sum.y += f.y;
    }
    if (j >= half) sums[(long)blockIdx.x * half + j - half] = sum;
  }
}

// The WN stack's backward from per-layer residuals: dout [rows, h] is the
// skip sum's cotangent into g_rs's skip half (bf16: the masked output's
// bf16 cotangent, masked into g_rs's copy, its sums kept); w.gx the
// returned dx (bf16: rounded into w.dx16 by the walk).
int wn_bwd_chain(const Dims& d, const WnWalk& w, const BwdScratch& s, const WalkProducts& p,
                 const float* dout, cudaStream_t stream) {
  const int rows = d.batch * d.t;
  const int h = d.h;
  if (d.bf16) {  // h is even
    const int tiles = (d.t + kSumTileRows - 1) / kSumTileRows;
    walk_cotangent_kernel<<<(unsigned)(d.batch * tiles), 128, 0, stream>>>(
        reinterpret_cast<const __nv_bfloat162*>(dout), w.mask,
        reinterpret_cast<__nv_bfloat162*>(s.g_rs16), reinterpret_cast<float2*>(s.skip_sums),
        d.t, h);
    GTT_TRY(cudaGetLastError());
    GTT_TRY(cudaMemsetAsync(w.gx, 0, sizeof(float) * rows * h, stream));
    return wn_reverse_walk(d, w, s, p, stream);
  }
  GTT_TRY(cudaMemsetAsync(s.g_rs, 0, sizeof(float) * rows * 2 * h, stream));
  GTT_TRY(cudaMemsetAsync(w.gx, 0, sizeof(float) * rows * h, stream));
  GTT_TRY(cudaMemcpy2DAsync(s.g_rs + h, sizeof(float) * 2 * h, dout, sizeof(float) * h,
                            sizeof(float) * h, rows, cudaMemcpyDeviceToDevice, stream));
  return wn_reverse_walk(d, w, s, p, stream);
}

// The block backward's products around the walk (block_pallas.
// _block_bwd_math): the coupling's logs rebuilt from skipm and its
// backward, dskip = (dout @ W_e^T) * mask, dzp's first half = (dz0 + d_pre @
// W_s^T) * mask with d_pre = gx * mask, dx = dzp @ A^T; the weight
// gradients dW_e, dW_s (dY = gx, masked) and dA, each with its bias row.
struct BlockBwdProducts {
  ConvGemm coupling, dskip, dzp, dx;
  WGrad dwe, dws, da;
  WalkProducts walk;
};

struct BlockBwdArgs {
  const float *x, *a, *w_s, *w_e, *b_e, *zp, *skipm, *dz, *dld;
  int sigmoid_scale;
  float *dx, *da, *dba, *dws, *dbs, *dwe, *dbe;
};

cudaError_t block_bwd_products(const Dims& d, const WnWalk& w, const BwdScratch& s,
                               const BlockBwdArgs& b, BlockBwdProducts* p) {
  const int batch = d.batch, t = d.t, c = d.c, h = d.h;
  const int c2 = c / 2, h2 = 2 * h;
  const float* mask = w.mask;
  const bool bf = d.bf16 != 0;
  // bf16: dout, the skip half of g_rs and dzp written only as their bf16
  // copies, their f32 values summed (s.dout etc. are null)
  {
    ConvGemm& g = p->coupling = rows_gemm(d, b.skipm, h, h, elem_at(b.w_e, c2, bf), b.b_e + c2,
                                          c2, kCouplingBwd, s.dout, c, mask);
    g.ldb = c; g.split = c2; g.flag = b.sigmoid_scale;
    g.aux = b.dz; g.ld_aux = c; g.aux2 = b.zp; g.aux3 = b.dld; g.out2 = s.dzp; g.ldo2 = c;
    g.bf16 = b16(d, kA16 | kW16 | kAux16 | kAux2_16);
    g.out_c = s.dout16; g.out2_c = s.dzp16;
    if (bf) {
      g.sums = {s.dout_sums, c};
      g.sums2 = {s.dzp_sums, c};
    }
  }
  {  // -> the skip half of g_rs (bf16: rounded, as the walk takes it)
    ConvGemm& g = p->dskip = rows_gemm(d, bf ? s.dout16 : s.dout, c, c, b.w_e, nullptr, h,
                                       kBiasMask, bf ? nullptr : s.g_rs + h, h2, mask);
    g.w_t = 1;
    g.bf16 = b16(d, kA16 | kW16 | kRoundOut);
    g.out_c = elem_at(s.g_rs16, h, true);
    if (bf) g.sums = {s.skip_sums, h};
  }
  {  // dzp[:, :c2] = (dz0 + d_pre @ W_s^T) * mask (bf16: d_pre's masked copy)
    ConvGemm& g =
        p->dzp = rows_gemm(d, bf ? s.gx16 : s.gx, h, h, b.w_s, nullptr, c2, kResidMask, s.dzp, c,
                           mask);
    g.w_t = 1; g.a_mask = bf ? nullptr : mask; g.aux = b.dz; g.ld_aux = c;
    g.bf16 = b16(d, kA16 | kW16 | kAux16);
    g.out_c = s.dzp16;
    if (bf) g.sums = {s.dzp_sums, c};
  }
  {
    ConvGemm& g = p->dx =
        rows_gemm(d, bf ? s.dzp16 : s.dzp, c, c, b.a, nullptr, c, kBias, b.dx, c, nullptr);
    g.w_t = 1;
    g.bf16 = b16(d, kA16 | kW16 | kOut16);
  }
  p->dwe = wgrad_of(b.skipm, h, h, batch, t, s.dout, c, c, b.dwe, s.wg, s.wg_floats);
  p->dwe.bias_out = b.dbe;
  p->dwe.dy16 = s.dout16;
  p->dws = wgrad_of(b.zp, c, c2, batch, t, s.gx, h, h, b.dws, s.wg, s.wg_floats);
  p->dws.dy_mask = mask; p->dws.bias_out = b.dbs;
  p->dws.dy16 = s.gx16;
  p->da = wgrad_of(b.x, c, c, batch, t, s.dzp, c, c, b.da, s.wg, s.wg_floats);
  p->da.bias_out = b.dba;
  p->da.dy16 = s.dzp16;
  p->dwe.bf16 = p->dws.bf16 = p->da.bf16 = b16(d, kA16 | kOut16);
  for (ConvGemm* g : {&p->coupling, &p->dskip, &p->dzp, &p->dx}) g->tma_ring = bf;
  for (WGrad* g : {&p->dwe, &p->dws, &p->da}) g->tma_ring = bf;
  if (bf) {  // the bias gradients from dout's, gx * mask's (layer 0) and dzp's sums
    p->dwe.bias_lo = {s.dout_sums, c};
    p->dws.bias_lo = {s.rs_sums, h};
    p->da.bias_lo = {s.dzp_sums, c};
    p->dwe.bias_split = p->da.bias_split = c;
    p->dws.bias_split = h;
    p->dwe.dy = p->dws.dy = p->da.dy = nullptr;
  }
  return walk_products(d, w, s, &p->walk);
}

// The conv-GEMMs of a block backward in launch order, for presplit_weights.
void block_bwd_split_list(BlockBwdProducts* p, std::vector<ConvGemm*>* list) {
  list->push_back(&p->coupling);
  list->push_back(&p->dskip);
  add_products(list, &p->walk.gate);
  add_products(list, &p->walk.tconv);
  list->push_back(&p->dzp);
  list->push_back(&p->dx);
}

int block_bwd_chain(const Dims& d, const WnWalk& w, const BwdScratch& s,
                    const BlockBwdProducts& p, cudaStream_t stream) {
  const int rows = d.batch * d.t;
  // the last layer's res half reads zero (bf16: its copy's)
  if (d.bf16) GTT_TRY(cudaMemsetAsync(s.g_rs16, 0, 2L * rows * 2 * d.h, stream));
  else GTT_TRY(cudaMemsetAsync(s.g_rs, 0, sizeof(float) * rows * 2 * d.h, stream));
  GTT_TRY(cudaMemsetAsync(s.gx, 0, sizeof(float) * rows * d.h, stream));
  GTT_TRY(conv_gemm(p.coupling, stream));
  GTT_TRY(wgrad(p.dwe, stream));
  GTT_TRY(conv_gemm(p.dskip, stream));
  {
    const int err = wn_reverse_walk(d, w, s, p.walk, stream);
    if (err != 0) return err;
  }
  GTT_TRY(wgrad(p.dws, stream));
  GTT_TRY(conv_gemm(p.dzp, stream));
  GTT_TRY(wgrad(p.da, stream));
  GTT_TRY(conv_gemm(p.dx, stream));
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// the WN stack alone (the unfused decoder)
// ---------------------------------------------------------------------------

namespace {

// The WN stack's forward: its products' weights split in one launch, the
// input copied into the layers' state (x, or xs's slice 0), the products.
// bf16 (out16 set): skip is the f32 sum and the last layer writes out16 =
// bf16(skip) * mask, the stack's output.
int wn_fwd_chain(const Dims& d, const WnWeights& wn, const float* x, const float* mask,
                 float* state, float* th, float* sg, float* acts, float* skip, float* out16,
                 cudaStream_t stream) {
  WnLayers layers = wn_stack(d, wn, mask, state, th, sg, acts, skip, out16 != nullptr);
  layers.skipm = out16;
  std::vector<ConvGemm> fwd;
  wn_products(layers, &fwd);
  std::vector<ConvGemm*> list;
  add_products(&list, &fwd);
  GTT_TRY(presplit_weights(list.data(), (int)list.size(), d.tc_scratch, d.tc_scratch_floats,
                           stream));
  const long rh = (long)d.batch * d.t * d.h;
  GTT_TRY(cudaMemcpyAsync(state, x, (d.bf16 ? 2 : 4) * rh, cudaMemcpyDeviceToDevice, stream));
  {
    const int err = run_products(fwd, stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Whether the bf16 chains' folded A runs on the CUDA cores (on 1) or on the
// TMA-fed wgmma kernel (on 0, the default), for a measurement of both in
// one run.  Returns the previous setting.
extern "C" int gtt_bf16_core_zp(int on) {
  const int was = core_zp() ? 1 : 0;
  core_zp() = on != 0;
  return was;
}

// Floats of the one scratch block a forward call of the WN stack (c 0) or
// of the flow block (c channels) takes: its products' K-major splits.
extern "C" long long gtt_wn_fwd_scratch_floats(int h, int n_layers, int taps) {
  return fwd_split_floats(0, h, n_layers, taps);
}

extern "C" long long gtt_block_fwd_scratch_floats(int c, int h, int n_layers, int taps) {
  return fwd_split_floats(c, h, n_layers, taps);
}

// Scratch: one block of gtt_wn_fwd_scratch_floats.
extern "C" int gtt_wn_forward(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, float* skip,
    float* xcur, float* acts, float* scratch, long long scratch_floats,
    int g_stride, int batch, int t, int h,
    int n_layers, int taps, int dilation_rate, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  const long need = fwd_split_floats(0, h, n_layers, taps);
  if (need > scratch_floats) return (int)cudaErrorInvalidValue;
  const Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale), scratch, need};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  return wn_fwd_chain(d, wn, x, mask, xcur, nullptr, nullptr, acts, skip, nullptr, stream);
}

extern "C" int gtt_wn_fwd_save(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, float* skip,
    float* xs, float* th, float* sg, float* acts, float* scratch, long long scratch_floats,
    int g_stride, int batch,
    int t, int h, int n_layers, int taps, int dilation_rate, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  const long need = fwd_split_floats(0, h, n_layers, taps);
  if (need > scratch_floats) return (int)cudaErrorInvalidValue;
  const Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale), scratch, need};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  return wn_fwd_chain(d, wn, x, mask, xs, th, sg, acts, skip, nullptr, stream);
}

// Floats of the one scratch block a call of the WN stack's backward
// (recompute 0: from saves, 1: recomputing the forward) carves its buffers
// from; with_g: the model is conditioned (dg).
extern "C" long long gtt_wn_bwd_scratch_floats(int batch, int t, int h, int n_layers, int taps,
                                               int recompute, int with_g) {
  BwdScratch s;
  return bwd_scratch(nullptr, batch, t, 0, h, n_layers, taps, recompute, with_g, &s);
}

extern "C" long long gtt_block_bwd_scratch_floats(int batch, int t, int c, int h, int n_layers,
                                                  int taps, int recompute, int with_g) {
  BwdScratch s;
  return bwd_scratch(nullptr, batch, t, c, h, n_layers, taps, recompute, with_g, &s);
}

// W_in [L, taps * h, 2h] and W_rs [L, h, 2h] as the forward reads them.
// Scratch: one block of gtt_wn_bwd_scratch_floats(..., 0, dg != null).
extern "C" int gtt_wn_bwd_store(
    const float* mask, const float* w_in, const float* w_rs, const float* xs,
    const float* th, const float* sg, const float* dout, float* dx, float* dwin,
    float* dbin, float* dwrs, float* dbrs, float* dg, float* scratch, long long scratch_floats,
    int batch, int t, int h, int n_layers, int taps, int dilation_rate, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  BwdScratch s;
  if (bwd_scratch(scratch, batch, t, 0, h, n_layers, taps, false, dg != nullptr, &s) >
      scratch_floats)
    return (int)cudaErrorInvalidValue;
  const Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale), s.wg, s.wg_floats};
  const WnWalk w{mask, w_in, w_rs, xs, th, sg, dx, dwin, dbin, dwrs, dbrs, dg};
  WalkProducts p;
  GTT_TRY(walk_products(d, w, s, &p));
  std::vector<ConvGemm*> list;
  add_products(&list, &p.gate);
  add_products(&list, &p.tconv);
  GTT_TRY(presplit_weights(list.data(), (int)list.size(), s.splits, s.split_floats, stream));
  return wn_bwd_chain(d, w, s, p, dout, stream);
}

// Recompute: the forward-save chain into scratch (xs / th / sg), then the
// same walk; all their products' weights split in one launch first.  The
// TPU kernel also keeps the keep masks in scratch; here they are replayed
// from the seed.  g_rs serves as the recompute's skip sum.  Scratch: one
// block of gtt_wn_bwd_scratch_floats(..., 1, dg != null).
extern "C" int gtt_wn_bwd(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, const float* dout, float* dx,
    float* dwin, float* dbin, float* dwrs, float* dbrs, float* dg, float* scratch,
    long long scratch_floats, int g_stride, int batch, int t, int h, int n_layers, int taps,
    int dilation_rate, int drop, int seed, unsigned threshold, float scale, cudaStream_t stream) {
  BwdScratch s;
  if (bwd_scratch(scratch, batch, t, 0, h, n_layers, taps, true, dg != nullptr, &s) >
      scratch_floats)
    return (int)cudaErrorInvalidValue;
  const Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale), s.wg, s.wg_floats};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  std::vector<ConvGemm> fwd;
  wn_products(wn_stack(d, wn, mask, s.xs, s.th, s.sg, s.acts, s.g_rs, 0), &fwd);
  const WnWalk w{mask, w_in, w_rs, s.xs, s.th, s.sg, dx, dwin, dbin, dwrs, dbrs, dg};
  WalkProducts p;
  GTT_TRY(walk_products(d, w, s, &p));
  std::vector<ConvGemm*> list;
  add_products(&list, &fwd);
  add_products(&list, &p.gate);
  add_products(&list, &p.tconv);
  GTT_TRY(presplit_weights(list.data(), (int)list.size(), s.splits, s.split_floats, stream));
  const long rh = (long)batch * t * h;
  GTT_TRY(cudaMemcpyAsync(s.xs, x, sizeof(float) * rh, cudaMemcpyDeviceToDevice, stream));
  {
    const int err = run_products(fwd, stream);
    if (err != 0) return err;
  }
  return wn_bwd_chain(d, w, s, p, dout, stream);
}

// ---------------------------------------------------------------------------
// the fused flow block
// ---------------------------------------------------------------------------

extern "C" int gtt_block_fwd(
    const float* x, const float* mask, const float* a, const float* ba,
    const float* w_s, const float* b_s, const float* w_e, const float* b_e,
    const float* w_in, const float* b_in, const float* w_rs, const float* b_rs,
    const float* g_all, float* z, float* ld, float* skipm, float* xcur,
    float* acts, float* logsm, float* ld_part, float* scratch, long long scratch_floats,
    int g_stride, int batch, int t,
    int c, int h, int n_layers, int taps, int dilation_rate, int sigmoid_scale,
    int drop, int seed, unsigned threshold, float scale, cudaStream_t stream) {
  const long need = fwd_split_floats(c, h, n_layers, taps);
  if (need > scratch_floats) return (int)cudaErrorInvalidValue;
  const Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale), scratch, need};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  // zp is written into z: its first half is z's, the coupling rewrites the second
  return block_fwd_chain(d, x, mask, a, ba, w_s, b_s, w_e, b_e, wn, sigmoid_scale, z, ld,
                         z, skipm, xcur, nullptr, nullptr, acts, logsm, ld_part, stream);
}

extern "C" int gtt_block_fwd_save(
    const float* x, const float* mask, const float* a, const float* ba,
    const float* w_s, const float* b_s, const float* w_e, const float* b_e,
    const float* w_in, const float* b_in, const float* w_rs, const float* b_rs,
    const float* g_all, float* z, float* ld, float* zp, float* skipm, float* xs,
    float* th, float* sg, float* acts, float* logsm, float* ld_part,
    float* scratch, long long scratch_floats,
    int g_stride, int batch, int t, int c, int h, int n_layers, int taps,
    int dilation_rate, int sigmoid_scale, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  const long need = fwd_split_floats(c, h, n_layers, taps);
  if (need > scratch_floats) return (int)cudaErrorInvalidValue;
  const Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale), scratch, need};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  return block_fwd_chain(d, x, mask, a, ba, w_s, b_s, w_e, b_e, wn, sigmoid_scale, z, ld,
                         zp, skipm, xs, th, sg, acts, logsm, ld_part, stream);
}

// The forward's weights as it reads them (A, W_s, W_e, W_in, W_rs).
// Scratch: one block of gtt_block_bwd_scratch_floats(..., 0, dg != null).
extern "C" int gtt_block_bwd_store(
    const float* x, const float* mask, const float* a, const float* w_s, const float* w_e,
    const float* b_e, const float* w_in, const float* w_rs, const float* zp,
    const float* skipm, const float* xs, const float* th, const float* sg,
    const float* dz, const float* dld, float* dx, float* da, float* dba,
    float* dws, float* dbs, float* dwe, float* dbe, float* dwin, float* dbin,
    float* dwrs, float* dbrs, float* dg, float* scratch, long long scratch_floats,
    int batch, int t, int c, int h, int n_layers, int taps, int dilation_rate,
    int sigmoid_scale, int drop, int seed, unsigned threshold, float scale,
    cudaStream_t stream) {
  BwdScratch s;
  if (bwd_scratch(scratch, batch, t, c, h, n_layers, taps, false, dg != nullptr, &s) >
      scratch_floats)
    return (int)cudaErrorInvalidValue;
  const Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale), s.wg, s.wg_floats};
  const WnWalk w{mask, w_in, w_rs, xs, th, sg, s.gx, dwin, dbin, dwrs, dbrs, dg};
  const BlockBwdArgs b{x, a, w_s, w_e, b_e, zp, skipm, dz, dld, sigmoid_scale,
                       dx, da, dba, dws, dbs, dwe, dbe};
  BlockBwdProducts p;
  GTT_TRY(block_bwd_products(d, w, s, b, &p));
  std::vector<ConvGemm*> list;
  block_bwd_split_list(&p, &list);
  GTT_TRY(presplit_weights(list.data(), (int)list.size(), s.splits, s.split_floats, stream));
  return block_bwd_chain(d, w, s, p, stream);
}

// Recompute: the forward-save chain into scratch (zp, skipm, xs / th / sg;
// no z, no ld), then the store backward's chain on it; the products of
// both split in one launch first.  Scratch: one block of
// gtt_block_bwd_scratch_floats(..., 1, dg != null).
extern "C" int gtt_block_bwd(
    const float* x, const float* mask, const float* a, const float* ba,
    const float* w_s, const float* b_s, const float* w_e, const float* b_e,
    const float* w_in, const float* b_in, const float* w_rs, const float* b_rs,
    const float* g_all, const float* dz, const float* dld,
    float* dx, float* da, float* dba, float* dws, float* dbs, float* dwe,
    float* dbe, float* dwin, float* dbin, float* dwrs, float* dbrs, float* dg,
    float* scratch, long long scratch_floats, int g_stride,
    int batch, int t, int c, int h, int n_layers, int taps, int dilation_rate,
    int sigmoid_scale, int drop, int seed, unsigned threshold, float scale,
    cudaStream_t stream) {
  BwdScratch s;
  if (bwd_scratch(scratch, batch, t, c, h, n_layers, taps, true, dg != nullptr, &s) >
      scratch_floats)
    return (int)cudaErrorInvalidValue;
  const Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale), s.wg, s.wg_floats};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  std::vector<ConvGemm> fwd;
  block_fwd_products(d, x, mask, a, ba, w_s, b_s, wn, s.zp, s.skipm, s.xs, s.th, s.sg, s.acts,
                     &fwd);
  const WnWalk w{mask, w_in, w_rs, s.xs, s.th, s.sg, s.gx, dwin, dbin, dwrs, dbrs, dg};
  const BlockBwdArgs b{x, a, w_s, w_e, b_e, s.zp, s.skipm, dz, dld, sigmoid_scale,
                       dx, da, dba, dws, dbs, dwe, dbe};
  BlockBwdProducts p;
  GTT_TRY(block_bwd_products(d, w, s, b, &p));
  std::vector<ConvGemm*> list;
  add_products(&list, &fwd);
  block_bwd_split_list(&p, &list);
  GTT_TRY(presplit_weights(list.data(), (int)list.size(), s.splits, s.split_floats, stream));
  {
    const int err = run_products(fwd, stream);
    if (err != 0) return err;
  }
  return block_bwd_chain(d, w, s, p, stream);
}

// ---------------------------------------------------------------------------
// the fused flow block in bf16 (fp16_run): the same chains, bf16 at the
// entry points (block_pallas with dtype bf16)
// ---------------------------------------------------------------------------

// x, z, zp, skipm, xs / th / sg, g_all and A, W_s, W_e, W_in, W_rs bf16,
// and the buffer acts [rows, h] (the gate product); the biases, mask, ld and
// the f32 buffers skip [rows, h] (the skip sum), logsm [rows, c / 2],
// ld_part [batch, c / 2]: no scratch (the products read their weights as
// they lie).
extern "C" int gtt_block_fwd_save_bf16(
    const float* x, const float* mask, const float* a, const float* ba,
    const float* w_s, const float* b_s, const float* w_e, const float* b_e,
    const float* w_in, const float* b_in, const float* w_rs, const float* b_rs,
    const float* g_all, float* z, float* ld, float* zp, float* skipm, float* xs,
    float* th, float* sg, float* acts, float* skip, float* logsm, float* ld_part,
    int g_stride, int batch, int t, int c, int h, int n_layers, int taps,
    int dilation_rate, int sigmoid_scale, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
         make_dropout(drop, seed, n_layers, threshold, scale), nullptr, 0};
  d.bf16 = 1;
  d.skip = skip;
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  return block_fwd_chain(d, x, mask, a, ba, w_s, b_s, w_e, b_e, wn, sigmoid_scale, z, ld,
                         zp, skipm, xs, th, sg, acts, logsm, ld_part, stream);
}

// Forward without saves (block_pallas._block_fwd_kernel, bf16 row 9): the
// forward-save chain's products with xcur [rows, h] the WN state and z
// holding zp; skipm [rows, h] bf16, skip [rows, h] f32.  Its z and ld are
// gtt_block_fwd_save_bf16's bit for bit.
extern "C" int gtt_block_fwd_bf16(
    const float* x, const float* mask, const float* a, const float* ba,
    const float* w_s, const float* b_s, const float* w_e, const float* b_e,
    const float* w_in, const float* b_in, const float* w_rs, const float* b_rs,
    const float* g_all, float* z, float* ld, float* skipm, float* xcur,
    float* acts, float* skip, float* logsm, float* ld_part,
    int g_stride, int batch, int t, int c, int h, int n_layers, int taps,
    int dilation_rate, int sigmoid_scale, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
         make_dropout(drop, seed, n_layers, threshold, scale), nullptr, 0};
  d.bf16 = 1;
  d.skip = skip;
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  return block_fwd_chain(d, x, mask, a, ba, w_s, b_s, w_e, b_e, wn, sigmoid_scale, z, ld,
                         z, skipm, xcur, nullptr, nullptr, acts, logsm, ld_part, stream);
}

// x, zp, skipm, xs / th / sg, dz, dx, the five weights and their gradients
// and dg bf16; the bias gradients, dld f32.  Scratch: one block of
// gtt_block_bwd_bf16_scratch_floats(..., recompute, dg != null).
extern "C" long long gtt_block_bwd_bf16_scratch_floats(int batch, int t, int c, int h,
                                                       int n_layers, int taps, int recompute,
                                                       int with_g) {
  BwdScratch s;
  return bwd_scratch(nullptr, batch, t, c, h, n_layers, taps, recompute, with_g, &s, true);
}

extern "C" int gtt_block_bwd_store_bf16(
    const float* x, const float* mask, const float* a, const float* w_s, const float* w_e,
    const float* b_e, const float* w_in, const float* w_rs, const float* zp,
    const float* skipm, const float* xs, const float* th, const float* sg,
    const float* dz, const float* dld, float* dx, float* da, float* dba,
    float* dws, float* dbs, float* dwe, float* dbe, float* dwin, float* dbin,
    float* dwrs, float* dbrs, float* dg, float* scratch, long long scratch_floats,
    int batch, int t, int c, int h, int n_layers, int taps, int dilation_rate,
    int sigmoid_scale, int drop, int seed, unsigned threshold, float scale,
    cudaStream_t stream) {
  BwdScratch s;
  if (bwd_scratch(scratch, batch, t, c, h, n_layers, taps, false, dg != nullptr, &s, true) >
      scratch_floats)
    return (int)cudaErrorInvalidValue;
  Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
         make_dropout(drop, seed, n_layers, threshold, scale), s.wg, s.wg_floats};
  d.bf16 = 1;
  const WnWalk w{mask, w_in, w_rs, xs, th, sg, s.gx, dwin, dbin, dwrs, dbrs, dg};
  const BlockBwdArgs b{x, a, w_s, w_e, b_e, zp, skipm, dz, dld, sigmoid_scale,
                       dx, da, dba, dws, dbs, dwe, dbe};
  BlockBwdProducts p;
  GTT_TRY(block_bwd_products(d, w, s, b, &p));
  return block_bwd_chain(d, w, s, p, stream);
}

// Recompute (block_pallas._block_bwd_kernel, bf16 row 11): the bf16
// forward-save chain into scratch (zp, skipm, xs / th / sg bf16; g_rs [rows,
// h] its f32 skip sum; no z, no ld), then the store backward's chain on it.
// gtt_block_bwd's arguments, bf16 as gtt_block_bwd_store_bf16's.  Scratch:
// one block of gtt_block_bwd_bf16_scratch_floats(..., 1, dg != null).
extern "C" int gtt_block_bwd_bf16(
    const float* x, const float* mask, const float* a, const float* ba,
    const float* w_s, const float* b_s, const float* w_e, const float* b_e,
    const float* w_in, const float* b_in, const float* w_rs, const float* b_rs,
    const float* g_all, const float* dz, const float* dld,
    float* dx, float* da, float* dba, float* dws, float* dbs, float* dwe,
    float* dbe, float* dwin, float* dbin, float* dwrs, float* dbrs, float* dg,
    float* scratch, long long scratch_floats, int g_stride,
    int batch, int t, int c, int h, int n_layers, int taps, int dilation_rate,
    int sigmoid_scale, int drop, int seed, unsigned threshold, float scale,
    cudaStream_t stream) {
  BwdScratch s;
  if (bwd_scratch(scratch, batch, t, c, h, n_layers, taps, true, dg != nullptr, &s, true) >
      scratch_floats)
    return (int)cudaErrorInvalidValue;
  Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
         make_dropout(drop, seed, n_layers, threshold, scale), s.wg, s.wg_floats};
  d.bf16 = 1;
  Dims fd = d;  // the forward as gtt_block_fwd_save_bf16 runs it
  fd.tc_scratch = nullptr;
  fd.tc_scratch_floats = 0;
  fd.skip = s.g_rs;
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  std::vector<ConvGemm> fwd;
  block_fwd_products(fd, x, mask, a, ba, w_s, b_s, wn, s.zp, s.skipm, s.xs, s.th, s.sg, s.acts,
                     &fwd);
  const WnWalk w{mask, w_in, w_rs, s.xs, s.th, s.sg, s.gx, dwin, dbin, dwrs, dbrs, dg};
  const BlockBwdArgs b{x, a, w_s, w_e, b_e, s.zp, s.skipm, dz, dld, sigmoid_scale,
                       dx, da, dba, dws, dbs, dwe, dbe};
  BlockBwdProducts p;
  GTT_TRY(block_bwd_products(d, w, s, b, &p));
  {
    const int err = run_products(fwd, stream);
    if (err != 0) return err;
  }
  return block_bwd_chain(d, w, s, p, stream);
}

// ---------------------------------------------------------------------------
// the WN stack alone in bf16 (the op-by-op decoder under fp16_run;
// wn_pallas with dtype bf16): x, out, xs / th / sg, g_all, W_in, W_rs, dx,
// dW_in, dW_rs and dg bf16; the biases, the mask, the bias gradients and
// the f32 buffers (skip [rows, h], the skip sum) f32; acts [rows, h] bf16
// ---------------------------------------------------------------------------

// bf16 row 5 (_fwd_kernel): out = bf16(skip sum) * mask, xcur the state.
extern "C" int gtt_wn_forward_bf16(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, float* out, float* xcur,
    float* acts, float* skip, int g_stride, int batch, int t, int h, int n_layers, int taps,
    int dilation_rate, int drop, int seed, unsigned threshold, float scale,
    cudaStream_t stream) {
  Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
         make_dropout(drop, seed, n_layers, threshold, scale), nullptr, 0};
  d.bf16 = 1;
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  return wn_fwd_chain(d, wn, x, mask, xcur, nullptr, nullptr, acts, skip, out, stream);
}

// bf16 row 6 (_fwd_save_kernel): the same, saving xs / th / sg [L, rows, h].
extern "C" int gtt_wn_fwd_save_bf16(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, float* out, float* xs,
    float* th, float* sg, float* acts, float* skip, int g_stride, int batch, int t, int h,
    int n_layers, int taps, int dilation_rate, int drop, int seed, unsigned threshold,
    float scale, cudaStream_t stream) {
  Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
         make_dropout(drop, seed, n_layers, threshold, scale), nullptr, 0};
  d.bf16 = 1;
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  return wn_fwd_chain(d, wn, x, mask, xs, th, sg, acts, skip, out, stream);
}

extern "C" long long gtt_wn_bwd_bf16_scratch_floats(int batch, int t, int h, int n_layers,
                                                    int taps, int recompute, int with_g) {
  BwdScratch s;
  return bwd_scratch(nullptr, batch, t, 0, h, n_layers, taps, recompute, with_g, &s, true);
}

// bf16 row 8 (_bwd_store_kernel): gtt_wn_bwd_store's arguments; dout the
// output's bf16 cotangent.  Scratch: one block of
// gtt_wn_bwd_bf16_scratch_floats(..., 0, dg != null).
extern "C" int gtt_wn_bwd_store_bf16(
    const float* mask, const float* w_in, const float* w_rs, const float* xs,
    const float* th, const float* sg, const float* dout, float* dx, float* dwin,
    float* dbin, float* dwrs, float* dbrs, float* dg, float* scratch, long long scratch_floats,
    int batch, int t, int h, int n_layers, int taps, int dilation_rate, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  BwdScratch s;
  if (bwd_scratch(scratch, batch, t, 0, h, n_layers, taps, false, dg != nullptr, &s, true) >
      scratch_floats)
    return (int)cudaErrorInvalidValue;
  Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
         make_dropout(drop, seed, n_layers, threshold, scale), s.wg, s.wg_floats};
  d.bf16 = 1;
  WnWalk w{mask, w_in, w_rs, xs, th, sg, s.gx, dwin, dbin, dwrs, dbrs, dg};
  w.dx16 = dx;
  WalkProducts p;
  GTT_TRY(walk_products(d, w, s, &p));
  return wn_bwd_chain(d, w, s, p, dout, stream);
}

// bf16 row 7 (_bwd_kernel): the bf16 forward-save chain into scratch (xs /
// th / sg bf16, g_rs the skip sum), then the same walk.  gtt_wn_bwd's
// arguments.  Scratch: one block of gtt_wn_bwd_bf16_scratch_floats(..., 1,
// dg != null).
extern "C" int gtt_wn_bwd_bf16(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, const float* dout, float* dx,
    float* dwin, float* dbin, float* dwrs, float* dbrs, float* dg, float* scratch,
    long long scratch_floats, int g_stride, int batch, int t, int h, int n_layers, int taps,
    int dilation_rate, int drop, int seed, unsigned threshold, float scale, cudaStream_t stream) {
  BwdScratch s;
  if (bwd_scratch(scratch, batch, t, 0, h, n_layers, taps, true, dg != nullptr, &s, true) >
      scratch_floats)
    return (int)cudaErrorInvalidValue;
  Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
         make_dropout(drop, seed, n_layers, threshold, scale), s.wg, s.wg_floats};
  d.bf16 = 1;
  Dims fd = d;  // the forward as gtt_wn_fwd_save_bf16 runs it
  fd.tc_scratch = nullptr;
  fd.tc_scratch_floats = 0;
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  std::vector<ConvGemm> fwd;
  wn_products(wn_stack(fd, wn, mask, s.xs, s.th, s.sg, s.acts, s.g_rs, 0), &fwd);
  WnWalk w{mask, w_in, w_rs, s.xs, s.th, s.sg, s.gx, dwin, dbin, dwrs, dbrs, dg};
  w.dx16 = dx;
  WalkProducts p;
  GTT_TRY(walk_products(d, w, s, &p));
  GTT_TRY(cudaMemcpyAsync(s.xs, x, 2L * batch * t * h, cudaMemcpyDeviceToDevice, stream));
  {
    const int err = run_products(fwd, stream);
    if (err != 0) return err;
  }
  return wn_bwd_chain(d, w, s, p, dout, stream);
}
