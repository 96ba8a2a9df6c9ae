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
// All eight are assemblies of three launch chains, as the TPU kernels are
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
// [rows, 2h] activations and the saved residuals reach device memory.  A
// forward call brings scratch for the weights' K-major split, each
// product's split written just before its GEMM reads it.
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

// Sizes and the dropout of one call.
struct Dims {
  int batch, t, c, h, n_layers, taps, dilation_rate;
  Dropout drop;
  // scratch of the tensor-core conv-GEMM's weight split (ConvGemm::tc_scratch)
  float* tc_scratch;
  long tc_scratch_floats;
};

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
  return a;
}

// The WN stack's 2L products in order (wn_layers' launches).
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
    // On the CUDA cores: a tensor-core product is short by about 1e-7 of
    // each output (its accumulator rounds toward zero), all outputs alike,
    // and the ActNorm scale's gradient is the small difference of sum(z^2)
    // and the frame count, which turns that into 1e-3 of the gradient.
    ConvGemm g = rows_gemm(d, x, c, c, a, ba, c, kBiasMask, zp, c, mask);
    g.tc_scratch = nullptr;
    out->push_back(g);
  }
  out->push_back(rows_gemm(d, zp, c, c / 2, w_s, b_s, h, kBiasMask, xs, h, mask));
  wn_products(wn_stack(d, wn, mask, xs, th, sg, acts, skipm, 1), out);
}

// Forward of one block.  zp may be z itself (nothing kept).
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
  {
    const int err = run_products(fwd, stream);
    if (err != 0) return err;
  }
  // z = [x0 | (m + e^logs * x1) * mask], logsm = logs * mask
  if (z != zp)
    GTT_TRY(cudaMemcpyAsync(z, zp, sizeof(float) * rows * c, cudaMemcpyDeviceToDevice, stream));
  ConvGemm e = rows_gemm(d, skipm, h, h, w_e, b_e, c, kCouplingFwd, z + c2, c, mask);
  e.split = c2; e.flag = sigmoid_scale; e.out2 = logsm; e.ldo2 = c2;
  GTT_TRY(conv_gemm(e, stream));
  // ld[b] = sum over the sample's rows and columns of logs * mask
  GTT_TRY(col_sum(logsm, c2, c2, nullptr, batch, t, ld_part, c2, stream));
  GTT_TRY(col_sum(ld_part, 1, 1, nullptr, batch, c2, ld, 1, stream));
  return (int)cudaGetLastError();
}

long round4(long floats) { return (floats + 3) / 4 * 4; }

// Every buffer of one backward call, carved from the caller's one block
// (bwd_scratch): the walk's res/skip cotangent g_rs, d_in_act (dia, for dg
// only), d_xin and its K-major split (big [2h, ldt], small after it), the
// gate product acts, the weight gradients' split partial sums (wg, also
// what a product would split its own weights into: none does) and the
// K-major splits of every product's weights; the block's dout, dzp [rows,
// c] and the stack-input cotangent gx [rows, h]; a recompute's forward
// residuals xs / th / sg [L, rows, h] and the block's zp [rows, c] and
// skipm [rows, h].
struct BwdScratch {
  float *g_rs = nullptr, *dia = nullptr, *dxin = nullptr, *dxin_t = nullptr, *acts = nullptr;
  float *wg = nullptr, *splits = nullptr;
  long ldt = 0, wg_floats = 0, split_floats = 0;
  float *dout = nullptr, *dzp = nullptr, *gx = nullptr;
  float *xs = nullptr, *th = nullptr, *sg = nullptr, *zp = nullptr, *skipm = nullptr;
};

// c 0: the WN stack alone.
long bwd_scratch(float* base, int batch, int t, int c, int h, int n_layers, int taps,
                 bool recompute, bool with_g, BwdScratch* s) {
  const long rows = (long)batch * t;
  const long h2 = 2L * h, c2 = c / 2, L = n_layers;
  long used = 0;
  auto take = [&](float*& p, long floats) {
    p = base ? base + used : nullptr;
    used += round4(floats);
  };
  s->ldt = round4(rows);
  // the splits, product by product as presplit_weights lays them out
  long splits = L * (round4(2 * h2 * h) + round4(2 * taps * h2 * h));
  if (recompute) splits += L * (round4(2 * taps * h * h2) + round4(2 * h * h2));
  if (c > 0) {
    splits += round4(2 * h * c2) + round4(2L * c * h) + round4(2 * h * c2) + round4(2L * c * c);
    if (recompute) splits += round4(2 * c2 * h);
  }
  s->split_floats = splits;
  s->wg_floats = std::max(1L << 22, 2L * (taps * h + 1) * h2);
  take(s->g_rs, rows * h2);
  if (with_g) take(s->dia, rows * h2);
  take(s->dxin, rows * h2);
  take(s->dxin_t, 2 * h2 * s->ldt);
  take(s->acts, rows * h);
  take(s->wg, s->wg_floats);
  take(s->splits, s->split_floats);
  if (c > 0) {
    take(s->dout, rows * c);
    take(s->dzp, rows * c);
    take(s->gx, rows * h);
  }
  if (recompute) {
    take(s->xs, L * rows * h);
    take(s->th, L * rows * h);
    take(s->sg, L * rows * h);
    if (c > 0) {
      take(s->zp, rows * c);
      take(s->skipm, rows * h);
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
  int dilation = 1;
  for (int l = 0; l < d.n_layers; ++l) {
    {  // da = g_rs @ W_rs^T, the gate backward in the epilogue
      ConvGemm g = rows_gemm(d, s.g_rs, h2, h2, w.w_rs + (long)l * h * h2, nullptr, h, kGateBwd,
                             w.dg ? s.dia : nullptr, h2, nullptr);
      g.w_t = 1;
      g.split = h; g.aux = w.th + l * rh; g.aux2 = w.sg + l * rh; g.ld_aux = h;
      g.out2 = s.dxin; g.ldo2 = h2; g.out3 = s.acts; g.ldo3 = h;
      g.drop = d.drop.at(l);
      p->gate.push_back(g);
    }
    {  // gx = gx * mask + transposed conv of d_xin; g_rs[:, :h] = gx * mask
      ConvGemm g = rows_gemm(d, s.dxin, h2, h2, w.w_in + (long)l * taps * h * h2, nullptr, h,
                             kAccumMask, w.gx, h, w.mask);
      g.w_t = 1; g.taps = taps; g.dilation = dilation; g.tap_sign = -1; g.tap_staged = 1;
      g.out2 = s.g_rs; g.ldo2 = h2;
      p->tconv.push_back(g);
    }
    WGrad rs = wgrad_of(s.acts, h, h, batch, t, s.g_rs, h2, h2, w.dwrs + (long)l * h * h2,
                        s.wg, s.wg_floats);
    rs.bias_out = w.dbrs + l * h2;
    p->drs.push_back(rs);
    WGrad in = wgrad_of(w.xs + l * rh, h, h, batch, t, s.dxin, h2, h2,
                        w.dwin + (long)l * taps * h * h2, s.wg, s.wg_floats);
    in.taps = taps; in.dilation = dilation; in.bias_out = w.dbin + l * h2;
    p->din.push_back(in);
    dilation *= d.dilation_rate;
  }
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
    if (w.dg)
      GTT_TRY(col_sum(s.dia, h2, h2, nullptr, d.batch, d.t, w.dg + l * h2, d.n_layers * h2,
                      stream));
    GTT_TRY(wgrad(p.din[l], stream));
    GTT_TRY(conv_gemm(p.tconv[l], stream));
  }
  return (int)cudaGetLastError();
}

// The WN stack's backward from per-layer residuals: dout [rows, h] is the
// skip sum's cotangent into g_rs's skip half; w.gx the returned dx.
int wn_bwd_chain(const Dims& d, const WnWalk& w, const BwdScratch& s, const WalkProducts& p,
                 const float* dout, cudaStream_t stream) {
  const int rows = d.batch * d.t;
  const int h = d.h;
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
  {
    ConvGemm& g = p->coupling = rows_gemm(d, b.skipm, h, h, b.w_e + c2, b.b_e + c2, c2,
                                          kCouplingBwd, s.dout, c, mask);
    g.ldb = c; g.split = c2; g.flag = b.sigmoid_scale;
    g.aux = b.dz; g.ld_aux = c; g.aux2 = b.zp; g.aux3 = b.dld; g.out2 = s.dzp; g.ldo2 = c;
  }
  {  // -> the skip half of g_rs
    ConvGemm& g = p->dskip =
        rows_gemm(d, s.dout, c, c, b.w_e, nullptr, h, kBiasMask, s.g_rs + h, h2, mask);
    g.w_t = 1;
  }
  {  // dzp[:, :c2] = (dz0 + d_pre @ W_s^T) * mask
    ConvGemm& g = p->dzp = rows_gemm(d, s.gx, h, h, b.w_s, nullptr, c2, kResidMask, s.dzp, c, mask);
    g.w_t = 1; g.a_mask = mask; g.aux = b.dz; g.ld_aux = c;
  }
  {
    ConvGemm& g = p->dx = rows_gemm(d, s.dzp, c, c, b.a, nullptr, c, kBias, b.dx, c, nullptr);
    g.w_t = 1;
  }
  p->dwe = wgrad_of(b.skipm, h, h, batch, t, s.dout, c, c, b.dwe, s.wg, s.wg_floats);
  p->dwe.bias_out = b.dbe;
  p->dws = wgrad_of(b.zp, c, c2, batch, t, s.gx, h, h, b.dws, s.wg, s.wg_floats);
  p->dws.dy_mask = mask; p->dws.bias_out = b.dbs;
  p->da = wgrad_of(b.x, c, c, batch, t, s.dzp, c, c, b.da, s.wg, s.wg_floats);
  p->da.bias_out = b.dba;
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
  GTT_TRY(cudaMemsetAsync(s.g_rs, 0, sizeof(float) * rows * 2 * d.h, stream));
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

extern "C" int gtt_wn_forward(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, float* skip,
    float* xcur, float* acts, float* tc_scratch, int tc_scratch_floats,
    int g_stride, int batch, int t, int h,
    int n_layers, int taps, int dilation_rate, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  const Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale),
               tc_scratch, tc_scratch_floats};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  const long rh = (long)batch * t * h;
  GTT_TRY(cudaMemcpyAsync(xcur, x, sizeof(float) * rh, cudaMemcpyDeviceToDevice, stream));
  GTT_TRY(wn_layers(wn_stack(d, wn, mask, xcur, nullptr, nullptr, acts, skip, 0), stream));
  return (int)cudaGetLastError();
}

extern "C" int gtt_wn_fwd_save(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, float* skip,
    float* xs, float* th, float* sg, float* acts, float* tc_scratch, int tc_scratch_floats,
    int g_stride, int batch,
    int t, int h, int n_layers, int taps, int dilation_rate, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  const Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale),
               tc_scratch, tc_scratch_floats};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  const long rh = (long)batch * t * h;
  GTT_TRY(cudaMemcpyAsync(xs, x, sizeof(float) * rh, cudaMemcpyDeviceToDevice, stream));
  GTT_TRY(wn_layers(wn_stack(d, wn, mask, xs, th, sg, acts, skip, 0), stream));
  return (int)cudaGetLastError();
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
    float* acts, float* logsm, float* ld_part, float* tc_scratch, int tc_scratch_floats,
    int g_stride, int batch, int t,
    int c, int h, int n_layers, int taps, int dilation_rate, int sigmoid_scale,
    int drop, int seed, unsigned threshold, float scale, cudaStream_t stream) {
  const Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale),
               tc_scratch, tc_scratch_floats};
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
    float* tc_scratch, int tc_scratch_floats,
    int g_stride, int batch, int t, int c, int h, int n_layers, int taps,
    int dilation_rate, int sigmoid_scale, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  const Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale),
               tc_scratch, tc_scratch_floats};
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
