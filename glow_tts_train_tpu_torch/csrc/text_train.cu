// The backward of the text-side conv stacks:
//
//  * gtt_prenet_bwd <- glow_tts_train_tpu/ops/text_pallas.py::_prenet_bwd_kernel
//  * gtt_duration_stack_bwd <- ops/text_pallas.py::_dp_bwd_kernel
//
// Like the TPU kernels, each saves nothing from the forward: it recomputes
// the stack from (weights, x, mask, seed) with the forward's own chain
// (text.cu: the same launches and dispatch, so the recomputed output and
// ReLU gates are the forward kernel's bits), keeping per layer the conv
// input, the normalised input and the inverse std, replays the dropout keep
// masks from the seed, and walks the layers in reverse.  The TPU kernel
// holds one sample in VMEM and adds its weight gradients over a sequential
// batch grid; here the recomputed intermediates go to device-memory
// scratch, each product runs over all batch * t rows at once, and the
// weight gradients reduce through split partial sums added in a fixed
// order, so they are the same bits from run to run.
//
// Per layer, prenet (conv -> LN -> ReLU -> drop):
//   dy    = dcur * keep * scale * [LN out > 0]      (layer_norm_bwd)
//   dpre  = LN backward of dy; dgamma, dbeta
//   dW    = im2col(cur_{l-1} * mask)^T dpre; db = colsum(dpre)
//   dcur' = (transposed conv of dpre) * mask
// and dx = dcur' + dout * mask after layer 0.  Duration stack (conv -> ReLU
// -> LN -> drop): dy = dcur * keep * scale, dr = LN backward, dpre = dr *
// [pre > 0], the rest alike.
//
// The prenet's products run on the tensor cores where the shape fits, as
// the forward's do: the recompute, the weight gradients (their inputs are
// the forward's masked layer outputs, so no input mask on the gather) and
// the transposed convs, which read the forward's weights as they lie
// (ConvGemm::w_t), split in one launch; every buffer comes from the
// caller's one scratch block (prenet_scratch).  The sums stay on the CUDA
// cores: the norms' dgamma = sum dy * xhat and the bias gradients
// (column_sums, one launch each), where a tensor-core product's lean would
// show.  The duration stack's products stay on the CUDA cores.
//
// Bound on the card: the operations of three products per layer (the
// recompute, the weight gradient, the transposed conv) at K = 5 * 192 or
// 3 * 256; at training sizes (rows = 16 * 192) every launch is a wave or two
// of blocks, so launch latency shares the time.
#include "text.cuh"

namespace {

using namespace gtt;

#define GTT_TRY(expr)                               \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

WGrad conv_wgrad(const float* a, int c_in, const float* a_mask, int taps,
                 int batch, int t, const float* dy, int n, float* out,
                 float* scratch, long scratch_floats) {
  WGrad w;
  w.a = a; w.lda = c_in; w.c_in = c_in; w.a_mask = a_mask; w.taps = taps;
  w.batch = batch; w.t = t; w.dy = dy; w.ldy = n; w.n = n; w.out = out;
  w.scratch = scratch; w.scratch_floats = scratch_floats;
  return w;
}

// out = (transposed k-tap conv of dpre [rows, n] with w_t [taps * n, c]) *
// mask, plus resid * mask when given.
ConvGemm conv_input_grad(const float* dpre, int n, const float* w_t, int c,
                         int taps, int batch, int t, const float* mask,
                         const float* resid, float* out) {
  ConvGemm g;
  g.a = dpre; g.lda = n; g.c_in = n; g.taps = taps; g.tap_sign = -1;
  g.batch = batch; g.t = t; g.w = w_t; g.n = c;
  g.epilogue = resid ? kResidMask : kBiasMask;
  g.aux = resid; g.ld_aux = c;
  g.out = out; g.ldo = c; g.mask = mask;
  return g;
}

}  // namespace

// Outputs: dx and the 6 weight gradients, the recomputed forward's output
// `out` and its layer outputs before the mask `cur` [L, rows, h] (the
// ReLU gates: where positive).  Scratch: one block of
// gtt_prenet_scratch_floats(..., 1) floats.
extern "C" int gtt_prenet_bwd(
    const float* x, const float* mask, const float* w, const float* b,
    const float* gamma, const float* beta, const float* wp, const float* bp,
    const float* dout, float* dx, float* dw, float* db, float* dgamma, float* dbeta,
    float* dwp, float* dbp, float* out, float* cur, float* scratch,
    long long scratch_floats, int batch, int t, int h, int n_layers, int taps, int drop,
    int seed, unsigned threshold, float scale, cudaStream_t stream) {
  using namespace gtt;
  const long rows = (long)batch * t;
  const int L = n_layers;
  PrenetArgs a;
  a.x = x; a.mask = mask; a.w = w; a.b = b; a.gamma = gamma; a.beta = beta;
  a.wp = wp; a.bp = bp; a.out = out; a.cur = cur; a.save = true;
  a.dims.batch = batch; a.dims.t = t; a.dims.h = h; a.dims.n_layers = L; a.dims.taps = taps;
  if (prenet_scratch(scratch, a.dims, true, &a.s) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = make_dropout(drop, seed, L, threshold, scale);
  GTT_TRY(prenet_forward(a, stream));
  const PrenetScratch& s = a.s;
  // layer l's input, masked: x * mask, then the layers' masked outputs
  auto src = [&](int l) { return l ? s.curm + (l - 1) * rows * h : s.xm; };

  // the transposed products (reading the forward's weights as they lie),
  // their weights split for the tensor cores in one launch: per layer
  // d(input) = (transposed conv of dpre) * mask, plus dout * mask at layer
  // 0; the projection's dcur = (dout * mask) @ wp^T (with no layers dx =
  // (dcur + dout) * mask)
  ConvGemm g[kMaxPrenetLayers + 1];
  ConvGemm* products[kMaxPrenetLayers + 1];
  for (int l = 0; l <= L; ++l) {
    ConvGemm& p = g[l] = prenet_product(s);
    p.lda = h; p.c_in = h; p.batch = batch; p.t = t; p.w_t = 1; p.n = h; p.ldo = h;
    p.mask = mask;
    p.epilogue = l == 0 ? kResidMask : kBiasMask; p.out = l == 0 ? dx : s.dcur;
    p.aux = l == 0 ? dout : nullptr; p.ld_aux = h;
    products[l] = &p;
  }
  for (int l = 0; l < L; ++l) {
    g[l].a = s.dpre; g[l].taps = taps; g[l].tap_sign = -1; g[l].w = w + (long)l * taps * h * h;
  }
  ConvGemm& dproj = g[L];
  dproj.a = dout; dproj.a_mask = mask; dproj.w = wp;
  if (L > 0) { dproj.epilogue = kBias; dproj.out = s.dcur; dproj.mask = nullptr; dproj.aux = nullptr; }
  GTT_TRY(presplit_weights(products, L + 1, s.tc + s.tc_floats / 2, s.tc_floats / 2, stream));

  // the residual projection: out = (x + xl @ wp + bp) * mask
  {
    WGrad pw;
    pw.a = L ? src(L) : x; pw.lda = h; pw.c_in = h; pw.batch = batch; pw.t = t;
    pw.dy = dout; pw.ldy = h; pw.n = h; pw.dy_mask = mask; pw.out = dwp;
    pw.scratch = s.wg; pw.scratch_floats = s.wg_floats; pw.tc = 1;
    GTT_TRY(wgrad(pw, stream));
  }
  GTT_TRY(bias_grad(dout, h, h, mask, batch, t, s.col_part, dbp, stream));
  GTT_TRY(conv_gemm(dproj, stream));
  for (int l = L - 1; l >= 0; --l) {
    LayerNormBwd ln;
    ln.dy = s.dcur; ln.xhat = s.xhat + l * rows * h; ln.rstd = s.rstd + l * rows;
    ln.gamma = gamma + l * h; ln.beta = beta + l * h;
    ln.dyeff = s.dcur; ln.dx = s.dpre; ln.rows = (int)rows; ln.n = h; ln.t = t;
    ln.relu_after = 1; ln.drop = a.drop.at(l);
    GTT_TRY(layer_norm_bwd(ln, stream));
    GTT_TRY(column_sums(s.dcur, h, h, ln.xhat, (int)rows, dgamma + l * h, dbeta + l * h,
                        stream));
    WGrad wg;
    wg.a = src(l); wg.lda = h; wg.c_in = h; wg.taps = taps; wg.batch = batch; wg.t = t;
    wg.dy = s.dpre; wg.ldy = h; wg.n = h; wg.out = dw + (long)l * taps * h * h;
    wg.scratch = s.wg; wg.scratch_floats = s.wg_floats; wg.tc = 1;
    GTT_TRY(wgrad(wg, stream));
    GTT_TRY(column_sums(s.dpre, h, h, nullptr, (int)rows, db + l * h, nullptr, stream));
    GTT_TRY(conv_gemm(g[l], stream));
  }
  return (int)cudaGetLastError();
}

// w1_t: [taps * f, c_in], w2_t: [taps * f, f], per tap the transposed block.
// relu, xhat: [2, rows, f]; rstd: [2, rows]; mid, out, dcur, dpre: [rows, f];
// col_part: [batch, f].
extern "C" int gtt_duration_stack_bwd(
    const float* x, const float* mask, const float* w1, const float* b1,
    const float* gamma1, const float* beta1, const float* w2, const float* b2,
    const float* gamma2, const float* beta2, const float* w1_t,
    const float* w2_t, const float* dout, float* dx, float* dw1, float* db1,
    float* dgamma1, float* dbeta1, float* dw2, float* db2, float* dgamma2,
    float* dbeta2, float* out, float* relu, float* mid, float* xhat,
    float* rstd, float* dcur, float* dpre, float* col_part, float* wg_scratch,
    int wg_scratch_floats, int batch, int t, int c_in, int f, int taps,
    int drop, int seed, unsigned threshold, float scale, cudaStream_t stream) {
  using namespace gtt;
  const long rows = (long)batch * t;
  DurationArgs a;
  a.x = x; a.mask = mask;
  a.w[0] = w1; a.b[0] = b1; a.gamma[0] = gamma1; a.beta[0] = beta1;
  a.w[1] = w2; a.b[1] = b2; a.gamma[1] = gamma2; a.beta[1] = beta2;
  a.out = out; a.relu = relu; a.mid = mid; a.xhat = xhat; a.rstd = rstd;
  a.batch = batch; a.t = t; a.c_in = c_in; a.f = f; a.taps = taps;
  a.drop = make_dropout(drop, seed, 2, threshold, scale);
  GTT_TRY(duration_forward(a, stream));

  const float* w_t[2] = {w1_t, w2_t};
  float* dws[2] = {dw1, dw2};
  float* dbs[2] = {db1, db2};
  float* dgs[2] = {dgamma1, dgamma2};
  float* dbes[2] = {dbeta1, dbeta2};
  for (int l = 1; l >= 0; --l) {
    LayerNormBwd ln;
    ln.dy = l == 1 ? dout : dcur; ln.xhat = xhat + l * rows * f;
    ln.rstd = rstd + l * rows; ln.gamma = a.gamma[l];
    ln.relu_src = relu + l * rows * f;
    ln.dyeff = dcur; ln.dx = dpre; ln.rows = (int)rows; ln.n = f; ln.t = t;
    ln.drop = a.drop.at(l);
    GTT_TRY(layer_norm_bwd(ln, stream));
    GTT_TRY(ln_param_grads(dcur, ln.xhat, f, batch, t, col_part, dgs[l], dbes[l], stream));
    const float* src = l == 1 ? mid : x;
    const int width = l == 1 ? f : c_in;
    GTT_TRY(wgrad(conv_wgrad(src, width, mask, taps, batch, t, dpre, f, dws[l],
                             wg_scratch, wg_scratch_floats), stream));
    GTT_TRY(bias_grad(dpre, f, f, nullptr, batch, t, col_part, dbs[l], stream));
    GTT_TRY(conv_gemm(conv_input_grad(dpre, f, w_t[l], width, taps, batch, t, mask,
                                      nullptr, l == 1 ? dcur : dx), stream));
  }
  return (int)cudaGetLastError();
}
