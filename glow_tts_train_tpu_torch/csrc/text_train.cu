// The backward of the text-side conv stacks:
//
//  * gtt_prenet_bwd <- glow_tts_train_tpu/ops/text_pallas.py::_prenet_bwd_kernel
//  * gtt_duration_stack_bwd <- ops/text_pallas.py::_dp_bwd_kernel
//
// Like the TPU kernels, each saves nothing from the forward: it recomputes
// the stack from (weights, x, mask, seed) with the forward's own chain
// (text.cu), keeping per layer the conv input, the normalised input and the
// inverse std, replays the dropout keep masks from the seed, and walks the
// layers in reverse.  The TPU kernel holds one sample in VMEM and adds its
// weight gradients over a sequential batch grid; here the recomputed
// intermediates go to device-memory scratch, each product runs over all
// batch * t rows at once, and the weight gradients reduce through wgrad's
// split partial sums and per-sample column sums in a fixed order, so they
// are the same bits from run to run.
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
// Bound on the card: f32 FMA throughput of three products per layer (the
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

// w_t: [L, taps * h, h], per tap the transpose of w's [h, h] block; wp_t:
// wp transposed.  cur, xhat: [L, rows, h]; rstd: [L, rows]; pre, dcur, dpre:
// [rows, h]; col_part: [batch, h]; wg_scratch: wgrad's partial sums.
extern "C" int gtt_prenet_bwd(
    const float* x, const float* mask, const float* w, const float* b,
    const float* gamma, const float* beta, const float* wp, const float* bp,
    const float* w_t, const float* wp_t, const float* dout, float* dx,
    float* dw, float* db, float* dgamma, float* dbeta, float* dwp, float* dbp,
    float* out, float* pre, float* cur, float* xhat, float* rstd, float* dcur,
    float* dpre, float* col_part, float* wg_scratch, int wg_scratch_floats,
    int batch, int t, int h, int n_layers, int taps, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  using namespace gtt;
  const long rows = (long)batch * t;
  PrenetArgs a;
  a.x = x; a.mask = mask; a.w = w; a.b = b; a.gamma = gamma; a.beta = beta;
  a.wp = wp; a.bp = bp; a.out = out; a.pre = pre; a.cur = cur;
  a.xhat = xhat; a.rstd = rstd;
  a.batch = batch; a.t = t; a.h = h; a.n_layers = n_layers; a.taps = taps;
  a.drop = make_dropout(drop, seed, n_layers, threshold, scale);
  GTT_TRY(prenet_forward(a, stream));

  // residual projection: out = (x + xl @ wp + bp) * mask
  const float* xl = n_layers > 0 ? cur + (n_layers - 1) * rows * h : x;
  {
    WGrad g = conv_wgrad(xl, h, nullptr, 1, batch, t, dout, h, dwp, wg_scratch,
                         wg_scratch_floats);
    g.dy_mask = mask;
    GTT_TRY(wgrad(g, stream));
  }
  GTT_TRY(bias_grad(dout, h, h, mask, batch, t, col_part, dbp, stream));
  {  // dcur = (dout * mask) @ wp^T; with no layers dx = (dcur + dout) * mask
    ConvGemm g;
    g.a = dout; g.lda = h; g.c_in = h; g.a_mask = mask; g.batch = batch; g.t = t;
    g.w = wp_t; g.n = h; g.ldo = h;
    if (n_layers > 0) {
      g.epilogue = kBias; g.out = dcur;
    } else {
      g.epilogue = kResidMask; g.out = dx; g.mask = mask; g.aux = dout; g.ld_aux = h;
    }
    GTT_TRY(conv_gemm(g, stream));
  }
  for (int l = n_layers - 1; l >= 0; --l) {
    LayerNormBwd ln;
    ln.dy = dcur; ln.xhat = xhat + l * rows * h; ln.rstd = rstd + l * rows;
    ln.gamma = gamma + l * h; ln.beta = beta + l * h;
    ln.dyeff = dcur; ln.dx = dpre; ln.rows = (int)rows; ln.n = h; ln.t = t;
    ln.relu_after = 1; ln.drop = a.drop.at(l);
    GTT_TRY(layer_norm_bwd(ln, stream));
    GTT_TRY(ln_param_grads(dcur, ln.xhat, h, batch, t, col_part, dgamma + l * h,
                           dbeta + l * h, stream));
    const float* src = l > 0 ? cur + (l - 1) * rows * h : x;
    GTT_TRY(wgrad(conv_wgrad(src, h, mask, taps, batch, t, dpre, h,
                             dw + (long)l * taps * h * h, wg_scratch,
                             wg_scratch_floats), stream));
    GTT_TRY(bias_grad(dpre, h, h, nullptr, batch, t, col_part, db + l * h, stream));
    GTT_TRY(conv_gemm(conv_input_grad(dpre, h, w_t + (long)l * taps * h * h, h,
                                      taps, batch, t, mask,
                                      l == 0 ? dout : nullptr, l == 0 ? dx : dcur),
                      stream));
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
