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
// Both stacks' products run on the tensor cores where the shape fits, as
// the forward's do: the recompute, the weight gradients (their inputs are
// the forward's masked layer inputs, so no input mask on the gather) and
// the transposed convs, which read the forward's weights as they lie
// (ConvGemm::w_t); every buffer comes from the caller's one scratch block
// (prenet_scratch, duration_scratch).  The f32 prenet splits its
// transposed products' weights in one launch after its forward's; the f32
// duration stack splits all four of its products' weights in one launch
// before the recompute.  The sums stay on the CUDA cores: the norms'
// dgamma = sum dy * xhat and dbeta and the bias gradients (layer_sums),
// where a tensor-core product's lean would show.
//
// The bf16 chains (text_pallas.py _conv_bwd with dtype bf16) run every
// product on the TMA-fed wgmma kernels (ConvGemm::tma_ring,
// WGrad::tma_ring; the mma.sync ones below 64 channels or columns, by
// shape alone), each operand a bf16 tensor written by the kernel that
// produces it: the recompute's masked layer inputs (text.cu), which the
// weight gradients read as A; the LayerNorm backward's dpre copy (dx_c:
// JAX's dpret = dpre.astype(dtype)), the transposed conv's A and the
// weight gradient's dY; the prenet's dout * mask (mask_rows: JAX's
// dmasked.astype(dtype), exact), the projection's transposed product's A
// and its weight gradient's dY.  The bias gradients sum the f32 values
// (jnp.sum(dpre), the f32 dmasked); a layer's norm and bias sums go in one
// launch.
//
// Bound on the card: the operations of three products per layer (the
// recompute, the weight gradient, the transposed conv) at K = 5 * 192 or
// 3 * 256, by the 3xTF32 peak where they take the tensor cores; at training
// sizes (rows = 16 * 192) every launch is a wave or two of blocks, so
// launch latency shares the time.
#include "text.cuh"

namespace {

using namespace gtt;

#define GTT_TRY(expr)                               \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

// A layer's norm and bias gradients, column sums of the f32 values over
// `rows` rows of n: dgamma = sum dyeff * xhat, dbeta = sum dyeff, db = sum
// dpre.  A bf16 chain runs both sums in one launch (each job's bits its own
// launch's: a sum of 192 columns alone is 24 blocks, most of the card
// idle); the f32 chain one launch each.
cudaError_t layer_sums(const float* dyeff, const float* xhat, const float* dpre, int n, int rows,
                       float* dgamma, float* dbeta, float* db, bool one_launch,
                       cudaStream_t stream) {
  if (!one_launch) {
    const cudaError_t err = column_sums(dyeff, n, n, xhat, rows, dgamma, dbeta, stream);
    return err != cudaSuccess ? err : column_sums(dpre, n, n, nullptr, rows, db, nullptr, stream);
  }
  ColumnSumJobs sums;
  ColumnSumJob& norm = sums.job[sums.count++];
  norm.x = dyeff; norm.ld = n; norm.n = n; norm.mul = xhat; norm.out = dgamma; norm.out2 = dbeta;
  ColumnSumJob& bias = sums.job[sums.count++];
  bias.x = dpre; bias.ld = n; bias.n = n; bias.out = db;
  return column_sums(sums, rows, stream);
}

}  // namespace

// Outputs: dx and the 6 weight gradients, the recomputed forward's output
// `out` and its layer outputs before the mask `cur` [L, rows, h] (the
// ReLU gates: where positive).  Scratch: one block of
// gtt_prenet_scratch_floats(..., 1) floats.
namespace {

// bf16 (PrenetArgs::bf16): x, w, wp, dout, dx, dw, dwp and out bf16.
int prenet_bwd_entry(
    const float* x, const float* mask, const float* w, const float* b,
    const float* gamma, const float* beta, const float* wp, const float* bp,
    const float* dout, float* dx, float* dw, float* db, float* dgamma, float* dbeta,
    float* dwp, float* dbp, float* out, float* cur, float* scratch,
    long long scratch_floats, int batch, int t, int h, int n_layers, int taps, int drop,
    int seed, unsigned threshold, float scale, bool bf16, cudaStream_t stream) {
  using namespace gtt;
  const long rows = (long)batch * t;
  const int L = n_layers;
  // a bf16 call's products: bf16 operands (each written by its producer)
  // and weights
  const unsigned bf = bf16 ? kBf16 | kA16 | kW16 : 0u;
  PrenetArgs a;
  a.bf16 = bf16;
  a.x = x; a.mask = mask; a.w = w; a.b = b; a.gamma = gamma; a.beta = beta;
  a.wp = wp; a.bp = bp; a.out = out; a.cur = cur; a.save = true;
  a.dims.batch = batch; a.dims.t = t; a.dims.h = h; a.dims.n_layers = L; a.dims.taps = taps;
  if (prenet_scratch(scratch, a.dims, true, &a.s) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = make_dropout(drop, seed, L, threshold, scale);
  GTT_TRY(prenet_forward(a, stream));
  const PrenetScratch& s = a.s;
  // layer l's input, masked: x * mask, then the layers' masked outputs
  // (bf16 in a bf16 call)
  auto src = [&](int l) { return l ? s.curm + (l - 1) * rows * h : s.xm; };

  // the transposed products (reading the forward's weights as they lie),
  // their weights split for the tensor cores in one launch (the f32
  // chain's): per layer d(input) = (transposed conv of dpre) * mask, plus
  // dout * mask at layer 0; the projection's dcur = (dout * mask) @ wp^T
  // (with no layers dx = (dcur + dout) * mask)
  ConvGemm g[kMaxPrenetLayers + 1];
  ConvGemm* products[kMaxPrenetLayers + 1];
  for (int l = 0; l <= L; ++l) {
    ConvGemm& p = g[l] = text_chain_product(s, bf16);
    p.lda = h; p.c_in = h; p.batch = batch; p.t = t; p.w_t = 1; p.n = h; p.ldo = h;
    p.mask = mask;
    p.epilogue = l == 0 ? kResidMask : kBiasMask; p.out = l == 0 ? dx : s.dcur;
    p.aux = l == 0 ? dout : nullptr; p.ld_aux = h;
    products[l] = &p;
  }
  for (int l = 0; l < L; ++l) {
    g[l].a = bf16 ? s.dpre16 : s.dpre; g[l].taps = taps; g[l].tap_sign = -1;
    g[l].w = elem_at(w, (long)l * taps * h * h, bf16);
    g[l].bf16 = bf ? bf | (l == 0 ? kOut16 | kAux16 : 0u) : 0u;
  }
  ConvGemm& dproj = g[L];
  dproj.w = wp;
  if (bf16) {  // dmasked.astype(bf16)
    dproj.a = s.dout16;
    dproj.bf16 = bf | (L ? 0u : kOut16 | kAux16);
  } else {
    dproj.a = dout; dproj.a_mask = mask;
  }
  if (L > 0) { dproj.epilogue = kBias; dproj.out = s.dcur; dproj.mask = nullptr; dproj.aux = nullptr; }
  if (!bf16)
    GTT_TRY(presplit_weights(products, L + 1, s.tc + s.tc_floats / 2, s.tc_floats / 2, stream));
  else
    GTT_TRY(mask_rows(dout, mask, s.dout16, rows, h, true, stream));

  // the residual projection: out = (x + xl @ wp + bp) * mask
  {
    WGrad pw;
    pw.a = L ? src(L) : x; pw.lda = h; pw.c_in = h; pw.batch = batch; pw.t = t;
    pw.dy = dout; pw.ldy = h; pw.n = h; pw.dy_mask = mask; pw.out = dwp;
    pw.scratch = s.wg; pw.scratch_floats = s.wg_floats; pw.tc = 1;
    if (bf16) {
      pw.bf16 = kBf16 | kA16 | kAux16 | kOut16;
      pw.dy16 = s.dout16;
      pw.tma_ring = 1;
    }
    GTT_TRY(wgrad(pw, stream));
  }
  GTT_TRY(bias_grad(dout, h, h, mask, batch, t, s.col_part, dbp, stream, bf16));
  GTT_TRY(conv_gemm(dproj, stream));
  for (int l = L - 1; l >= 0; --l) {
    LayerNormBwd ln;
    ln.dy = s.dcur; ln.xhat = s.xhat + l * rows * h; ln.rstd = s.rstd + l * rows;
    ln.gamma = gamma + l * h; ln.beta = beta + l * h;
    ln.dyeff = s.dcur; ln.dx = s.dpre; ln.rows = (int)rows; ln.n = h; ln.t = t;
    ln.relu_after = 1; ln.drop = a.drop.at(l);
    ln.dx_c = bf16 ? s.dpre16 : nullptr;  // dpret = dpre.astype(bf16)
    GTT_TRY(layer_norm_bwd(ln, stream));
    GTT_TRY(layer_sums(s.dcur, ln.xhat, s.dpre, h, (int)rows, dgamma + l * h, dbeta + l * h,
                       db + l * h, bf16, stream));
    WGrad wg;
    wg.a = src(l); wg.lda = h; wg.c_in = h; wg.taps = taps; wg.batch = batch; wg.t = t;
    wg.dy = s.dpre; wg.ldy = h; wg.n = h; wg.out = elem_at(dw, (long)l * taps * h * h, bf16);
    wg.scratch = s.wg; wg.scratch_floats = s.wg_floats; wg.tc = 1;
    if (bf16) {
      wg.bf16 = kBf16 | kA16 | kOut16;
      wg.dy16 = s.dpre16;
      wg.tma_ring = 1;
    }
    GTT_TRY(wgrad(wg, stream));
    GTT_TRY(conv_gemm(g[l], stream));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gtt_prenet_bwd(
    const float* x, const float* mask, const float* w, const float* b,
    const float* gamma, const float* beta, const float* wp, const float* bp,
    const float* dout, float* dx, float* dw, float* db, float* dgamma, float* dbeta,
    float* dwp, float* dbp, float* out, float* cur, float* scratch,
    long long scratch_floats, int batch, int t, int h, int n_layers, int taps, int drop,
    int seed, unsigned threshold, float scale, cudaStream_t stream) {
  return prenet_bwd_entry(x, mask, w, b, gamma, beta, wp, bp, dout, dx, dw, db, dgamma, dbeta,
                          dwp, dbp, out, cur, scratch, scratch_floats, batch, t, h, n_layers,
                          taps, drop, seed, threshold, scale, false, stream);
}

// The same in bf16: x, w, wp, dout, dx, dw, dwp and out bf16, `cur` f32.
extern "C" int gtt_prenet_bwd_bf16(
    const float* x, const float* mask, const float* w, const float* b,
    const float* gamma, const float* beta, const float* wp, const float* bp,
    const float* dout, float* dx, float* dw, float* db, float* dgamma, float* dbeta,
    float* dwp, float* dbp, float* out, float* cur, float* scratch,
    long long scratch_floats, int batch, int t, int h, int n_layers, int taps, int drop,
    int seed, unsigned threshold, float scale, cudaStream_t stream) {
  return prenet_bwd_entry(x, mask, w, b, gamma, beta, wp, bp, dout, dx, dw, db, dgamma, dbeta,
                          dwp, dbp, out, cur, scratch, scratch_floats, batch, t, h, n_layers,
                          taps, drop, seed, threshold, scale, true, stream);
}

// Outputs: dx and the 8 weight gradients, the recomputed forward's output
// `out` and its ReLU outputs `relu` [2, rows, f] (the ReLU gates: where
// positive).  Scratch: one block of gtt_duration_scratch_floats(..., 1)
// floats.
namespace {

// bf16 (DurationArgs::bf16): x, w1, w2, dout, dx, dw1, dw2 and out bf16.
int duration_bwd_entry(
    const float* x, const float* mask, const float* w1, const float* b1,
    const float* gamma1, const float* beta1, const float* w2, const float* b2,
    const float* gamma2, const float* beta2, const float* dout, float* dx, float* dw1,
    float* db1, float* dgamma1, float* dbeta1, float* dw2, float* db2, float* dgamma2,
    float* dbeta2, float* out, float* relu, float* scratch, long long scratch_floats,
    int batch, int t, int c_in, int f, int taps, int drop, int seed, unsigned threshold,
    float scale, bool bf16, cudaStream_t stream) {
  using namespace gtt;
  const long rows = (long)batch * t;
  // a bf16 call's products: bf16 operands (each written by its producer)
  // and weights
  const unsigned bf = bf16 ? kBf16 | kA16 | kW16 : 0u;
  DurationArgs a;
  a.bf16 = bf16;
  a.x = x; a.mask = mask;
  a.w[0] = w1; a.b[0] = b1; a.gamma[0] = gamma1; a.beta[0] = beta1;
  a.w[1] = w2; a.b[1] = b2; a.gamma[1] = gamma2; a.beta[1] = beta2;
  a.out = out; a.relu = relu; a.save = true;
  a.dims.batch = batch; a.dims.t = t; a.dims.c_in = c_in; a.dims.f = f; a.dims.taps = taps;
  if (duration_scratch(scratch, a.dims, true, &a.s) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = make_dropout(drop, seed, 2, threshold, scale);
  const DurationScratch& s = a.s;

  // the recompute's two convs and the two transposed convs, reading the
  // forward's weights as they lie: d(input) = (transposed conv of dpre) *
  // mask, into dcur (layer 1) or dx; the f32 chain splits all four weights
  // in one launch
  ConvGemm g[2], gt[2];
  duration_convs(a, g);
  for (int l = 0; l < 2; ++l) {
    ConvGemm& p = gt[l] = text_chain_product(s, bf16);
    p.a = bf16 ? s.dpre16 : s.dpre; p.lda = f; p.c_in = f; p.taps = taps; p.tap_sign = -1;
    p.batch = batch; p.t = t; p.w = a.w[l]; p.w_t = 1; p.n = g[l].c_in;
    p.epilogue = kBiasMask; p.out = l ? s.dcur : dx; p.ldo = g[l].c_in; p.mask = mask;
    p.bf16 = bf ? bf | (l ? 0u : kOut16) : 0u;
  }
  ConvGemm* products[4] = {&g[0], &g[1], &gt[0], &gt[1]};
  if (!bf16) GTT_TRY(presplit_weights(products, 4, s.tc, s.tc_floats, stream));
  GTT_TRY(duration_forward(a, g, stream));

  float* dws[2] = {dw1, dw2};
  float* dbs[2] = {db1, db2};
  float* dgs[2] = {dgamma1, dgamma2};
  float* dbes[2] = {dbeta1, dbeta2};
  for (int l = 1; l >= 0; --l) {
    LayerNormBwd ln;
    ln.dy = l == 1 ? dout : s.dcur; ln.xhat = s.xhat + l * rows * f;
    ln.rstd = s.rstd + l * rows; ln.gamma = a.gamma[l];
    ln.relu_src = relu + l * rows * f;
    ln.dyeff = s.dcur; ln.dx = s.dpre; ln.rows = (int)rows; ln.n = f; ln.t = t;
    ln.drop = a.drop.at(l);
    ln.bf16 = bf16 && l == 1 ? kAux16 : 0u;
    ln.dx_c = bf16 ? s.dpre16 : nullptr;  // dpret = dpre.astype(bf16), dpre = dr * [pre > 0]
    GTT_TRY(layer_norm_bwd(ln, stream));
    GTT_TRY(layer_sums(s.dcur, ln.xhat, s.dpre, f, (int)rows, dgs[l], dbes[l], dbs[l], bf16,
                       stream));
    WGrad wg;  // the conv's input, stored masked: no mask on the gather
    wg.a = g[l].a; wg.lda = g[l].lda; wg.c_in = g[l].c_in; wg.taps = taps;
    wg.batch = batch; wg.t = t; wg.dy = s.dpre; wg.ldy = f; wg.n = f; wg.out = dws[l];
    wg.scratch = s.wg; wg.scratch_floats = s.wg_floats; wg.tc = 1;
    if (bf16) {
      wg.bf16 = kBf16 | kA16 | kOut16;
      wg.dy16 = s.dpre16;
      wg.tma_ring = 1;
    }
    GTT_TRY(wgrad(wg, stream));
    GTT_TRY(conv_gemm(gt[l], stream));
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gtt_duration_stack_bwd(
    const float* x, const float* mask, const float* w1, const float* b1,
    const float* gamma1, const float* beta1, const float* w2, const float* b2,
    const float* gamma2, const float* beta2, const float* dout, float* dx, float* dw1,
    float* db1, float* dgamma1, float* dbeta1, float* dw2, float* db2, float* dgamma2,
    float* dbeta2, float* out, float* relu, float* scratch, long long scratch_floats,
    int batch, int t, int c_in, int f, int taps, int drop, int seed, unsigned threshold,
    float scale, cudaStream_t stream) {
  return duration_bwd_entry(x, mask, w1, b1, gamma1, beta1, w2, b2, gamma2, beta2, dout, dx,
                            dw1, db1, dgamma1, dbeta1, dw2, db2, dgamma2, dbeta2, out, relu,
                            scratch, scratch_floats, batch, t, c_in, f, taps, drop, seed,
                            threshold, scale, false, stream);
}

// The same in bf16: x, w1, w2, dout, dx, dw1, dw2 and out bf16, `relu` f32.
extern "C" int gtt_duration_stack_bwd_bf16(
    const float* x, const float* mask, const float* w1, const float* b1,
    const float* gamma1, const float* beta1, const float* w2, const float* b2,
    const float* gamma2, const float* beta2, const float* dout, float* dx, float* dw1,
    float* db1, float* dgamma1, float* dbeta1, float* dw2, float* db2, float* dgamma2,
    float* dbeta2, float* out, float* relu, float* scratch, long long scratch_floats,
    int batch, int t, int c_in, int f, int taps, int drop, int seed, unsigned threshold,
    float scale, cudaStream_t stream) {
  return duration_bwd_entry(x, mask, w1, b1, gamma1, beta1, w2, b2, gamma2, beta2, dout, dx,
                            dw1, db1, dgamma1, dbeta1, dw2, db2, dgamma2, dbeta2, out, relu,
                            scratch, scratch_floats, batch, t, c_in, f, taps, drop, seed,
                            threshold, scale, true, stream);
}
