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
// and then the store backward's chain: the same launches on the same
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
// with dld, dx1); dW_e, db_e; dskip = (dout @ W_e^T) * mask; then the WN
// reverse walk from layer L-1 down, per layer
//
//   da      = [gx * mask | dskip] @ W_rs^T  -> gate backward in the epilogue
//             (d_in_act, d_xin = drop(d_in_act), acts = th * sg)
//   dW_rs  += acts^T [gx * mask | dskip];  db_rs, dg (per sample), db_in
//   dW_in  += im2col(xs[l])^T d_xin
//   gx      = gx * mask + sum_k d_xin[t - off_k] W_k^T   (transposed conv)
//
// then the start conv (dW_s, db_s, dx0 = dz0 + (gx * mask) @ W_s^T) and the
// folded A (dA = x^T dzp, dbA, dx = dzp @ A^T).  The transposed products
// read weights the wrapper laid out transposed (per tap for W_in).  Weight
// gradients reduce over all rows by split partial sums and a second pass in
// a fixed order, bias gradients by per-sample column sums: no float
// atomics, so a gradient is the same bits from run to run.
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
// forward call brings scratch for the weights' K-major split; a backward
// shares its weight-gradient scratch with it (the launches are in stream
// order, each product's split written just before its GEMM reads it).
#include <cuda_runtime.h>

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

// Forward of one block.  With saves (th set) xs / th / sg are layer-major
// [L, rows, h]; without, xs is the [rows, h] WN state.  zp may be z itself
// (nothing kept); z null stops after skipm (a backward's recompute).
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
  GTT_TRY(cudaMemsetAsync(skipm, 0, sizeof(float) * rows * h, stream));
  // zp = (x @ A + bA) * mask
  {
    // On the CUDA cores: a tensor-core product is short by about 1e-7 of
    // each output (its accumulator rounds toward zero), all outputs alike,
    // and the ActNorm scale's gradient is the small difference of sum(z^2)
    // and the frame count, which turns that into 1e-3 of the gradient.
    ConvGemm g = rows_gemm(d, x, c, c, a, ba, c, kBiasMask, zp, c, mask);
    g.tc_scratch = nullptr;
    GTT_TRY(conv_gemm(g, stream));
  }
  // xs[0] = (x0 @ W_s + b_s) * mask
  GTT_TRY(conv_gemm(rows_gemm(d, zp, c, c2, w_s, b_s, h, kBiasMask, xs, h, mask), stream));
  // skipm = skip * mask once the sum is complete
  GTT_TRY(wn_layers(wn_stack(d, wn, mask, xs, th, sg, acts, skipm, 1), stream));
  if (z == nullptr) return (int)cudaGetLastError();
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

// Operands of the WN reverse walk (wn_pallas._reverse_walk).  On entry
// g_rs [rows, 2h] holds zeros in its residual half and the skip cotangent
// in its skip half, and gx [rows, h] zeros; on return gx holds the
// stack-input cotangent g_x * mask + dx_conv of layer 0 (not masked again).
struct WnWalk {
  const float *mask, *w_in_t, *w_rs_t, *xs, *th, *sg;
  float *g_rs, *dia, *dxin, *acts, *gx, *col_part, *wg_scratch;
  long wg_scratch_floats;
  float *dwin, *dbin, *dwrs, *dbrs, *dg;  // dg null: unconditioned
};

int wn_reverse_walk(const Dims& d, const WnWalk& w, cudaStream_t stream) {
  const int batch = d.batch, t = d.t, h = d.h, taps = d.taps;
  const int h2 = 2 * h;
  const long rh = (long)batch * t * h;
  int dilation = 1;
  for (int l = 0; l < d.n_layers - 1; ++l) dilation *= d.dilation_rate;
  for (int l = d.n_layers - 1; l >= 0; --l) {
    {  // da = g_rs @ W_rs^T, gate backward in the epilogue
      ConvGemm g = rows_gemm(d, w.g_rs, h2, h2, w.w_rs_t + (long)l * h2 * h,
                             nullptr, h, kGateBwd, w.dia, h2, nullptr);
      g.split = h; g.aux = w.th + l * rh; g.aux2 = w.sg + l * rh; g.ld_aux = h;
      g.out2 = w.dxin; g.ldo2 = h2; g.out3 = w.acts; g.ldo3 = h;
      g.drop = d.drop.at(l);
      GTT_TRY(conv_gemm(g, stream));
    }
    GTT_TRY(wgrad(wgrad_of(w.acts, h, h, batch, t, w.g_rs, h2, h2,
                           w.dwrs + (long)l * h * h2, w.wg_scratch, w.wg_scratch_floats),
                  stream));
    GTT_TRY(bias_grad(w.g_rs, h2, h2, nullptr, batch, t, w.col_part, w.dbrs + l * h2, stream));
    if (w.dg)
      GTT_TRY(col_sum(w.dia, h2, h2, nullptr, batch, t, w.dg + l * h2, d.n_layers * h2, stream));
    GTT_TRY(bias_grad(w.dxin, h2, h2, nullptr, batch, t, w.col_part, w.dbin + l * h2, stream));
    {
      WGrad g = wgrad_of(w.xs + l * rh, h, h, batch, t, w.dxin, h2, h2,
                         w.dwin + (long)l * taps * h * h2, w.wg_scratch, w.wg_scratch_floats);
      g.taps = taps; g.dilation = dilation;
      GTT_TRY(wgrad(g, stream));
    }
    {  // gx = gx * mask + transposed conv of d_xin; g_rs[:, :h] = gx * mask
      ConvGemm g = rows_gemm(d, w.dxin, h2, h2, w.w_in_t + (long)l * taps * h2 * h,
                             nullptr, h, kAccumMask, w.gx, h, w.mask);
      g.taps = taps; g.dilation = dilation; g.tap_sign = -1;
      g.out2 = w.g_rs; g.ldo2 = h2;
      GTT_TRY(conv_gemm(g, stream));
    }
    if (d.dilation_rate > 0) dilation /= d.dilation_rate;
  }
  return (int)cudaGetLastError();
}

// The WN stack's backward from per-layer residuals: dout [rows, h] is the
// skip sum's cotangent, w.gx the returned dx.
int wn_bwd_chain(const Dims& d, const WnWalk& w, const float* dout, cudaStream_t stream) {
  const int rows = d.batch * d.t;
  const int h = d.h;
  GTT_TRY(cudaMemsetAsync(w.g_rs, 0, sizeof(float) * rows * 2 * h, stream));
  GTT_TRY(cudaMemsetAsync(w.gx, 0, sizeof(float) * rows * h, stream));
  GTT_TRY(cudaMemcpy2DAsync(w.g_rs + h, sizeof(float) * 2 * h, dout, sizeof(float) * h,
                            sizeof(float) * h, rows, cudaMemcpyDeviceToDevice, stream));
  return wn_reverse_walk(d, w, stream);
}

// Backward of one block from zp, skipm and the WN residuals (the math of
// block_pallas._block_bwd_math).
int block_bwd_chain(const Dims& d, const WnWalk& w, const float* x, const float* w_e,
                    const float* b_e, const float* a_t, const float* w_s_t,
                    const float* w_e_t, const float* zp, const float* skipm,
                    const float* dz, const float* dld, int sigmoid_scale, float* dx,
                    float* da, float* dba, float* dws, float* dbs, float* dwe,
                    float* dbe, float* dout, float* dzp, cudaStream_t stream) {
  const int batch = d.batch, t = d.t, c = d.c, h = d.h;
  const int rows = batch * t;
  const int c2 = c / 2;
  const int h2 = 2 * h;
  const float* mask = w.mask;
  float* gx = w.gx;
  GTT_TRY(cudaMemsetAsync(w.g_rs, 0, sizeof(float) * rows * h2, stream));
  GTT_TRY(cudaMemsetAsync(gx, 0, sizeof(float) * rows * h, stream));

  // ---- coupling + end conv: logs rebuilt from skipm, then its backward ----
  {
    ConvGemm g = rows_gemm(d, skipm, h, h, w_e + c2, b_e + c2, c2,
                           kCouplingBwd, dout, c, mask);
    g.ldb = c; g.split = c2; g.flag = sigmoid_scale;
    g.aux = dz; g.ld_aux = c; g.aux2 = zp; g.aux3 = dld; g.out2 = dzp; g.ldo2 = c;
    GTT_TRY(conv_gemm(g, stream));
  }
  GTT_TRY(wgrad(wgrad_of(skipm, h, h, batch, t, dout, c, c, dwe, w.wg_scratch,
                         w.wg_scratch_floats), stream));
  GTT_TRY(bias_grad(dout, c, c, nullptr, batch, t, w.col_part, dbe, stream));
  // dskip = (dout @ W_e^T) * mask -> the skip half of g_rs
  GTT_TRY(conv_gemm(rows_gemm(d, dout, c, c, w_e_t, nullptr, h, kBiasMask,
                              w.g_rs + h, h2, mask), stream));

  {
    const int err = wn_reverse_walk(d, w, stream);
    if (err != 0) return err;
  }

  // ---- start conv: d_pre = gx * mask ----
  {
    WGrad g = wgrad_of(zp, c, c2, batch, t, gx, h, h, dws, w.wg_scratch, w.wg_scratch_floats);
    g.dy_mask = mask;
    GTT_TRY(wgrad(g, stream));
  }
  GTT_TRY(bias_grad(gx, h, h, mask, batch, t, w.col_part, dbs, stream));
  {  // dzp[:, :c2] = (dz0 + d_pre @ W_s^T) * mask
    ConvGemm g = rows_gemm(d, gx, h, h, w_s_t, nullptr, c2, kResidMask, dzp, c, mask);
    g.a_mask = mask; g.aux = dz; g.ld_aux = c;
    GTT_TRY(conv_gemm(g, stream));
  }

  // ---- folded actnorm/invconv: zp = (x @ A + bA) * mask ----
  GTT_TRY(wgrad(wgrad_of(x, c, c, batch, t, dzp, c, c, da, w.wg_scratch, w.wg_scratch_floats),
                stream));
  GTT_TRY(bias_grad(dzp, c, c, nullptr, batch, t, w.col_part, dba, stream));
  GTT_TRY(conv_gemm(rows_gemm(d, dzp, c, c, a_t, nullptr, c, kBias, dx, c, nullptr),
                    stream));
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
  GTT_TRY(cudaMemsetAsync(skip, 0, sizeof(float) * rh, stream));
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
  GTT_TRY(cudaMemsetAsync(skip, 0, sizeof(float) * rh, stream));
  GTT_TRY(wn_layers(wn_stack(d, wn, mask, xs, th, sg, acts, skip, 0), stream));
  return (int)cudaGetLastError();
}

extern "C" int gtt_wn_bwd_store(
    const float* mask, const float* w_in_t, const float* w_rs_t, const float* xs,
    const float* th, const float* sg, const float* dout, float* dx, float* dwin,
    float* dbin, float* dwrs, float* dbrs, float* dg, float* g_rs, float* dia,
    float* dxin, float* acts, float* col_part, float* wg_scratch,
    int wg_scratch_floats, int batch, int t, int h, int n_layers, int taps,
    int dilation_rate, int drop, int seed, unsigned threshold, float scale,
    cudaStream_t stream) {
  const Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale),
               wg_scratch, wg_scratch_floats};
  const WnWalk w{mask, w_in_t, w_rs_t, xs, th, sg, g_rs, dia, dxin, acts, dx,
                 col_part, wg_scratch, wg_scratch_floats, dwin, dbin, dwrs, dbrs, dg};
  return wn_bwd_chain(d, w, dout, stream);
}

// Recompute: the forward-save chain into scratch (xs / th / sg), then the
// same walk.  The TPU kernel also keeps the keep masks in scratch; here
// they are replayed from the seed.  dia serves as the recompute's skip sum.
extern "C" int gtt_wn_bwd(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all,
    const float* w_in_t, const float* w_rs_t, const float* dout, float* dx,
    float* dwin, float* dbin, float* dwrs, float* dbrs, float* dg, float* xs,
    float* th, float* sg, float* g_rs, float* dia, float* dxin, float* acts,
    float* col_part, float* wg_scratch, int wg_scratch_floats, int g_stride,
    int batch, int t, int h, int n_layers, int taps, int dilation_rate,
    int drop, int seed, unsigned threshold, float scale, cudaStream_t stream) {
  const Dims d{batch, t, 0, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale),
               wg_scratch, wg_scratch_floats};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  const long rh = (long)batch * t * h;
  GTT_TRY(cudaMemcpyAsync(xs, x, sizeof(float) * rh, cudaMemcpyDeviceToDevice, stream));
  GTT_TRY(cudaMemsetAsync(dia, 0, sizeof(float) * rh, stream));
  GTT_TRY(wn_layers(wn_stack(d, wn, mask, xs, th, sg, acts, dia, 0), stream));
  const WnWalk w{mask, w_in_t, w_rs_t, xs, th, sg, g_rs, dia, dxin, acts, dx,
                 col_part, wg_scratch, wg_scratch_floats, dwin, dbin, dwrs, dbrs, dg};
  return wn_bwd_chain(d, w, dout, stream);
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

extern "C" int gtt_block_bwd_store(
    const float* x, const float* mask, const float* w_e, const float* b_e,
    const float* a_t, const float* w_s_t, const float* w_e_t,
    const float* w_in_t, const float* w_rs_t, const float* zp,
    const float* skipm, const float* xs, const float* th, const float* sg,
    const float* dz, const float* dld, float* dx, float* da, float* dba,
    float* dws, float* dbs, float* dwe, float* dbe, float* dwin, float* dbin,
    float* dwrs, float* dbrs, float* dg, float* dout, float* dzp, float* g_rs,
    float* dia, float* dxin, float* acts, float* gx, float* col_part,
    float* wg_scratch, int wg_scratch_floats, int batch, int t, int c, int h,
    int n_layers, int taps, int dilation_rate, int sigmoid_scale, int drop,
    int seed, unsigned threshold, float scale, cudaStream_t stream) {
  const Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale),
               wg_scratch, wg_scratch_floats};
  const WnWalk w{mask, w_in_t, w_rs_t, xs, th, sg, g_rs, dia, dxin, acts, gx,
                 col_part, wg_scratch, wg_scratch_floats, dwin, dbin, dwrs, dbrs, dg};
  return block_bwd_chain(d, w, x, w_e, b_e, a_t, w_s_t, w_e_t, zp, skipm, dz, dld,
                         sigmoid_scale, dx, da, dba, dws, dbs, dwe, dbe, dout, dzp, stream);
}

// Recompute: the forward-save chain into scratch (zp, skipm, xs / th / sg;
// no z, no ld), then the store backward's chain on it.
extern "C" int gtt_block_bwd(
    const float* x, const float* mask, const float* a, const float* ba,
    const float* w_s, const float* b_s, const float* w_e, const float* b_e,
    const float* w_in, const float* b_in, const float* w_rs, const float* b_rs,
    const float* g_all, const float* a_t, const float* w_s_t, const float* w_e_t,
    const float* w_in_t, const float* w_rs_t, const float* dz, const float* dld,
    float* dx, float* da, float* dba, float* dws, float* dbs, float* dwe,
    float* dbe, float* dwin, float* dbin, float* dwrs, float* dbrs, float* dg,
    float* zp, float* skipm, float* xs, float* th, float* sg, float* dout,
    float* dzp, float* g_rs, float* dia, float* dxin, float* acts, float* gx,
    float* col_part, float* wg_scratch, int wg_scratch_floats, int g_stride,
    int batch, int t, int c, int h, int n_layers, int taps, int dilation_rate,
    int sigmoid_scale, int drop, int seed, unsigned threshold, float scale,
    cudaStream_t stream) {
  const Dims d{batch, t, c, h, n_layers, taps, dilation_rate,
               make_dropout(drop, seed, n_layers, threshold, scale),
               wg_scratch, wg_scratch_floats};
  const WnWeights wn{w_in, b_in, w_rs, b_rs, g_all, g_stride};
  const int err = block_fwd_chain(d, x, mask, a, ba, w_s, b_s, w_e, b_e, wn, sigmoid_scale,
                                  nullptr, nullptr, zp, skipm, xs, th, sg, acts, nullptr,
                                  nullptr, stream);
  if (err != 0) return err;
  const WnWalk w{mask, w_in_t, w_rs_t, xs, th, sg, g_rs, dia, dxin, acts, gx,
                 col_part, wg_scratch, wg_scratch_floats, dwin, dbin, dwrs, dbrs, dg};
  return block_bwd_chain(d, w, x, w_e, b_e, a_t, w_s_t, w_e_t, zp, skipm, dz, dld,
                         sigmoid_scale, dx, da, dba, dws, dbs, dwe, dbe, dout, dzp, stream);
}
