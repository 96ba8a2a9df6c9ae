// The training direction of the flow block and the WN stack forward:
//
//  * gtt_wn_forward     <- glow_tts_train_tpu/ops/wn_pallas.py::_fwd_kernel
//  * gtt_block_fwd_save <- ops/block_pallas.py::_block_fwd_save_kernel
//  * gtt_block_bwd_store <- ops/block_pallas.py::_block_bwd_store_kernel
//                          (math _block_bwd_math, WN wn_pallas._reverse_walk)
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
// Bound on the card: f32 FMA throughput of the in-layer conv products
// (forward one, backward three per layer at K = 5 * 192, N = 384); the TPU
// kernels keep a sample's block and its weight-gradient accumulators in
// VMEM, here every product streams its operands through L2 and only the
// [rows, h] / [rows, 2h] activations and the saved residuals reach device
// memory.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using gtt::ConvGemm;

#define GTT_TRY(expr)                               \
  do {                                              \
    const cudaError_t err_ = (expr);                \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

ConvGemm rows_gemm(const float* a, int lda, int c_in, int batch, int t,
                   const float* w, const float* bias, int n, int epilogue,
                   float* out, int ldo, const float* mask) {
  ConvGemm g;
  g.a = a; g.lda = lda; g.c_in = c_in; g.batch = batch; g.t = t;
  g.w = w; g.bias = bias; g.n = n; g.epilogue = epilogue;
  g.out = out; g.ldo = ldo; g.mask = mask;
  return g;
}

gtt::WGrad wgrad_of(const float* a, int lda, int c_in, int batch, int t,
                    const float* dy, int ldy, int n, float* out,
                    float* scratch, long scratch_floats) {
  gtt::WGrad w;
  w.a = a; w.lda = lda; w.c_in = c_in; w.batch = batch; w.t = t;
  w.dy = dy; w.ldy = ldy; w.n = n; w.out = out;
  w.scratch = scratch; w.scratch_floats = scratch_floats;
  return w;
}

}  // namespace

extern "C" int gtt_wn_forward(
    const float* x, const float* mask, const float* w_in, const float* b_in,
    const float* w_rs, const float* b_rs, const float* g_all, float* skip,
    float* xcur, float* acts, int g_stride, int batch, int t, int h,
    int n_layers, int taps, int dilation_rate, cudaStream_t stream) {
  using namespace gtt;
  const long rh = (long)batch * t * h;
  GTT_TRY(cudaMemcpyAsync(xcur, x, sizeof(float) * rh, cudaMemcpyDeviceToDevice, stream));
  GTT_TRY(cudaMemsetAsync(skip, 0, sizeof(float) * rh, stream));
  GTT_TRY(wn_layers(xcur, acts, skip, mask, w_in, b_in, w_rs, b_rs, g_all, g_stride,
                    batch, t, h, n_layers, taps, dilation_rate, stream));
  return (int)cudaGetLastError();
}

extern "C" int gtt_block_fwd_save(
    const float* x, const float* mask, const float* a, const float* ba,
    const float* w_s, const float* b_s, const float* w_e, const float* b_e,
    const float* w_in, const float* b_in, const float* w_rs, const float* b_rs,
    const float* g_all, float* z, float* ld, float* zp, float* skipm, float* xs,
    float* th, float* sg, float* acts, float* logsm, float* ld_part,
    int g_stride, int batch, int t, int c, int h, int n_layers, int taps,
    int dilation_rate, int sigmoid_scale, int drop, int seed,
    unsigned threshold, float scale, cudaStream_t stream) {
  using namespace gtt;
  const int rows = batch * t;
  const int c2 = c / 2;
  const long rh = (long)rows * h;
  GTT_TRY(cudaMemsetAsync(skipm, 0, sizeof(float) * rh, stream));
  // zp = (x @ A + bA) * mask
  GTT_TRY(conv_gemm(rows_gemm(x, c, c, batch, t, a, ba, c, kBiasMask, zp, c, mask), stream));
  // xs[0] = (x0 @ W_s + b_s) * mask
  GTT_TRY(conv_gemm(rows_gemm(zp, c, c2, batch, t, w_s, b_s, h, kBiasMask, xs, h, mask), stream));
  int dilation = 1;
  for (int l = 0; l < n_layers; ++l) {
    float* x_l = xs + l * rh;
    ConvGemm g = rows_gemm(x_l, h, h, batch, t, w_in + (long)l * taps * h * 2 * h,
                           b_in + l * 2 * h, 2 * h, kGateSave, acts, h, nullptr);
    g.taps = taps; g.dilation = dilation; g.split = h;
    g.out2 = th + l * rh; g.ldo2 = h; g.out3 = sg + l * rh; g.ldo3 = h;
    if (g_all) { g.aux = g_all + l * 2 * h; g.ld_aux = g_stride; }
    g.drop = make_dropout(drop, seed, n_layers, threshold, scale).at(l);
    GTT_TRY(conv_gemm(g, stream));
    const bool last = l == n_layers - 1;
    ConvGemm r = rows_gemm(acts, h, h, batch, t, w_rs + (long)l * h * 2 * h,
                           b_rs + l * 2 * h, 2 * h, kResSkip,
                           last ? x_l : x_l + rh, h, mask);
    r.split = h; r.aux = x_l; r.ld_aux = h; r.out2 = skipm; r.ldo2 = h;
    r.flag = !last;       // the last layer's residual half is zero
    r.skip_mask = last;   // skipm = skip * mask once the sum is complete
    GTT_TRY(conv_gemm(r, stream));
    dilation *= dilation_rate;
  }
  // z = [x0 | (m + e^logs * x1) * mask], logsm = logs * mask
  GTT_TRY(cudaMemcpyAsync(z, zp, sizeof(float) * rows * c, cudaMemcpyDeviceToDevice, stream));
  ConvGemm e = rows_gemm(skipm, h, h, batch, t, w_e, b_e, c, kCouplingFwd, z + c2, c, mask);
  e.split = c2; e.flag = sigmoid_scale; e.out2 = logsm; e.ldo2 = c2;
  GTT_TRY(conv_gemm(e, stream));
  // ld[b] = sum over the sample's rows and columns of logs * mask
  GTT_TRY(col_sum(logsm, c2, c2, nullptr, batch, t, ld_part, c2, stream));
  GTT_TRY(col_sum(ld_part, 1, 1, nullptr, batch, c2, ld, 1, stream));
  return (int)cudaGetLastError();
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
    int seed, int with_g, unsigned threshold, float scale,
    cudaStream_t stream) {
  using namespace gtt;
  const int rows = batch * t;
  const int c2 = c / 2;
  const int h2 = 2 * h;
  const long rh = (long)rows * h;
  GTT_TRY(cudaMemsetAsync(g_rs, 0, sizeof(float) * rows * h2, stream));
  GTT_TRY(cudaMemsetAsync(gx, 0, sizeof(float) * rh, stream));

  // ---- coupling + end conv: logs rebuilt from skipm, then its backward ----
  {
    ConvGemm g = rows_gemm(skipm, h, h, batch, t, w_e + c2, b_e + c2, c2,
                           kCouplingBwd, dout, c, mask);
    g.ldb = c; g.split = c2; g.flag = sigmoid_scale;
    g.aux = dz; g.ld_aux = c; g.aux2 = zp; g.aux3 = dld; g.out2 = dzp; g.ldo2 = c;
    GTT_TRY(conv_gemm(g, stream));
  }
  GTT_TRY(wgrad(wgrad_of(skipm, h, h, batch, t, dout, c, c, dwe, wg_scratch,
                         wg_scratch_floats), stream));
  GTT_TRY(bias_grad(dout, c, c, nullptr, batch, t, col_part, dbe, stream));
  // dskip = (dout @ W_e^T) * mask -> the skip half of g_rs
  GTT_TRY(conv_gemm(rows_gemm(dout, c, c, batch, t, w_e_t, nullptr, h, kBiasMask,
                              g_rs + h, h2, mask), stream));

  // ---- WN reverse walk ----
  int dilation = 1;
  for (int l = 0; l < n_layers - 1; ++l) dilation *= dilation_rate;
  for (int l = n_layers - 1; l >= 0; --l) {
    {  // da = g_rs @ W_rs^T, gate backward in the epilogue
      ConvGemm g = rows_gemm(g_rs, h2, h2, batch, t, w_rs_t + (long)l * h2 * h,
                             nullptr, h, kGateBwd, dia, h2, nullptr);
      g.split = h; g.aux = th + l * rh; g.aux2 = sg + l * rh; g.ld_aux = h;
      g.out2 = dxin; g.ldo2 = h2; g.out3 = acts; g.ldo3 = h;
      g.drop = make_dropout(drop, seed, n_layers, threshold, scale).at(l);
      GTT_TRY(conv_gemm(g, stream));
    }
    GTT_TRY(wgrad(wgrad_of(acts, h, h, batch, t, g_rs, h2, h2,
                           dwrs + (long)l * h * h2, wg_scratch, wg_scratch_floats),
                  stream));
    GTT_TRY(bias_grad(g_rs, h2, h2, nullptr, batch, t, col_part, dbrs + l * h2, stream));
    if (with_g)
      GTT_TRY(col_sum(dia, h2, h2, nullptr, batch, t, dg + l * h2, n_layers * h2, stream));
    GTT_TRY(bias_grad(dxin, h2, h2, nullptr, batch, t, col_part, dbin + l * h2, stream));
    {
      WGrad w = wgrad_of(xs + l * rh, h, h, batch, t, dxin, h2, h2,
                         dwin + (long)l * taps * h * h2, wg_scratch, wg_scratch_floats);
      w.taps = taps; w.dilation = dilation;
      GTT_TRY(wgrad(w, stream));
    }
    {  // gx = gx * mask + transposed conv of d_xin; g_rs[:, :h] = gx * mask
      ConvGemm g = rows_gemm(dxin, h2, h2, batch, t, w_in_t + (long)l * taps * h2 * h,
                             nullptr, h, kAccumMask, gx, h, mask);
      g.taps = taps; g.dilation = dilation; g.tap_sign = -1;
      g.out2 = g_rs; g.ldo2 = h2;
      GTT_TRY(conv_gemm(g, stream));
    }
    if (dilation_rate > 0) dilation /= dilation_rate;
  }

  // ---- start conv: d_pre = gx * mask ----
  {
    WGrad w = wgrad_of(zp, c, c2, batch, t, gx, h, h, dws, wg_scratch, wg_scratch_floats);
    w.dy_mask = mask;
    GTT_TRY(wgrad(w, stream));
  }
  GTT_TRY(bias_grad(gx, h, h, mask, batch, t, col_part, dbs, stream));
  {  // dzp[:, :c2] = (dz0 + d_pre @ W_s^T) * mask
    ConvGemm g = rows_gemm(gx, h, h, batch, t, w_s_t, nullptr, c2, kResidMask, dzp, c, mask);
    g.a_mask = mask; g.aux = dz; g.ld_aux = c;
    GTT_TRY(conv_gemm(g, stream));
  }

  // ---- folded actnorm/invconv: zp = (x @ A + bA) * mask ----
  GTT_TRY(wgrad(wgrad_of(x, c, c, batch, t, dzp, c, c, da, wg_scratch, wg_scratch_floats),
                stream));
  GTT_TRY(bias_grad(dzp, c, c, nullptr, batch, t, col_part, dba, stream));
  GTT_TRY(conv_gemm(rows_gemm(dzp, c, c, batch, t, a_t, nullptr, c, kBias, dx, c, nullptr),
                    stream));
  return (int)cudaGetLastError();
}
