// The text-side conv stacks, counterparts of
// glow_tts_train_tpu/ops/text_pallas.py::_prenet_fwd_kernel (math:
// _prenet_fwd_math) and ::_dp_fwd_kernel (math: _dp_fwd_math).
//
// Each TPU kernel keeps a sample's whole stack in VMEM; here each layer is a
// conv_gemm with its k-tap im2col gathered on load, then a row-wise
// layer_norm, so only [rows, width] activations pass through device memory
// (L2 at serving sizes).
//
// The prenet's products (M = batch * t, K = 5 * 192, N = 192 at base width)
// ask for the tensor cores (3xTF32, tc_gemm.cu) with split-K, as the
// encoder layer's do (text_product): at t_x <= 192 they are short and deep,
// so the K walk is cut into shares where that makes fewer waves.  The
// tensor-core conv-GEMM takes no input mask on a tap gather, so every conv
// input is stored masked: x * mask once (mask_rows), then each layer's
// LayerNorm writes its output times the mask.  A gather of a masked input
// is the same sum as the gather with the mask, so each product is the one
// it was, up to the tensor cores' rounding.  The chain's weights are split
// in one launch (presplit_weights).  A lone short sentence (b=1) has too
// few row tiles: its products are declined to the CUDA cores, as before.
// The duration stack's products (M = batch * t, K = 3 * (192 + gin) and
// 3 * 256, N = 256) take the same design: x * mask once, layer 0's
// LayerNorm writes its output times the mask (layer 1's conv input), the
// two convs' weights split in one launch, split-K by the text chains' plan,
// one scratch block a call (gtt_duration_scratch_floats).
//
// The bf16 chains (fp16_run; text_pallas.py with dtype bf16) run every
// product on the TMA-fed wgmma kernel (bf16_gemm.cu, ConvGemm::tma_ring,
// by tma_conv_plan: chunks a tile and split-K shares for the short, deep
// text shapes; narrower than 64 channels or columns the mma.sync kernel,
// by shape alone), as the encoder layer's do.  TMA copies bytes as they
// lie, so each operand is a bf16 tensor that the kernel producing it
// writes, rounded once where the JAX kernel casts (xm = (x * mask).astype
// (dtype)): mask_rows writes x * mask in bf16 (exact: x is bf16 and the
// mask 0 or 1), each LayerNorm its masked output (out_masked, kOutM16);
// the weights are read as they lie.  No weights are split.
//
// Training dropout is the TPU kernels' per-site keep mask, applied in the
// LayerNorm's store: the prenet's site l (of L) drops layer l's ReLU output
// [t, h]; the duration stack's site l (of 2) drops layer l's LayerNorm
// output [t, f].
#include <algorithm>

#include "text.cuh"

namespace gtt {

namespace {

__global__ void mask_rows_kernel(const float* x, const float* mask, float* out, long rows,
                                 int n, int b16) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows * n) st_act(out, i, ld_act(x, i, b16 != 0) * mask[i / n], b16 != 0);
}

// 16-byte multiples, so every carved buffer stays aligned for the tensor cores
long round4(long floats) { return (floats + 3) / 4 * 4; }

// A carver of one scratch block: take(p, floats) or, for a bf16 buffer,
// take16(p, elements); with base null it only counts.
struct Carver {
  float* base;
  long used = 0;
  void take(float*& p, long floats) {
    p = base ? base + used : nullptr;
    used += round4(floats);
  }
  void take16(float*& p, long elems) { take(p, (elems + 1) / 2); }
};

}  // namespace

cudaError_t mask_rows(const float* x, const float* mask, float* out, long rows, int n,
                      bool bf16, cudaStream_t stream) {
  const long total = rows * n;
  if (total <= 0) return cudaSuccess;
  mask_rows_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(x, mask, out, rows, n,
                                                                        bf16 ? 1 : 0);
  return cudaGetLastError();
}

long prenet_scratch(float* base, const PrenetDims& d, bool backward, PrenetScratch* s) {
  Carver c{base};
  const long rows = d.rows(), h = d.h, L = d.n_layers;
  c.take(s->xm, rows * h);
  c.take(s->pre, rows * h);
  c.take(s->curm, (backward ? std::max(L, 1L) : 1) * rows * h);
  // the K-major splits of the L convs' and the projection's weights, for
  // the forward's products and the backward's transposed ones (16 floats of
  // alignment each), and the split-K partial sums
  s->tc_floats = 2 * (2 * (L * d.taps * h * h + h * h) + (L + 1) * 16);
  c.take(s->tc, s->tc_floats);
  c.take(s->part, kSplitKCols * rows);
  if (backward) {
    c.take(s->xhat, std::max(L, 1L) * rows * h);
    c.take(s->rstd, std::max(L, 1L) * rows);
    c.take(s->dcur, rows * h);
    c.take(s->dpre, rows * h);
    c.take(s->col_part, (long)d.batch * h);
    s->wg_floats = std::max(1L << 22, d.taps * h * h);
    c.take(s->wg, s->wg_floats);
    c.take16(s->dpre16, rows * h);
    c.take16(s->dout16, rows * h);
  }
  return c.used;
}

// ConvReluNorm prenet: n_layers x [conv(x * mask) -> LN -> ReLU -> drop],
// then out = (x + cur @ wp + bp) * mask.
cudaError_t prenet_forward(const PrenetArgs& a, cudaStream_t stream) {
  const PrenetDims& d = a.dims;
  const PrenetScratch& s = a.s;
  const long rows = d.rows();
  const int h = d.h, L = d.n_layers;
  if (L > kMaxPrenetLayers) return cudaErrorInvalidValue;
  // layer l's masked output: the next conv's input
  auto curm = [&](int l) { return a.save ? s.curm + l * rows * h : s.curm; };
  ConvGemm g[kMaxPrenetLayers + 1];
  ConvGemm* products[kMaxPrenetLayers + 1];
  for (int l = 0; l <= L; ++l) {
    g[l] = text_chain_product(s, a.bf16);
    g[l].lda = h; g[l].c_in = h; g[l].batch = d.batch; g[l].t = d.t; g[l].n = h;
    g[l].ldo = h;
    products[l] = &g[l];
  }
  // a bf16 call's products: bf16 operands (the masked inputs' copies) and
  // weights
  const unsigned bf = a.bf16 ? kBf16 | kA16 | kW16 : 0u;
  for (int l = 0; l < L; ++l) {  // pre = conv(x * mask) + b
    g[l].a = l ? curm(l - 1) : s.xm; g[l].taps = d.taps;
    g[l].w = elem_at(a.w, (long)l * d.taps * h * h, a.bf16); g[l].bias = a.b + l * h;
    g[l].epilogue = kBias; g[l].out = s.pre;
    g[l].bf16 = bf;
  }
  ConvGemm& proj = g[L];  // out = (x + cur @ wp + bp) * mask (cur masked: same rows)
  proj.a = L ? curm(L - 1) : a.x; proj.w = a.wp; proj.bias = a.bp;
  proj.epilogue = kResidMask; proj.out = a.out; proj.mask = a.mask; proj.aux = a.x;
  proj.ld_aux = h;
  proj.bf16 = bf ? bf | kOut16 | kAux16 : 0u;
  cudaError_t err = cudaSuccess;
  if (!a.bf16 &&
      (err = presplit_weights(products, L + 1, s.tc, s.tc_floats / 2, stream)) != cudaSuccess)
    return err;

  if (L > 0 && (err = mask_rows(a.x, a.mask, s.xm, rows, h, a.bf16, stream)) != cudaSuccess)
    return err;
  for (int l = 0; l < L; ++l) {
    if ((err = conv_gemm(g[l], stream)) != cudaSuccess) return err;
    LayerNorm ln;
    ln.x = s.pre; ln.gamma = a.gamma + l * h; ln.beta = a.beta + l * h;
    ln.out = a.save ? a.cur + l * rows * h : nullptr;
    ln.out_masked = curm(l); ln.out_mask = a.mask;
    ln.bf16 = a.bf16 ? kOutM16 : 0u;  // xm = (xcur * mask).astype(bf16)
    ln.rows = (int)rows; ln.n = h; ln.relu_after = 1;
    ln.t = d.t; ln.drop = a.drop.at(l);
    if (a.save) { ln.xhat = s.xhat + l * rows * h; ln.rstd = s.rstd + l * rows; }
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
  }
  return conv_gemm(proj, stream);
}

long duration_scratch(float* base, const DurationDims& d, bool backward, DurationScratch* s) {
  Carver c{base};
  const long rows = d.rows(), f = d.f;
  const long conv_weights = (long)d.taps * (d.c_in + f) * f;
  c.take(s->xm, rows * d.c_in);
  c.take(s->pre, rows * f);
  c.take(s->curm, rows * f);
  // the K-major splits of the two convs' weights, and in the backward of
  // the two transposed convs' too (16 floats of alignment each), and the
  // split-K partial sums
  s->tc_floats = 2 * (2 * conv_weights + 2 * 16);
  c.take(s->tc, s->tc_floats);
  c.take(s->part, kSplitKCols * rows);
  if (backward) {
    c.take(s->xhat, 2 * rows * f);
    c.take(s->rstd, 2 * rows);
    c.take(s->dcur, rows * f);
    c.take(s->dpre, rows * f);
    s->wg_floats = std::max(1L << 22, (long)d.taps * std::max(d.c_in, d.f) * f);
    c.take(s->wg, s->wg_floats);
    c.take16(s->dpre16, rows * f);
  }
  return c.used;
}

void duration_convs(const DurationArgs& a, ConvGemm (&g)[2]) {
  const DurationDims& d = a.dims;
  for (int l = 0; l < 2; ++l) {  // relu = max(conv(input * mask) + b, 0)
    const int width = l ? d.f : d.c_in;
    ConvGemm& p = g[l] = text_chain_product(a.s, a.bf16);
    p.a = l ? a.s.curm : a.s.xm; p.lda = width; p.c_in = width; p.taps = d.taps;
    p.batch = d.batch; p.t = d.t; p.w = a.w[l]; p.bias = a.b[l]; p.n = d.f;
    p.epilogue = kBiasRelu; p.out = a.save ? a.relu + l * d.rows() * d.f : a.s.pre;
    p.ldo = d.f;
    p.bf16 = a.bf16 ? kBf16 | kA16 | kW16 : 0u;  // bf16: the masked inputs' copies
  }
}

// Duration-predictor stack without its 1-channel projection:
// 2 x [conv(x * mask) -> ReLU -> LN -> drop].
cudaError_t duration_forward(const DurationArgs& a, const ConvGemm (&g)[2],
                             cudaStream_t stream) {
  const DurationDims& d = a.dims;
  const DurationScratch& s = a.s;
  const long rows = d.rows();
  cudaError_t err;
  if ((err = mask_rows(a.x, a.mask, s.xm, rows, d.c_in, a.bf16, stream)) != cudaSuccess)
    return err;
  for (int l = 0; l < 2; ++l) {
    if ((err = conv_gemm(g[l], stream)) != cudaSuccess) return err;
    // layer 0 writes only its masked output, layer 1's conv input; layer 1
    // the stack's output
    LayerNorm ln;
    ln.x = g[l].out; ln.gamma = a.gamma[l]; ln.beta = a.beta[l];
    if (l == 0) {
      ln.out_masked = s.curm; ln.out_mask = a.mask;
      ln.bf16 = a.bf16 ? kOutM16 : 0u;
    } else {
      ln.out = a.out;
      ln.bf16 = a.bf16 ? kOut16 : 0u;
    }
    ln.rows = (int)rows; ln.n = d.f; ln.t = d.t; ln.drop = a.drop.at(l);
    if (a.save) { ln.xhat = s.xhat + l * rows * d.f; ln.rstd = s.rstd + l * rows; }
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace gtt

namespace {

gtt::PrenetDims prenet_dims(int batch, int t, int h, int n_layers, int taps) {
  gtt::PrenetDims d;
  d.batch = batch; d.t = t; d.h = h; d.n_layers = n_layers; d.taps = taps;
  return d;
}

}  // namespace

// Floats of one call's scratch block (backward 0: gtt_prenet, 1:
// gtt_prenet_bwd).
extern "C" long long gtt_prenet_scratch_floats(int batch, int t, int h, int n_layers, int taps,
                                               int backward) {
  gtt::PrenetScratch s;
  return gtt::prenet_scratch(nullptr, prenet_dims(batch, t, h, n_layers, taps), backward != 0,
                             &s);
}

namespace {

int prenet_entry(const float* x, const float* mask, const float* w, const float* b,
                 const float* gamma, const float* beta, const float* wp, const float* bp,
                 float* out, float* scratch, long long scratch_floats, int batch, int t, int h,
                 int n_layers, int taps, int drop, int seed, unsigned threshold, float scale,
                 bool bf16, cudaStream_t stream) {
  gtt::PrenetArgs a;
  a.bf16 = bf16;
  a.x = x; a.mask = mask; a.w = w; a.b = b; a.gamma = gamma; a.beta = beta;
  a.wp = wp; a.bp = bp; a.out = out;
  a.dims = prenet_dims(batch, t, h, n_layers, taps);
  if (gtt::prenet_scratch(scratch, a.dims, false, &a.s) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = gtt::make_dropout(drop, seed, n_layers, threshold, scale);
  const cudaError_t err = gtt::prenet_forward(a, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Scratch: one block of gtt_prenet_scratch_floats(..., 0) floats.
extern "C" int gtt_prenet(const float* x, const float* mask, const float* w,
                          const float* b, const float* gamma,
                          const float* beta, const float* wp, const float* bp,
                          float* out, float* scratch, long long scratch_floats, int batch,
                          int t, int h, int n_layers, int taps, int drop, int seed,
                          unsigned threshold, float scale, cudaStream_t stream) {
  return prenet_entry(x, mask, w, b, gamma, beta, wp, bp, out, scratch, scratch_floats, batch,
                      t, h, n_layers, taps, drop, seed, threshold, scale, false, stream);
}

// The same in bf16 (x, w, wp, out bf16; PrenetArgs::bf16).
extern "C" int gtt_prenet_bf16(const float* x, const float* mask, const float* w,
                               const float* b, const float* gamma,
                               const float* beta, const float* wp, const float* bp,
                               float* out, float* scratch, long long scratch_floats, int batch,
                               int t, int h, int n_layers, int taps, int drop, int seed,
                               unsigned threshold, float scale, cudaStream_t stream) {
  return prenet_entry(x, mask, w, b, gamma, beta, wp, bp, out, scratch, scratch_floats, batch,
                      t, h, n_layers, taps, drop, seed, threshold, scale, true, stream);
}

// Floats of one call's scratch block (backward 0: gtt_duration_stack, 1:
// gtt_duration_stack_bwd).
extern "C" long long gtt_duration_scratch_floats(int batch, int t, int c_in, int f, int taps,
                                                 int backward) {
  gtt::DurationDims d;
  d.batch = batch; d.t = t; d.c_in = c_in; d.f = f; d.taps = taps;
  gtt::DurationScratch s;
  return gtt::duration_scratch(nullptr, d, backward != 0, &s);
}

namespace {

int duration_entry(const float* x, const float* mask, const float* w1, const float* b1,
                   const float* gamma1, const float* beta1, const float* w2, const float* b2,
                   const float* gamma2, const float* beta2, float* out, float* scratch,
                   long long scratch_floats, int batch, int t, int c_in, int f, int taps,
                   int drop, int seed, unsigned threshold, float scale, bool bf16,
                   cudaStream_t stream) {
  gtt::DurationArgs a;
  a.bf16 = bf16;
  a.x = x; a.mask = mask;
  a.w[0] = w1; a.b[0] = b1; a.gamma[0] = gamma1; a.beta[0] = beta1;
  a.w[1] = w2; a.b[1] = b2; a.gamma[1] = gamma2; a.beta[1] = beta2;
  a.out = out;
  a.dims.batch = batch; a.dims.t = t; a.dims.c_in = c_in; a.dims.f = f; a.dims.taps = taps;
  if (gtt::duration_scratch(scratch, a.dims, false, &a.s) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = gtt::make_dropout(drop, seed, 2, threshold, scale);
  gtt::ConvGemm g[2];
  gtt::duration_convs(a, g);
  gtt::ConvGemm* products[2] = {&g[0], &g[1]};
  cudaError_t err =
      bf16 ? cudaSuccess : gtt::presplit_weights(products, 2, a.s.tc, a.s.tc_floats, stream);
  if (err == cudaSuccess) err = gtt::duration_forward(a, g, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// Scratch: one block of gtt_duration_scratch_floats(..., 0) floats.
extern "C" int gtt_duration_stack(const float* x, const float* mask,
                                  const float* w1, const float* b1,
                                  const float* gamma1, const float* beta1,
                                  const float* w2, const float* b2,
                                  const float* gamma2, const float* beta2,
                                  float* out, float* scratch, long long scratch_floats,
                                  int batch, int t, int c_in, int f, int taps, int drop,
                                  int seed, unsigned threshold, float scale,
                                  cudaStream_t stream) {
  return duration_entry(x, mask, w1, b1, gamma1, beta1, w2, b2, gamma2, beta2, out, scratch,
                        scratch_floats, batch, t, c_in, f, taps, drop, seed, threshold, scale,
                        false, stream);
}

// The same in bf16 (x, w1, w2, out bf16; DurationArgs::bf16).
extern "C" int gtt_duration_stack_bf16(const float* x, const float* mask,
                                       const float* w1, const float* b1,
                                       const float* gamma1, const float* beta1,
                                       const float* w2, const float* b2,
                                       const float* gamma2, const float* beta2,
                                       float* out, float* scratch, long long scratch_floats,
                                       int batch, int t, int c_in, int f, int taps, int drop,
                                       int seed, unsigned threshold, float scale,
                                       cudaStream_t stream) {
  return duration_entry(x, mask, w1, b1, gamma1, beta1, w2, b2, gamma2, beta2, out, scratch,
                        scratch_floats, batch, t, c_in, f, taps, drop, seed, threshold, scale,
                        true, stream);
}
