// Shared device building blocks of the kernels (f32 throughout).
//
// Every ported TPU kernel (prenet, encoder layer, duration predictor, the
// flow block in both directions, the WN stack) is a chain of the pieces here
// plus, for the encoder, the attention core in encoder.cu:
//
//  * conv_gemm: a tiled f32 GEMM (on the tensor cores by the 3xTF32 split
//    where a chain asks for it and the shape fits, see tc_gemm.cu; else on
//    the CUDA cores) whose A operand is an im2col view gathered
//    on load (tap offsets tap_sign*dilation*(k - K/2), zeros outside [0, t),
//    optional input mask), with the elementwise tail of each TPU kernel fused
//    into its epilogue (bias, ReLU, mask, residual, WaveNet gate with
//    dropout, residual/skip split, affine coupling both ways, and the
//    backward tails of the gate and the coupling).  With tap_sign -1 and
//    per-tap transposed weights it is the input gradient of a dilated conv.
//  * wgrad: the weight gradient im2col(A)^T dY of a conv or 1x1, a
//    reduction over all batch * t rows, split over rows into partial sums
//    that a second pass adds in a fixed order (no float atomics, so the
//    gradients are the same bits from run to run).
//  * col_sum: deterministic per-segment column sums (bias gradients, the
//    per-sample conditioning gradient, the coupling logdet); column_sums:
//    the same over all rows in one launch (the encoder layer's bias and
//    norm gradients).
//  * wn_layers: the WN stack's 2 conv_gemm launches per layer (gate, then
//    res/skip), with or without dropout and the per-layer saves, shared by
//    the flow block in both directions and the WN stack's own kernels.
//  * layer_norm: one warp per row over the channel axis (eps 1e-4, biased
//    variance), with an optional masked residual sum and ReLU before or after;
//    in training it drops its result and keeps the normalised input and the
//    inverse std.
//  * layer_norm_bwd: the closed-form LayerNorm backward, dx per row by one
//    warp, with the neighbouring ReLU and dropout tails (dgamma and dbeta
//    are column_sums of its outputs).
//
// Dropout keep masks are the JAX kernels' portable counter hash
// (wn_pallas.py _portable_bits, encoder_pallas.py _drop_keep): keep =
// hash(seed_s, row * n_cols + col) >= threshold, seed_s = (seed + sample) *
// n_sites + site in 32-bit wrap-around, over one sample's padded [t, n_cols]
// tensor.  The WN stack's sites are its layers and its tensor the [t, 2h]
// pre-gate (u | v); the text kernels' sites are listed in encoder.cu and
// text.cu.
//
// Activations are channels-last [batch * t, channels] row-major; weights are
// the JAX folds' [taps * c_in, n] row-major matrices; the tensor-core
// conv-GEMM lays each out K-major, split in two TF32 parts, per product.
#pragma once

#include <cuda_runtime.h>

namespace gtt {

struct Dropout {
  int on = 0;
  unsigned seed = 0;  // the call's seed; sample b draws from seed + b
  int site = 0;
  int n_sites = 1;
  unsigned threshold = 0;  // keep where bits >= threshold
  float scale = 1.f;       // 1 / (1 - p)
  __host__ __device__ Dropout at(int s) const {
    Dropout d = *this;
    d.site = s;
    return d;
  }
};

// The portable counter hash of wn_pallas.py _portable_bits (uint32 wrap).
__device__ __forceinline__ unsigned portable_bits(unsigned seed, unsigned idx) {
  unsigned x = idx ^ (seed * 2654435761u);
  x = (x ^ (x >> 13)) * 0x9E3779B1u;
  x = (x ^ (x >> 15)) * 0x85EBCA6Bu;
  return x ^ (x >> 16);
}

// Keep bit of element (row, col) of sample `sample`'s [t, n_cols] tensor.
__device__ __forceinline__ bool site_keep(const Dropout& d, int sample, int row,
                                          int n_cols, int col) {
  const unsigned seed =
      (d.seed + (unsigned)sample) * (unsigned)d.n_sites + (unsigned)d.site;
  return portable_bits(seed, (unsigned)row * (unsigned)n_cols + (unsigned)col) >=
         d.threshold;
}

// JAX: x * keepf * scale; the identity when the site is off.
__device__ __forceinline__ float site_drop(const Dropout& d, int sample, int row,
                                           int n_cols, int col, float v) {
  if (!d.on) return v;
  return site_keep(d, sample, row, n_cols, col) ? v * d.scale : 0.f;
}

inline Dropout make_dropout(int on, int seed, int n_sites, unsigned threshold,
                            float scale) {
  Dropout d;
  d.on = on;
  d.seed = (unsigned)seed;
  d.n_sites = n_sites;
  d.threshold = threshold;
  d.scale = scale;
  return d;
}

enum Epilogue : int {
  kBias = 0,         // out = acc + bias
  kBiasRelu = 1,     // out = max(acc + bias, 0)
  kBiasMask = 2,     // out = (acc + bias) * mask
  kResidMask = 3,    // out = (aux + acc + bias) * mask
  kGate = 4,         // out[:, j] = tanh(drop(u_j + b) + g) * sigmoid(drop(v_j + b) + g);
                     // out2 = tanh, out3 = sigmoid where given
  kResSkip = 5,      // out[:, :split] = (out + acc + b) * mask; out2 += acc + b
                     // (out2 = acc + b with skip_init)
  kCouplingInv = 6,  // out[:, j] = aux[:, j] (x0), out[:, split + j] =
                     // (aux[:, split + j] - m_j) * exp(-logs_j) * mask
  kCouplingFwd = 8,  // out[:, j] = (m_j + exp(logs_j) * out[:, j]) * mask;
                     // out2[:, j] = logs_j * mask
  kCouplingBwd = 9,  // from logs_raw: out = [dm | dlogs], out2[:, split + j] = dx1
  kGateBwd = 10,     // from da: out = d_in_act (where given), out2 = d_xin
                     // (dropped), out3 = acts; on the tensor cores out4 = d_xin's
                     // K-major 3xTF32 split where given
  kAccumMask = 11,   // out = out * mask + acc; out2 = that * mask
  kMaskReluBwd = 12, // out = aux > 0 ? acc * mask * drop.scale : 0 (aux: the
                     // dropped ReLU output, > 0 exactly where kept and active)
  kMaskAdd = 13,     // out = acc * mask + aux
  kBiasReluMask = 14,  // out = max(acc + bias, 0) * mask
};
// kBias, kBiasRelu, kBiasMask and kBiasReluMask drop their result when
// drop.on (site drop.site over the [t, n] output).

struct ConvGemm {
  // A: rows of a channels-last source [batch * t, lda]; the im2col column
  // tap * c_in + c of row (b, i) reads source row (b, i + (tap - taps/2) *
  // dilation), channel c, times a_mask of that source row when given.
  const float* a = nullptr;
  int lda = 0;
  int c_in = 0;
  const float* a_mask = nullptr;
  int taps = 1;
  int dilation = 1;
  int batch = 0;
  int t = 0;
  int tap_sign = 1;  // -1: taps at the negated offsets (transposed conv)
  // B: [taps * c_in, n] with row stride ldb (0: n), bias [n] or null (0).
  // w_t: w is a forward conv's [taps * n, c_in] and B its per-tap
  // transpose, B[tap * c_in + j, c] = w[tap * n + c, j] (the input
  // gradient of that conv, read without a transposed copy; ldb unused).
  const float* w = nullptr;
  int ldb = 0;
  int w_t = 0;
  const float* bias = nullptr;
  int n = 0;
  // kGate / kCouplingInv read output pairs (j, j + split) of B side by side
  // (logical column 2j + e is physical column j + e * split); kResSkip splits
  // the columns at `split` into a residual and a skip half.
  int split = 0;
  int epilogue = kBias;
  float* out = nullptr;
  int ldo = 0;
  const float* mask = nullptr;  // [batch * t] epilogue row mask
  // kResidMask: residual rows [batch * t, ld_aux]; kGate: per-sample
  // conditioning [batch, ld_aux] (row b at aux + b * ld_aux), or null.
  const float* aux = nullptr;
  int ld_aux = 0;
  float* out2 = nullptr;  // kResSkip skip accumulator [batch * t, ldo2]
  int ldo2 = 0;
  // kResSkip: update the residual half; kCoupling*: sigmoid_scale.
  int flag = 0;
  // kResSkip: multiply the skip sum by the mask after this layer's add
  int skip_mask = 0;
  // further operands of the training epilogues (see block_train.cu)
  const float* aux2 = nullptr;
  const float* aux3 = nullptr;
  float* out3 = nullptr;
  int ldo3 = 0;
  // dropout of kGate / kGateBwd (the site is the WN layer) and of the
  // plain epilogues; keep masks are replayed from the seed
  Dropout drop;
  // Set by a chain to ask for the tensor-core kernel (tc_gemm.cu): scratch
  // of at least 2 * taps * c_in * n floats for the K-major 3xTF32 split of
  // B, written and read in stream order (it may be shared between the
  // products of one chain).  conv_gemm takes the tensor-core kernel when
  // this is set and conv_gemm_tc_fits says yes, else the CUDA-core kernel.
  float* tc_scratch = nullptr;
  long tc_scratch_floats = 0;
  // Set by a chain (the text side's, the serving inverse's) to allow
  // split-K on the tensor cores (conv_gemm_tc_plan): room for the partial
  // sums, kSplitKCols floats a row ([splits, batch * t, n], splits * n <=
  // kSplitKCols).  Null: the whole K walk a block, as the flow training
  // chains run it.
  float* part = nullptr;
  // Set by the serving inverse chain: every product on the tensor cores,
  // in 128- or 64-row tiles, a lone sentence's K walk cut finer
  // (kLoneSplitKCols floats a row of `part`; conv_gemm_tc_plan).
  int small_batch = 0;
  // B's K-major 3xTF32 split made beforehand (presplit_weights, or once at
  // load for serving: big [n, K], small after it), or null: the
  // tensor-core kernel splits B into tc_scratch first.  A chain asks for
  // the tensor cores by giving tc_scratch or w_split.
  const float* w_split = nullptr;
  // kResSkip: the skip sum starts here (written, not added to)
  int skip_init = 0;
  // kGateBwd on the tensor cores: d_xin also written K-major and split, big
  // [2 * split, ldo4] and small after it (ldo4 a multiple of 4 and at least
  // batch * t; rows past batch * t written as zeros): the B operand of the
  // WN reverse walk's dW_in (WGrad::dy_t)
  float* out4 = nullptr;
  long ldo4 = 0;
  // Set by the WN reverse walk for its transposed conv: the tap-staged
  // tensor-core kernel where conv_gemm_tc_plan takes it (K walked channel
  // slice outer, tap inner, a tile's rows and their dilated halo staged
  // once a channel slice for all taps)
  int tap_staged = 0;
};

cudaError_t conv_gemm(const ConvGemm& g, cudaStream_t stream);

// The K-major 3xTF32 split of weight matrices in one launch
// (tc_gemm.cu): big and small [n, kdim] of B [kdim, n], B being w [kdim, n]
// (row stride ldb) or, with w_t, the per-tap transpose of a forward conv's
// w [taps * n, c_in].  A launch takes up to kMaxSplits matrices: every
// product of a flow block's recompute backward at 4 WN layers (21).
constexpr int kMaxSplits = 24;
struct WeightSplit {
  const float* w = nullptr;
  int ldb = 0, kdim = 0, n = 0, c_in = 1, w_t = 0;
  float* big = nullptr;
  float* small = nullptr;
};
struct WeightSplits {
  WeightSplit job[kMaxSplits];
  int count = 0;
};
cudaError_t split_weights(const WeightSplits& s, cudaStream_t stream);

// Split, in one launch into `scratch` (one more for every further
// kMaxSplits), the weights of those of the given products that will take
// the tensor cores (conv_gemm_tc_fits), and point their w_split there, in
// the order given; none fits: no launch.
cudaError_t presplit_weights(ConvGemm* const* gs, int count, float* scratch, long floats,
                             cudaStream_t stream);

// Split-K's partial sums a row, all shares together: their round trip
// through memory is the variant's cost, so a product of n columns takes at
// most kSplitKCols / n shares (2 for the FFN's 768 columns, the most for
// the 192-wide products at base width).
constexpr int kSplitKCols = 1536;
// The serving chain's for a lone sentence (conv_gemm_tc_plan): up to 8
// shares of the in-layer conv's 384 columns.
constexpr int kLoneSplitKCols = 2 * kSplitKCols;

// The tensor-core conv-GEMM (tc_gemm.cu).  `can`: what the kernel needs
// (16-byte copies: c_in, lda and taps * c_in multiples of 4, A 16-byte
// aligned; a_mask only without taps; the scratch holds the split, or B was
// split beforehand).  `plan`: the rows of a block's tile and the K shares a
// product takes (1 share unless the chain gave split-K scratch and the
// product is short and deep); tile_rows 0 where 128-row tiles times K
// shares do not occupy a quarter of the SMs (below that one block's serial
// K walk decides, and the CUDA-core kernel's 32-row tiles win).  The
// serving chain's products always take the tensor cores, in 128- or 64-row
// tiles.  `fits` adds at least 64 columns and 32 deep.
struct TcPlan {
  int tile_rows = 0;
  int splits = 1;
  int tap_staged = 0;  // the tap-staged kernel (ConvGemm::tap_staged)
};
bool conv_gemm_tc_can(const ConvGemm& g);
TcPlan conv_gemm_tc_plan(const ConvGemm& g, int sms);
bool conv_gemm_tc_fits(const ConvGemm& g, int sms);
cudaError_t conv_gemm_tc(const ConvGemm& g, int sms, cudaStream_t stream);

struct WGrad {
  // out[kk, n] = sum over rows m of A_im2col[m, kk] * dY[m, n], A gathered
  // as conv_gemm gathers it (kk = tap * c_in + c), optional row masks.
  const float* a = nullptr;
  int lda = 0;
  int c_in = 0;
  const float* a_mask = nullptr;
  int taps = 1;
  int dilation = 1;
  int batch = 0;
  int t = 0;
  const float* dy = nullptr;
  int ldy = 0;
  int n = 0;
  const float* dy_mask = nullptr;
  float* out = nullptr;      // [taps * c_in, n]
  float* scratch = nullptr;  // partial sums of the row splits
  long scratch_floats = 0;
  // Set by a chain to ask for the tensor-core kernel (tc_gemm.cu); wgrad
  // takes it when wgrad_tc_fits says yes, else the CUDA-core kernel.
  int tc = 0;
  // The bias gradient [n], or null: the column sums of dY (times dy_mask),
  // on the tensor cores the weight gradient of one more im2col column, of
  // ones on the rows (its output row goes through the same split-ordered
  // second pass); on the CUDA cores one column-sum launch.  Not with a_mask.
  float* bias_out = nullptr;
  // dY's K-major 3xTF32 split, big [n, ldt] and small after it (the gate
  // backward's out4), or null: the tensor-core kernel reads B as the
  // conv-GEMM does, without transposing or splitting dY.  dy (row-major) is
  // still given, for the CUDA-core kernel.  Not with either mask.
  const float* dy_t = nullptr;
  long ldt = 0;
};

cudaError_t wgrad(const WGrad& w, cudaStream_t stream);

// The tensor-core weight-gradient GEMM (tc_gemm.cu).  `can`: c_in, lda, n
// and ldy multiples of 4 with 16-byte aligned operands, a_mask only
// without taps; `fits` adds at least 32 x 32 outputs over 256 rows.
bool wgrad_tc_can(const WGrad& w);
bool wgrad_tc_fits(const WGrad& w);
cudaError_t wgrad_tc(const WGrad& w, int sms, cudaStream_t stream);

// Products launched since the last reset, by kernel: tensor-core and
// CUDA-core conv-GEMMs and weight gradients, and of the CUDA-core ones
// those whose caller had asked for the tensor-core kernel; of the
// tensor-core ones, those in the WN reverse walk's modes: tap-staged
// conv-GEMMs, weight gradients with a bias row, weight gradients reading
// dY's K-major split.
struct ProductCounts {
  long long tc_gemm = 0, tc_wgrad = 0, core_gemm = 0, core_wgrad = 0;
  long long declined_gemm = 0, declined_wgrad = 0;
  long long tap_staged_gemm = 0, bias_wgrad = 0, split_dy_wgrad = 0;
};
ProductCounts& product_counts();

// Weight splits a tensor-core conv-GEMM launched for itself (its B not
// split beforehand, by presplit_weights or at load) since the last reset.
long long& product_splits();

// out[s * ldo + j] = sum_{r < T} x[(s * T + r) * ld + j] * mask[s * T + r]
// (mask optional), for segments s < n_seg and columns j < n; fixed order.
cudaError_t col_sum(const float* x, int ld, int n, const float* mask, int n_seg,
                    int T, float* out, int ldo, cudaStream_t stream);

// Column sums over all batch * t rows (a bias gradient), through the
// per-sample partial sums part [batch, n].
cudaError_t bias_grad(const float* x, int ld, int n, const float* mask,
                      int batch, int t, float* part, float* out,
                      cudaStream_t stream);

// Column sums over all `rows` rows in one launch, in a fixed order:
// out[j] = sum_r x[r, j] * mul[r, j] (mul null: x alone) and, when out2 is
// given, out2[j] = sum_r x[r, j].  A bias gradient (mul null) or a norm's
// dgamma and dbeta (mul = xhat) without per-sample partials.
cudaError_t column_sums(const float* x, int ld, int n, const float* mul, int rows, float* out,
                        float* out2, cudaStream_t stream);

// The WN stack's layers: per layer the dilated in-conv with the gate (its
// pre-gate tensor dropped at site l, then + g_all), then the 1x1 res/skip,
// x_next = (x + res) * mask and skip += its skip half.
struct WnLayers {
  // Without saves (th null) x [batch * t, h] holds the input and is
  // overwritten layer by layer.  With saves x is layer-major [L, batch * t,
  // h]: slice 0 holds the input, layer l reads slice l and writes slice
  // l + 1 (the last layer writes none), and th / sg [L, batch * t, h]
  // receive each layer's tanh and sigmoid gates.
  float* x = nullptr;
  float* th = nullptr;
  float* sg = nullptr;
  float* acts = nullptr;  // [batch * t, h] scratch
  float* skip = nullptr;  // [batch * t, h] skip sum, written by layer 0
  int skip_mask = 0;      // multiply the finished skip sum by the mask
  const float* mask = nullptr;
  const float* w_in = nullptr;   // [L, taps * h, 2h]
  const float* b_in = nullptr;   // [L, 2h]
  const float* w_rs = nullptr;   // [L, h, 2h], the last layer's residual half zero
  const float* b_rs = nullptr;   // [L, 2h]
  // conditioning: row b at g_all + b * g_stride, layer l at column l * 2h; or null
  const float* g_all = nullptr;
  int g_stride = 0;
  int batch = 0;
  int t = 0;
  int h = 0;
  int n_layers = 0;
  int taps = 1;
  int dilation_rate = 1;
  Dropout drop;  // n_sites = n_layers; the site is set per layer
  // the tensor-core conv-GEMM's scratch (ConvGemm::tc_scratch), or null
  float* tc_scratch = nullptr;
  long tc_scratch_floats = 0;
  // the serving chain: the weights' K-major splits made at load (layer l
  // at w_in_split + l * 2 * taps * h * 2h, w_rs_split + l * 2 * h * 2h),
  // split-K scratch and ConvGemm::small_batch; or null / 0
  const float* w_in_split = nullptr;
  const float* w_rs_split = nullptr;
  float* part = nullptr;
  int small_batch = 0;
};

cudaError_t wn_layers(const WnLayers& a, cudaStream_t stream);

// The two products of WN layer l at `dilation` as wn_layers runs them (the
// gated in-conv, then the res/skip 1x1), for a chain that splits their
// weights together with its own before running them.
void wn_layer_products(const WnLayers& a, int l, int dilation, ConvGemm* in, ConvGemm* rs);

struct LayerNorm {
  // out = LN(relu_before? (x * x_mask + resid)) [relu_after], per row
  const float* x = nullptr;
  const float* x_mask = nullptr;  // [rows] or null
  const float* resid = nullptr;   // [rows, n] or null
  const float* gamma = nullptr;
  const float* beta = nullptr;
  float* out = nullptr;  // may alias x or resid; null: out_masked only
  int rows = 0;
  int n = 0;
  int relu_before = 0;
  int relu_after = 0;
  // training: drop the result (after the ReLU; site over [t, n], rows of t
  // per sample) and keep the normalised input and the inverse std
  int t = 0;
  Dropout drop;
  float* xhat = nullptr;  // [rows, n] or null
  float* rstd = nullptr;  // [rows] or null
  // a second copy of the result times out_mask [rows], or null
  float* out_masked = nullptr;
  const float* out_mask = nullptr;
};

cudaError_t layer_norm(const LayerNorm& a, cudaStream_t stream);

struct LayerNormBwd {
  // Backward of y = drop(relu_after?(LN(relu_src? relu(pre) : x))): with
  // dyeff = dy * keep * scale * [xhat * gamma + beta > 0 if relu_after],
  //   dx = (g - mean(g) - xhat * mean(g * xhat)) * rstd,  g = dyeff * gamma,
  // times [relu_src > 0] when the forward's ReLU came before the norm
  // (encoder_pallas.py _ln_bwd).  dyeff is written for the norm's
  // parameter gradients (column_sums).
  const float* dy = nullptr;
  const float* xhat = nullptr;
  const float* rstd = nullptr;
  const float* gamma = nullptr;
  const float* beta = nullptr;      // read when relu_after
  const float* relu_src = nullptr;  // [rows, n] or null
  float* dyeff = nullptr;           // [rows, n] or null; may alias dy
  float* dx = nullptr;              // [rows, n]; may alias dy
  // optional second result dx2 = dx * keep2 * scale2 * mask2 (the cotangent
  // of a dropped, masked branch that fed the norm's input)
  float* dx2 = nullptr;
  Dropout drop2;
  const float* mask2 = nullptr;  // [rows] or null
  int rows = 0;
  int n = 0;
  int t = 0;
  int relu_after = 0;
  Dropout drop;
};

cudaError_t layer_norm_bwd(const LayerNormBwd& a, cudaStream_t stream);

}  // namespace gtt
