// One text-encoder layer, the counterpart of
// glow_tts_train_tpu/ops/encoder_pallas.py::_fwd_kernel
// (math: _layer_fwd_math): masked input -> Q/K/V 1x1 -> per head
// softmax(q.k^T/sqrt(d) + banded rel-k, -1e4 fill) . v + banded rel-v ->
// out 1x1 -> residual LayerNorm -> conv FFN (k taps, ReLU) -> residual
// LayerNorm.
//
// The TPU kernel holds one sample's whole layer in VMEM. Here the layer is
// a chain of launches on one stream: one conv_gemm for Q, K and V together
// (the [h, 3h] weight the caller folds), the attention core, conv_gemm for
// the output projection, layer_norm, two conv_gemm for the FFN, layer_norm.
// The products run on the tensor cores where the shape fills the card
// (text_product: 3xTF32, the split-K variant for the short, deep shapes of
// t_x <= 192; a short sentence alone declines them and runs on the CUDA
// cores).
//
// Bound on the card: at training shapes ([16, 192, 192], f = 768) the FFN's
// products hold four fifths of the operations; at serving shapes (t_x of
// tens to hundreds) every piece is small and the chain is latency-bound.
//
// Attention core.  The relative-position terms are the TPU kernel's banded
// form: 2w+1 diagonals of q.rel_k added to the scores, and the band of the
// probabilities times rel_v added to the output; the raw band scores are
// kept per row so the band probabilities come out of the final max and
// sum.  Keys stream through shared memory 32 at a time with an online
// softmax, so any t fits and no [t, t] matrix is written.
// attention_tc_kernel: a block owns 32 query rows of one (sample, head), a
// warp 16 rows and every other key tile (two online-softmax states a row,
// merged at the end); q.k^T and p.v are mma.sync m16n8k8 TF32 products
// with the 3xTF32 split (mma.cuh), 32-deep slices started from zero.  The
// probabilities go from the score fragment to the p.v fragment in
// registers: the p.v product takes key 2q of a k8 step where the
// fragment's column is q and key 2q + 1 where it is q + 4, and reads V's
// rows in the same order, which is where the score fragment holds them.
// The head width is a multiple of 8 (the mma's k) and at most kAttnMaxD.
//
// Training dropout is the TPU kernel's per-site keep mask (sites in
// encoder.cuh).  In the streaming softmax the keep mask scales only the
// numerator (the weighted sum of v and the band term), never the running
// sum: the softmax is of the undropped scores.
//
// The bf16 layer (fp16_run; encoder_pallas with dtype bf16).  Every product
// runs on the TMA-fed wgmma kernel (bf16_gemm.cu, ConvGemm::tma_ring, by
// tma_conv_plan: chunks a tile and split-K shares for the short, deep text
// shapes), each of its operands a bf16 tensor that the kernel producing it
// writes, rounded once where the JAX kernel casts and masked where the
// product reads it masked: xm = x * mask (mask_rows_bf16_kernel), q, k, v
// (the Q/K/V product's epilogue writes them bf16), the heads' outputs
// (the attention core), a_in = x1 * mask (the first norm's masked copy),
// rm (the FFN's first product writes its bf16 copy beside the f32 ReLU
// output that the backward's gates read).  attention_bf16_kernel: the
// tensor-core core's design with q, k, v staged as bf16 (half the bytes:
// four blocks an SM) and q.k^T, p.v on mma.sync m16n8k16 bf16 with f32
// accumulators; the probabilities go from the score fragment to the p.v
// fragment in registers as they are (a k16 step's A is two n-tiles of the
// scores), in a second pass over the keys, once the row's max and sum are
// known, so that they are the final ones, rounded to bf16 as the JAX
// kernel's pd.astype(bf16) rounds them; V's fragments by ldmatrix.trans;
// the band terms f32.
#include <math.h>

#include <algorithm>

#include "attention_tc.cuh"
#include "encoder.cuh"

namespace gtt {
namespace {

constexpr int kMaxD = kAttnMaxD;
constexpr int kMaxBand = kAttnMaxBand;

// ---------------------------------------------------------------------------
// the attention core on the tensor cores
// ---------------------------------------------------------------------------

// two key groups (warp pairs) of kTcKeys-row K and V tiles each
constexpr int kTcSmem = (kTcQ + 4 * kTcKeys) * kTcStride * 4 + 2 * kTcQ * kMaxBand * 4 +
                        2 * kTcKeys * 4 + 4 * kTcQ * 4;

// A block owns 32 query rows of one (sample, head); warp w takes rows 16 (w
// % 2) .. + 15 and every other key tile (key group w / 2), so four warps
// walk the keys in half the steps; the two key groups' online-softmax
// states are merged at the end.
__global__ void __launch_bounds__(128)
    attention_tc_kernel(const float* __restrict__ qkv, const float* __restrict__ mask,
                        const float* __restrict__ rel_k, const float* __restrict__ rel_v,
                        float* __restrict__ out, float* __restrict__ stat_m,
                        float* __restrict__ stat_linv, int t, int n_heads, int d, int window,
                        float scale, const Dropout drop_all) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rg = warp & 1, kg = warp >> 1;  // row group, key group
  float* qt = reinterpret_cast<float*>(smem4);          // [kTcQ][kTcStride]
  float* kt = qt + kTcQ * kTcStride + kg * 2 * kTcKeys * kTcStride;  // this group's K tile
  float* vt = kt + kTcKeys * kTcStride;                               // and V tile
  float* qrel = qt + (kTcQ + 4 * kTcKeys) * kTcStride;  // [kTcQ][kMaxBand]
  float* band = qrel + kTcQ * kMaxBand;  // raw band scores, then dropped band probabilities
  float* kmask = band + kTcQ * kMaxBand + kg * kTcKeys;
  float* row_m = band + kTcQ * kMaxBand + 2 * kTcKeys;  // [kTcQ] each
  float* row_inv = row_m + kTcQ;
  float* part_m = row_inv + kTcQ;  // key group 1's state, for the merge
  float* part_l = part_m + kTcQ;

  const int b = blockIdx.z;
  const int hd = blockIdx.y;
  const int q0 = blockIdx.x * kTcQ;
  const int h = n_heads * d;
  const int ld = 3 * h;
  const int nb = 2 * window + 1;
  const int nd = d / 8;  // k-steps of q.k^T, n-tiles of p.v
  const float* base = qkv + (long)b * t * ld;
  const float* mrow = mask + (long)b * t;
  const int g = lane >> 2, qd = lane & 3;
  const int gtid = tid & 63;  // thread in the key group
  const Dropout drop = drop_all.at(hd);  // over this head's [t, t] probabilities

  stage_rows(base + hd * d, ld, q0, kTcQ, t, d, qt, tid, 128);
  // q . rel_k for the 2w+1 band offsets (CUDA cores, a thread a (row, offset))
  for (int i = tid; i < kTcQ * nb; i += 128) {
    const int r = i / nb, o = i - (i / nb) * nb;
    const int qi = q0 + r;
    qrel[r * kMaxBand + o] =
        qi < t ? rel_dot<false>(base + (long)qi * ld + hd * d, rel_k, o, d) : 0.f;
  }

  // this thread's fragment rows: r_lo = 16 rg + g and r_lo + 8
  int rloc[2], qi[2];
  float qm[2], m_run[2], l_run[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rloc[e] = rg * 16 + g + 8 * e;
    qi[e] = q0 + rloc[e];
    // rows past t are computed as fully masked rows and never written
    qm[e] = qi[e] < t ? mrow[qi[e]] : 0.f;
    m_run[e] = -INFINITY;
    l_run[e] = 0.f;
  }
  float acc[kTcND][4];
#pragma unroll
  for (int n = 0; n < kTcND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_steps = (t + 2 * kTcKeys - 1) / (2 * kTcKeys);
  for (int step = 0; step < n_steps; ++step) {
    const int k0 = (2 * step + kg) * kTcKeys;
    __syncthreads();  // previous tiles consumed (and qrel, the Q tile written)
    if (k0 < t) {
      stage_rows(base + h + hd * d, ld, k0, kTcKeys, t, d, kt, gtid, 64);
      stage_rows(base + 2 * h + hd * d, ld, k0, kTcKeys, t, d, vt, gtid, 64);
      if (gtid < kTcKeys) kmask[gtid] = k0 + gtid < t ? mrow[k0 + gtid] : 0.f;
    }
    __syncthreads();
    if (k0 >= t) continue;

    // scores of 16 rows x 32 keys: four n-tiles of 8 keys
    float sc[4][4];
    tile_scores(sc, qt, kt, rloc[0], g, qd, nd);

    // band terms, masks, the online softmax (element e of n-tile n: row
    // e / 2, key k0 + 8 n + 2 qd + e % 2)
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int key = k0 + n * 8 + 2 * qd + (e & 1);
        float sv = -INFINITY;  // keys past t do not exist
        if (key < t) {
          sv = sc[n][e] * scale;
          const int o = key - qi[row] + window;
          const bool in_band = o >= 0 && o < nb;
          if (in_band) sv += qrel[rloc[row] * kMaxBand + o] * scale;
          if (qm[row] == 0.f || kmask[key - k0] == 0.f) sv = -1e4f;
          if (in_band) band[rloc[row] * kMaxBand + o] = sv;
        }
        sc[n][e] = sv;
        mt[row] = fmaxf(mt[row], sv);
      }
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mt[row] = quad_max(mt[row]);
      const float m_new = fmaxf(m_run[row], mt[row]);
      alpha[row] = expf(m_run[row] - m_new);
      m_run[row] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int key = k0 + n * 8 + 2 * qd + (e & 1);
        float p = expf(sc[n][e] - m_run[row]);
        ps[row] += p;
        if (drop.on && key < t) p = site_drop(drop, b, qi[row], t, key, p);
        sc[n][e] = p;
      }
#pragma unroll
    for (int row = 0; row < 2; ++row) l_run[row] = l_run[row] * alpha[row] + quad_sum(ps[row]);

    // p . v over the tile's 32 keys (one slice): the k8 step of n-tile n
    // takes the fragment's keys 2 qd and 2 qd + 1 as its columns qd, qd + 4
    uint32_t pbig[4][4], psmall[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      split_tf32(sc[n][0], pbig[n][0], psmall[n][0]);
      split_tf32(sc[n][2], pbig[n][1], psmall[n][1]);
      split_tf32(sc[n][1], pbig[n][2], psmall[n][2]);
      split_tf32(sc[n][3], pbig[n][3], psmall[n][3]);
    }
    float po[kTcND][4];
#pragma unroll
    for (int j = 0; j < kTcND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) po[j][e] = 0.f;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int vr = (n * 8 + 2 * qd) * kTcStride + g;
#pragma unroll
        for (int j = 0; j < kTcND; ++j) {
          if (j >= nd) break;
          const float v0 = vt[vr + j * 8], v1 = vt[vr + kTcStride + j * 8];
          if (pass == 0) {
            uint32_t bb[2], bs[2];
            split_tf32(v0, bb[0], bs[0]);
            split_tf32(v1, bb[1], bs[1]);
            mma_small_terms(po[j], pbig[n], psmall[n], bb, bs);
          } else {
            const uint32_t bb[2] = {tf32_big(v0), tf32_big(v1)};
            mma_tf32(po[j], pbig[n], bb);
          }
        }
      }
#pragma unroll
    for (int j = 0; j < kTcND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * alpha[e >> 1] + po[j][e];
  }

  // key group 1 hands its state to group 0 through the K/V tiles' memory
  __syncthreads();
  float* part_acc = qt + kTcQ * kTcStride;  // [kTcQ][kTcStride]
  if (kg == 1) {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      if (qd == 0) {
        part_m[rloc[row]] = m_run[row];
        part_l[rloc[row]] = l_run[row];
      }
#pragma unroll
      for (int j = 0; j < kTcND; ++j) {
        if (j >= nd) break;
        float* at = part_acc + rloc[row] * kTcStride + j * 8 + 2 * qd;
        at[0] = acc[j][2 * row];
        at[1] = acc[j][2 * row + 1];
      }
    }
  }
  __syncthreads();
  if (kg == 1) return;
  float inv[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    // merge: (m, l, acc) of both groups rescaled to the larger max
    const float m1 = part_m[rloc[row]], l1 = part_l[rloc[row]];
    const float m = fmaxf(m_run[row], m1);
    const float a0 = expf(m_run[row] - m), a1 = expf(m1 - m);
    l_run[row] = l_run[row] * a0 + l1 * a1;
    m_run[row] = m;
#pragma unroll
    for (int j = 0; j < kTcND; ++j) {
      if (j >= nd) break;
      const float* at = part_acc + rloc[row] * kTcStride + j * 8 + 2 * qd;
      acc[j][2 * row] = acc[j][2 * row] * a0 + at[0] * a1;
      acc[j][2 * row + 1] = acc[j][2 * row + 1] * a0 + at[1] * a1;
    }
    inv[row] = 1.f / l_run[row];
    if (qd == 0) {
      row_m[rloc[row]] = m_run[row];
      row_inv[rloc[row]] = inv[row];
      if (stat_m && qi[row] < t) {
        const long at = ((long)b * n_heads + hd) * t + qi[row];
        stat_m[at] = m_run[row];
        stat_linv[at] = inv[row];
      }
    }
  }
  __syncwarp();
  // the dropped band probabilities of this warp's rows, in place of the scores
  for (int i = lane; i < 16 * nb; i += 32) {
    const int r = rg * 16 + i / nb, o = i - (i / nb) * nb;
    const int q = q0 + r, key = q + o - window;
    float pb = 0.f;
    if (q < t && key >= 0 && key < t)
      pb = site_drop(drop, b, q, t, key, expf(band[r * kMaxBand + o] - row_m[r]) * row_inv[r]);
    band[r * kMaxBand + o] = pb;
  }
  __syncwarp();
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qi[row] >= t) continue;
    const float* pbr = band + rloc[row] * kMaxBand;
    float* orow = out + ((long)b * t + qi[row]) * h + hd * d;
#pragma unroll
    for (int j = 0; j < kTcND; ++j) {
      if (j >= nd) break;
      const int c = j * 8 + 2 * qd;
      float v0 = acc[j][2 * row] * inv[row], v1 = acc[j][2 * row + 1] * inv[row];
      for (int o = 0; o < nb; ++o) {
        v0 = fmaf(pbr[o], rel_at<false>(rel_v, o, d, c), v0);
        v1 = fmaf(pbr[o], rel_at<false>(rel_v, o, d, c + 1), v1);
      }
      orow[c] = v0;
      orow[c + 1] = v1;
    }
  }
}

// ---------------------------------------------------------------------------
// the bf16 layer's attention core (mma.sync m16n8k16 bf16)
// ---------------------------------------------------------------------------

// the Q tile, two key groups' K and V tiles (bf16), the band scratch, the
// key masks and the rows' statistics
constexpr int kBf16Smem = (kTcQ + 4 * kTcKeys) * kS16 * 2 + 2 * kTcQ * kMaxBand * 4 +
                          2 * kTcKeys * 4 + 4 * kTcQ * 4;
static_assert(kTcQ * kTcStride * 4 <= 4 * kTcKeys * kS16 * 2,
              "key group 1's sums fit the K/V tiles' memory");

// attention_tc_kernel's blocks and warps with bf16 operands, in two passes
// over the keys so that the probabilities p.v reads are the final ones,
// rounded where the JAX kernel rounds them (pdt = pd.astype(bf16), pd the
// dropped p = e / sum e): pass 1 the scores' row max and sum (an online
// softmax per key group, the groups' states merged), pass 2 the scores again,
// p = exp(s - m) / l dropped and rounded, p . v; the key groups' sums added.
// qkv [rows, 3h] bf16; out (f32, where given) and out16 (bf16) the heads'
// outputs.
__global__ void __launch_bounds__(128, 4)
    attention_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ mask,
                          const float* __restrict__ rel_k, const float* __restrict__ rel_v,
                          float* __restrict__ out, __nv_bfloat16* __restrict__ out16,
                          float* __restrict__ stat_m, float* __restrict__ stat_linv, int t,
                          int n_heads, int d, int window, float scale, const Dropout drop_all) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int rg = warp & 1, kg = warp >> 1;  // row group, key group
  __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kTcQ][kS16]
  __nv_bfloat16* kt = qt + kTcQ * kS16 + kg * 2 * kTcKeys * kS16;  // this group's K tile
  __nv_bfloat16* vt = kt + kTcKeys * kS16;                         // and V tile
  float* qrel = reinterpret_cast<float*>(qt + (kTcQ + 4 * kTcKeys) * kS16);  // [kTcQ][kMaxBand]
  float* band = qrel + kTcQ * kMaxBand;  // raw band scores, then dropped band probabilities
  float* kmask = band + kTcQ * kMaxBand + kg * kTcKeys;
  float* row_m = band + kTcQ * kMaxBand + 2 * kTcKeys;  // [kTcQ] each
  float* row_l = row_m + kTcQ;
  float* part_m = row_l + kTcQ;  // key group 1's pass-1 state, for the merge
  float* part_l = part_m + kTcQ;

  const int b = blockIdx.z;
  const int hd = blockIdx.y;
  const int q0 = blockIdx.x * kTcQ;
  const int h = n_heads * d;
  const int ld = 3 * h;
  const int nb = 2 * window + 1;
  const int nd = d / 8;  // n-tiles of p.v
  const __nv_bfloat16* base = qkv + (long)b * t * ld;
  const float* mrow = mask + (long)b * t;
  const int g = lane >> 2, qd = lane & 3;
  const int gtid = tid & 63;  // thread in the key group
  const Dropout drop = drop_all.at(hd);  // over this head's [t, t] probabilities

  stage_rows_bf16(base + hd * d, ld, q0, kTcQ, t, d, qt, tid, 128);
  __syncthreads();
  // q . rel_k for the 2w+1 band offsets (CUDA cores, a thread a (row, offset))
  for (int i = tid; i < kTcQ * nb; i += 128) {
    const int r = i / nb, o = i - (i / nb) * nb;
    qrel[r * kMaxBand + o] = q0 + r < t ? rel_dot_bf16(qt + r * kS16, rel_k, o, d) : 0.f;
  }

  int rloc[2], qi[2];
  float qm[2], m_run[2], l_run[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    rloc[e] = rg * 16 + g + 8 * e;
    qi[e] = q0 + rloc[e];
    // rows past t are computed as fully masked rows and never written
    qm[e] = qi[e] < t ? mrow[qi[e]] : 0.f;
    m_run[e] = -INFINITY;
    l_run[e] = 0.f;
  }
  // the scores of this warp's 16 rows against the staged key tile at k0:
  // scaled, the band terms added (the band's raw scores kept), masked
  // (element e of n-tile n: row e / 2, key k0 + 8 n + 2 qd + e % 2; keys past
  // t -inf)
  auto tile = [&](float (&sc)[4][4], int k0) {
    tile_scores_bf16(sc, qt, kt, rloc[0], g, qd, d);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int key = k0 + n * 8 + 2 * qd + (e & 1);
        float sv = -INFINITY;
        if (key < t) {
          sv = sc[n][e] * scale;
          const int o = key - qi[row] + window;
          const bool in_band = o >= 0 && o < nb;
          if (in_band) sv += qrel[rloc[row] * kMaxBand + o] * scale;
          if (qm[row] == 0.f || kmask[key - k0] == 0.f) sv = -1e4f;
          if (in_band) band[rloc[row] * kMaxBand + o] = sv;
        }
        sc[n][e] = sv;
      }
  };

  const int n_steps = (t + 2 * kTcKeys - 1) / (2 * kTcKeys);
  // pass 1: each row's max and sum over this key group's tiles
  for (int step = 0; step < n_steps; ++step) {
    const int k0 = (2 * step + kg) * kTcKeys;
    __syncthreads();  // previous tile consumed (and qrel written)
    if (k0 < t) {
      stage_rows_bf16(base + h + hd * d, ld, k0, kTcKeys, t, d, kt, gtid, 64);
      if (gtid < kTcKeys) kmask[gtid] = k0 + gtid < t ? mrow[k0 + gtid] : 0.f;
    }
    __syncthreads();
    if (k0 >= t) continue;
    float sc[4][4];
    tile(sc, k0);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mt[e >> 1] = fmaxf(mt[e >> 1], sc[n][e]);
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      mt[row] = quad_max(mt[row]);
      const float m_new = fmaxf(m_run[row], mt[row]);
      l_run[row] *= expf(m_run[row] - m_new);
      m_run[row] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ps[e >> 1] += expf(sc[n][e] - m_run[e >> 1]);
#pragma unroll
    for (int row = 0; row < 2; ++row) l_run[row] += quad_sum(ps[row]);
  }
  // the key groups' states merged: every warp takes its rows' final m, l
  __syncthreads();
  if (kg == 1 && qd == 0) {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      part_m[rloc[row]] = m_run[row];
      part_l[rloc[row]] = l_run[row];
    }
  }
  __syncthreads();
  if (kg == 0) {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      const float m1 = part_m[rloc[row]], l1 = part_l[rloc[row]];
      const float m = fmaxf(m_run[row], m1);
      l_run[row] = l_run[row] * expf(m_run[row] - m) + l1 * expf(m1 - m);
      m_run[row] = m;
      if (qd == 0) {
        row_m[rloc[row]] = m;
        row_l[rloc[row]] = l_run[row];
        if (stat_m && qi[row] < t) {
          const long at = ((long)b * n_heads + hd) * t + qi[row];
          stat_m[at] = m;
          stat_linv[at] = 1.f / l_run[row];
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    m_run[row] = row_m[rloc[row]];
    l_run[row] = row_l[rloc[row]];
  }

  // pass 2: the final probabilities, dropped and rounded, times v
  float acc[kTcND][4];
#pragma unroll
  for (int n = 0; n < kTcND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    const int k0 = (2 * step + kg) * kTcKeys;
    __syncthreads();  // previous tiles consumed
    if (k0 < t) {
      stage_rows_bf16(base + h + hd * d, ld, k0, kTcKeys, t, d, kt, gtid, 64);
      stage_rows_bf16(base + 2 * h + hd * d, ld, k0, kTcKeys, t, d, vt, gtid, 64);
      if (gtid < kTcKeys) kmask[gtid] = k0 + gtid < t ? mrow[k0 + gtid] : 0.f;
    }
    __syncthreads();
    if (k0 >= t) continue;
    float sc[4][4];
    tile(sc, k0);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e >> 1;
        const int key = k0 + n * 8 + 2 * qd + (e & 1);
        float p = expf(sc[n][e] - m_run[row]) / l_run[row];
        if (drop.on && key < t) p = site_drop(drop, b, qi[row], t, key, p);
        sc[n][e] = p;
      }
    // the k16 step j's A is n-tiles 2j and 2j + 1 of the probabilities
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t af[4] = {pack2(sc[2 * j][0], sc[2 * j][1]), pack2(sc[2 * j][2], sc[2 * j][3]),
                              pack2(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                              pack2(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int jn = 0; jn < kTcND; ++jn) {
        if (jn >= nd) break;
        uint32_t bf[2];
        ldmatrix_x2_trans(bf, vt + (16 * j + (lane & 15)) * kS16 + 8 * jn);
        mma_bf16(acc[jn], af, bf);
      }
    }
  }

  // key group 1 hands its sums to group 0 through the K/V tiles' memory
  __syncthreads();
  float* part_acc = reinterpret_cast<float*>(qt + kTcQ * kS16);  // [kTcQ][kTcStride]
  if (kg == 1) {
#pragma unroll
    for (int row = 0; row < 2; ++row)
#pragma unroll
      for (int j = 0; j < kTcND; ++j) {
        if (j >= nd) break;
        float* at = part_acc + rloc[row] * kTcStride + j * 8 + 2 * qd;
        at[0] = acc[j][2 * row];
        at[1] = acc[j][2 * row + 1];
      }
  }
  __syncthreads();
  if (kg == 1) return;
  // the dropped band probabilities of this warp's rows, in place of the scores
  for (int i = lane; i < 16 * nb; i += 32) {
    const int r = rg * 16 + i / nb, o = i - (i / nb) * nb;
    const int q = q0 + r, key = q + o - window;
    float pb = 0.f;
    if (q < t && key >= 0 && key < t)
      pb = site_drop(drop, b, q, t, key, expf(band[r * kMaxBand + o] - row_m[r]) / row_l[r]);
    band[r * kMaxBand + o] = pb;
  }
  __syncwarp();
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    if (qi[row] >= t) continue;
    const float* pbr = band + rloc[row] * kMaxBand;
    const long at = ((long)b * t + qi[row]) * h + hd * d;
#pragma unroll
    for (int j = 0; j < kTcND; ++j) {
      if (j >= nd) break;
      const int c = j * 8 + 2 * qd;
      const float* pa = part_acc + rloc[row] * kTcStride + c;
      float v0 = acc[j][2 * row] + pa[0], v1 = acc[j][2 * row + 1] + pa[1];
      for (int o = 0; o < nb; ++o) {
        v0 = fmaf(pbr[o], rel_at<true>(rel_v, o, d, c), v0);
        v1 = fmaf(pbr[o], rel_at<true>(rel_v, o, d, c + 1), v1);
      }
      if (out) {
        out[at + c] = v0;
        out[at + c + 1] = v1;
      }
      *reinterpret_cast<__nv_bfloat162*>(out16 + at + c) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

// xm = x * mask, bf16 [rows, n] (n a multiple of 8): the Q/K/V product's
// masked operand, 8 elements a thread.
__global__ void mask_rows_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                      const float* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                                      long rows, int n) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) * 8;
  if (i >= rows * n) return;
  const float m = mask[i / n];
  uint4 v = *reinterpret_cast<const uint4*>(x + i);
  uint32_t* w = &v.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[e]));
    w[e] = pack2(f.x * m, f.y * m);
  }
  *reinterpret_cast<uint4*>(out + i) = v;
}

}  // namespace

cudaError_t attention_bf16(const float* qkv16, const float* mask, const float* rel_k,
                           const float* rel_v, float* out, float* out16, float* stat_m,
                           float* stat_linv, int batch, int t, int n_heads, int d, int window,
                           const Dropout& drop, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kBf16Smem);
  if (err != cudaSuccess) return err;
  attention_bf16_kernel<<<dim3((t + kTcQ - 1) / kTcQ, n_heads, batch), 128, kBf16Smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(qkv16), mask, rel_k, rel_v, out,
      reinterpret_cast<__nv_bfloat16*>(out16), stat_m, stat_linv, t, n_heads, d, window,
      1.f / sqrtf((float)d), drop);
  return cudaGetLastError();
}

bool attention_fits(int d, int window, const float* rel_k, const float* rel_v) {
  auto aligned = [](const float* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; };
  return d % 8 == 0 && d <= kMaxD && 2 * window + 1 <= kMaxBand && aligned(rel_k) &&
         aligned(rel_v);
}

namespace {
// 16-byte multiples, so every carved buffer stays aligned for the tensor cores
long round4(long floats) { return (floats + 3) / 4 * 4; }
}  // namespace

long encoder_scratch(float* base, const EncoderDims& d, bool backward, float* ffn,
                     EncoderScratch* s, bool bf16) {
  long used = 0;
  auto take = [&](float*& p, long floats) {
    p = base ? base + used : nullptr;
    used += round4(floats);
  };
  // a bf16 buffer of `elems` elements
  auto take16 = [&](float*& p, long elems) { take(p, (elems + 1) / 2); };
  const long rows = d.rows(), h = d.h, f = d.f;
  const long bands = rows * d.n_heads * d.band();
  if (bf16) take16(s->qkv, rows * 3 * h);
  else take(s->qkv, rows * 3 * h);
  if (!bf16 || backward) take(s->att, rows * h);  // bf16: f32 for the score pass's row terms
  take(s->x1, rows * h);
  if (bf16) take16(s->x1m, rows * h);
  else take(s->x1m, rows * h);
  if (ffn) {
    s->ffn = ffn;
  } else {
    take(s->ffn, rows * f);
  }
  // the K-major splits of the layer's four weights, for the forward's
  // products and the backward's transposed ones (presplit_weights; 16 floats
  // of alignment each; a bf16 chain's products read them as they lie), and
  // the split-K partial sums
  s->tc_floats = bf16 ? 0 : 2 * (2 * (4 * h * h + 2L * d.taps * h * f) + 4 * 16);
  take(s->tc, s->tc_floats);
  take(s->part, kSplitKCols * rows);
  if (bf16) {
    take(s->y, rows * h);
    take16(s->xm16, rows * h);
    take16(s->att16, rows * h);
    take16(s->rm16, rows * f);
  }
  if (backward) {
    const long stats = (long)d.batch * d.n_heads * d.t;
    take(s->xhat1, rows * h);
    take(s->rstd1, rows);
    take(s->xhat2, rows * h);
    take(s->rstd2, rows);
    take(s->stat_m, stats);
    take(s->stat_linv, stats);
    take(s->da, rows * h);
    take(s->db, rows * h);
    take(s->dc, rows * h);
    take(s->datt, rows * h);
    take(s->dffn, rows * f);
    take(s->dqkv, rows * 3 * h);
    take(s->dqrel, bands);
    take(s->pb, bands);
    if (bf16) {
      take16(s->ds, stats * d.t);
      take16(s->pd, stats * d.t);
    } else {
      take(s->ds, stats * d.t);
      take(s->pd, stats * d.t);
    }
    s->wg_floats = std::max(1L << 22, (long)d.taps * h * f);
    take(s->wg, s->wg_floats);
    if (bf16) {
      take16(s->db16, rows * h);
      take16(s->dc16, rows * h);
      take16(s->datt16, rows * h);
      take16(s->dffn16, rows * f);
      take16(s->dqkv16, rows * 3 * h);
    }
  }
  return used;
}

ConvGemm text_product(const EncoderScratch& s, bool bf16) {
  ConvGemm g;
  g.tc_scratch = s.tc;
  g.tc_scratch_floats = s.tc_floats;
  g.part = s.part;
  g.tma_ring = bf16 ? 1 : 0;
  return g;
}

cudaError_t encoder_forward(const EncoderArgs& a, cudaStream_t stream) {
  const EncoderDims& dm = a.dims;
  const int h = dm.h, batch = dm.batch, t = dm.t;
  const int H = dm.n_heads;
  const int d = h / H;
  if (!attention_fits(d, dm.window, a.rel_k, a.rel_v)) return cudaErrorInvalidValue;
  const int rows = batch * t;
  const EncoderScratch& s = a.s;
  const bool b16 = a.bf16;
  cudaError_t err;
  // a bf16 call's products: bf16 operands and weights
  const unsigned bf = b16 ? kBf16 | kA16 | kW16 : 0u;
  // the branches' f32 outputs: staged in `out` (f32), in s.y (bf16)
  float* y = b16 ? s.y : a.out;

  // the four products, their weights split for the tensor cores in one
  // launch (those that take them)
  ConvGemm qkv = text_product(s, b16);  // qkv = (x * mask) @ wqkv + bqkv
  qkv.lda = h; qkv.c_in = h; qkv.batch = batch; qkv.t = t;
  qkv.w = a.wqkv; qkv.bias = a.bqkv; qkv.n = 3 * h;
  qkv.epilogue = kBias; qkv.out = s.qkv; qkv.ldo = 3 * h;
  if (b16) {  // xm's bf16 copy; q, k, v bf16 (JAX qh = q.astype(bf16))
    qkv.a = s.xm16;
    qkv.bf16 = bf | kOut16;
  } else {
    qkv.a = a.x;
    qkv.a_mask = a.mask;
  }
  ConvGemm proj = text_product(s, b16);  // y = drop(att @ wo + bo)
  proj.a = b16 ? s.att16 : s.att; proj.lda = h; proj.c_in = h; proj.batch = batch; proj.t = t;
  proj.w = a.wo; proj.bias = a.bo; proj.n = h; proj.epilogue = kBias; proj.out = y;
  proj.ldo = h; proj.drop = a.drop.at(H);
  proj.bf16 = bf;
  ConvGemm ffn1 = text_product(s, b16);  // ffn = drop(relu(conv(x1 * mask) + c1)) * mask
  ffn1.a = s.x1m; ffn1.lda = h; ffn1.c_in = h; ffn1.taps = dm.taps;
  ffn1.batch = batch; ffn1.t = t; ffn1.w = a.w1; ffn1.bias = a.c1; ffn1.n = dm.f;
  ffn1.epilogue = kBiasReluMask; ffn1.out = s.ffn; ffn1.ldo = dm.f; ffn1.mask = a.mask;
  ffn1.drop = a.drop.at(H + 1);
  ffn1.bf16 = bf;
  ffn1.out_c = s.rm16;  // rm = ffn.astype(bf16), for the second conv
  ConvGemm ffn2 = text_product(s, b16);  // y2 = drop((conv(ffn) + c2) * mask)
  ffn2.a = b16 ? s.rm16 : s.ffn; ffn2.lda = dm.f; ffn2.c_in = dm.f; ffn2.taps = dm.taps;
  ffn2.batch = batch; ffn2.t = t; ffn2.w = a.w2; ffn2.bias = a.c2; ffn2.n = h;
  ffn2.epilogue = kBiasMask; ffn2.out = y; ffn2.ldo = h; ffn2.mask = a.mask;
  ffn2.drop = a.drop.at(H + 2);
  ffn2.bf16 = bf;
  ConvGemm* const products[4] = {&qkv, &proj, &ffn1, &ffn2};
  if (!b16 && (err = presplit_weights(products, 4, s.tc, s.tc_floats / 2, stream)) != cudaSuccess)
    return err;

  if (b16) {
    const long elems = (long)rows * h;
    mask_rows_bf16_kernel<<<(unsigned)((elems / 8 + 255) / 256), 256, 0, stream>>>(
        reinterpret_cast<const __nv_bfloat16*>(a.x), a.mask,
        reinterpret_cast<__nv_bfloat16*>(s.xm16), rows, h);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if ((err = conv_gemm(qkv, stream)) != cudaSuccess) return err;
  float* stat_m = a.save ? s.stat_m : nullptr;
  float* stat_linv = a.save ? s.stat_linv : nullptr;
  if (b16) {  // the heads' outputs bf16, and f32 for the backward's row terms
    if ((err = attention_bf16(s.qkv, a.mask, a.rel_k, a.rel_v, a.save ? s.att : nullptr, s.att16,
                              stat_m, stat_linv, batch, t, H, d, dm.window, a.drop, stream)) !=
        cudaSuccess)
      return err;
  } else {
    auto kernel = attention_tc_kernel;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kTcSmem)) != cudaSuccess)
      return err;
    kernel<<<dim3((t + kTcQ - 1) / kTcQ, H, batch), 128, kTcSmem, stream>>>(
        s.qkv, a.mask, a.rel_k, a.rel_v, s.att, stat_m, stat_linv, t, H, d, dm.window,
        1.f / sqrtf((float)d), a.drop);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }

  if ((err = conv_gemm(proj, stream)) != cudaSuccess) return err;
  {  // x1 = LN(x * mask + y), and x1 * mask for the FFN (bf16: a_in)
    LayerNorm ln;
    ln.x = a.x; ln.x_mask = a.mask; ln.resid = y; ln.gamma = a.gamma1;
    ln.beta = a.beta1; ln.out = s.x1; ln.rows = rows; ln.n = h;
    ln.out_masked = s.x1m; ln.out_mask = a.mask;
    ln.bf16 = b16 ? kA16 | kOutM16 : 0u;
    if (a.save) { ln.xhat = s.xhat1; ln.rstd = s.rstd1; }
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
  }
  if ((err = conv_gemm(ffn1, stream)) != cudaSuccess) return err;
  if ((err = conv_gemm(ffn2, stream)) != cudaSuccess) return err;
  {  // out = LN(x1 + y2)
    LayerNorm ln;
    ln.x = s.x1; ln.resid = y; ln.gamma = a.gamma2; ln.beta = a.beta2;
    ln.out = a.out; ln.rows = rows; ln.n = h;
    ln.bf16 = a.bf16 ? kOut16 : 0u;
    if (a.save) { ln.xhat = s.xhat2; ln.rstd = s.rstd2; }
    if ((err = layer_norm(ln, stream)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace gtt

namespace {

gtt::EncoderDims encoder_dims(int batch, int t, int h, int n_heads, int window, int f, int taps) {
  gtt::EncoderDims d;
  d.batch = batch; d.t = t; d.h = h; d.n_heads = n_heads; d.window = window; d.f = f;
  d.taps = taps;
  return d;
}

}  // namespace

// Floats of one call's scratch block (backward 0: gtt_encoder_layer, 1:
// gtt_encoder_layer_bwd; bf16 1: their bf16 versions).
extern "C" long long gtt_encoder_scratch_floats(int batch, int t, int h, int n_heads, int window,
                                                int f, int taps, int backward, int bf16) {
  gtt::EncoderScratch s;
  float ffn_given = 0.f;
  return gtt::encoder_scratch(nullptr, encoder_dims(batch, t, h, n_heads, window, f, taps),
                              backward != 0, backward ? &ffn_given : nullptr, &s, bf16 != 0);
}

namespace {

int encoder_entry(
    const float* x, const float* mask, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* rel_k, const float* rel_v, const float* gamma1,
    const float* beta1, const float* gamma2, const float* beta2, const float* w1,
    const float* c1, const float* w2, const float* c2, float* out, float* scratch,
    long long scratch_floats, int batch, int t, int h, int n_heads, int window, int f,
    int taps, int drop, int seed, unsigned threshold, float scale, bool bf16,
    cudaStream_t stream) {
  gtt::EncoderArgs a;
  a.bf16 = bf16;
  a.x = x; a.mask = mask; a.wqkv = wqkv; a.bqkv = bqkv; a.wo = wo; a.bo = bo;
  a.rel_k = rel_k; a.rel_v = rel_v;
  a.gamma1 = gamma1; a.beta1 = beta1; a.gamma2 = gamma2; a.beta2 = beta2;
  a.w1 = w1; a.c1 = c1; a.w2 = w2; a.c2 = c2; a.out = out;
  a.dims = encoder_dims(batch, t, h, n_heads, window, f, taps);
  if (gtt::encoder_scratch(scratch, a.dims, false, nullptr, &a.s, bf16) > scratch_floats)
    return (int)cudaErrorInvalidValue;
  a.drop = gtt::make_dropout(drop, seed, n_heads + 3, threshold, scale);
  const cudaError_t err = gtt::encoder_forward(a, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

extern "C" int gtt_encoder_layer(
    const float* x, const float* mask, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* rel_k, const float* rel_v, const float* gamma1,
    const float* beta1, const float* gamma2, const float* beta2, const float* w1,
    const float* c1, const float* w2, const float* c2, float* out, float* scratch,
    long long scratch_floats, int batch, int t, int h, int n_heads, int window, int f,
    int taps, int drop, int seed, unsigned threshold, float scale, cudaStream_t stream) {
  return encoder_entry(x, mask, wqkv, bqkv, wo, bo, rel_k, rel_v, gamma1, beta1, gamma2, beta2,
                       w1, c1, w2, c2, out, scratch, scratch_floats, batch, t, h, n_heads,
                       window, f, taps, drop, seed, threshold, scale, false, stream);
}

// The bf16 attention core alone (attention_bf16_kernel), for tests: qkv16
// [batch * t, 3h] bf16 -> the heads' outputs att [batch * t, h] f32 and
// att16 bf16, the softmax's row max and inverse row sum [batch, heads, t];
// dropout at the layer's site numbering.
extern "C" int gtt_bf16_attention(const float* qkv16, const float* mask, const float* rel_k,
                                  const float* rel_v, float* att, float* att16, float* stat_m,
                                  float* stat_linv, int batch, int t, int n_heads, int d,
                                  int window, int drop, int seed, unsigned threshold, float scale,
                                  cudaStream_t stream) {
  if (!gtt::attention_fits(d, window, rel_k, rel_v)) return (int)cudaErrorInvalidValue;
  const gtt::Dropout dr = gtt::make_dropout(drop, seed, n_heads + 3, threshold, scale);
  return (int)gtt::attention_bf16(qkv16, mask, rel_k, rel_v, att, att16, stat_m, stat_linv, batch,
                                  t, n_heads, d, window, dr, stream);
}

// The same in bf16 (EncoderArgs::bf16).
extern "C" int gtt_encoder_layer_bf16(
    const float* x, const float* mask, const float* wqkv, const float* bqkv, const float* wo,
    const float* bo, const float* rel_k, const float* rel_v, const float* gamma1,
    const float* beta1, const float* gamma2, const float* beta2, const float* w1,
    const float* c1, const float* w2, const float* c2, float* out, float* scratch,
    long long scratch_floats, int batch, int t, int h, int n_heads, int window, int f,
    int taps, int drop, int seed, unsigned threshold, float scale, cudaStream_t stream) {
  return encoder_entry(x, mask, wqkv, bqkv, wo, bo, rel_k, rel_v, gamma1, beta1, gamma2, beta2,
                       w1, c1, w2, c2, out, scratch, scratch_floats, batch, t, h, n_heads,
                       window, f, taps, drop, seed, threshold, scale, true, stream);
}
