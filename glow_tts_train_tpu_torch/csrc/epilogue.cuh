// The conv-GEMM's epilogues (see common.cuh, enum Epilogue), shared by the
// CUDA-core kernel (common.cu) and the tensor-core kernel (tc_gemm.cu).
#pragma once

#include <math.h>

#include "common.cuh"

namespace gtt {

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ __forceinline__ bool paired(int epilogue) {
  return epilogue == kGate || epilogue == kCouplingInv ||
         epilogue == kCouplingFwd;
}

// Logical output column -> column of B / bias.
__device__ __forceinline__ int physical_col(const ConvGemm& g, int n) {
  return paired(g.epilogue) ? (n >> 1) + (n & 1) * g.split : n;
}

__device__ __forceinline__ float bias_at(const ConvGemm& g, int n) {
  return g.bias ? g.bias[n] : 0.f;
}

// What an output row's elements share: its sample and time index, and its
// epilogue mask.
struct EpilogueRow {
  int m, b, tr;
  float rm;
};

__device__ __forceinline__ EpilogueRow epilogue_row_of(const ConvGemm& g, int m) {
  EpilogueRow r;
  r.m = m;
  r.b = m / g.t;
  r.tr = m - r.b * g.t;
  r.rm = g.mask ? g.mask[m] : 1.f;
  return r;
}

// Dropout of row r, JAX column col of the [t, 2 * split] pre-gate tensor.
__device__ __forceinline__ float dropped(const ConvGemm& g, const EpilogueRow& r, int col,
                                         float v) {
  return site_drop(g.drop, r.b, r.tr, 2 * g.split, col, v);
}

__device__ __forceinline__ float coupling_logs(const ConvGemm& g, float raw) {
  return g.flag ? logf(1e-6f + sigmoidf(raw + 2.f)) : raw;
}

// kGateBwd at column j of row r: acc = da; aux = tanh, aux2 = sigmoid
// [rows, ld_aux]; out = d_in_act (where given; the per-sample conditioning
// gradient's input) and out2 = d_xin [rows, 2 * split], out3 = acts.
// du_x, dv_x: d_xin's two elements, for a caller that also lays them out
// K-major (conv_gemm_tc_kernel, ConvGemm::out4).
__device__ __forceinline__ void gate_bwd(const ConvGemm& g, const EpilogueRow& r, int j,
                                         float da, float& du_x, float& dv_x) {
  const long m = r.m;
  const float th = g.aux[m * g.ld_aux + j];
  const float sg = g.aux2[m * g.ld_aux + j];
  const float du = da * sg * (1.f - th * th);
  const float dv = da * th * sg * (1.f - sg);
  if (g.out) {
    g.out[m * g.ldo + j] = du;
    g.out[m * g.ldo + g.split + j] = dv;
  }
  du_x = dropped(g, r, j, du);
  dv_x = dropped(g, r, g.split + j, dv);
  float* dx = g.out2 + m * g.ldo2;
  dx[j] = du_x;
  dx[g.split + j] = dv_x;
  g.out3[m * g.ldo3 + j] = th * sg;
}

// The elementwise tail of one output row's kW consecutive logical columns
// n0 .. n0 + kW - 1 (kW even; a pair of the paired epilogues is two
// neighbouring columns).  One thread owns each element it reads and writes,
// so the epilogues that update `out` in place need no ordering.
template <int kW>
__device__ __forceinline__ void epilogue_cols(const ConvGemm& g, const EpilogueRow& r, int n0,
                                              const float (&acc)[kW]) {
  const int m = r.m;
  const float rm = r.rm;
  float* out = g.out + (long)m * g.ldo;
  switch (g.epilogue) {
    case kGate:
    case kCouplingInv:
    case kCouplingFwd: {
      // acc[2p], acc[2p + 1] are the pair (j, j + split), j = (n0 + 2p) / 2
      for (int p = 0; p < kW / 2; ++p) {
        const int n = n0 + 2 * p;
        if (n >= g.n) break;
        const int j = n >> 1;
        float lo = acc[2 * p] + bias_at(g, j);
        float hi = acc[2 * p + 1] + bias_at(g, j + g.split);
        if (g.epilogue == kGate) {
          lo = dropped(g, r, j, lo);
          hi = dropped(g, r, j + g.split, hi);
          if (g.aux) {
            const float* gb = g.aux + (long)r.b * g.ld_aux;
            lo += gb[j];
            hi += gb[j + g.split];
          }
          const float th = tanhf(lo);
          const float sg = sigmoidf(hi);
          out[j] = th * sg;
          if (g.out2) {
            g.out2[(long)m * g.ldo2 + j] = th;
            g.out3[(long)m * g.ldo3 + j] = sg;
          }
        } else if (g.epilogue == kCouplingInv) {  // aux holds x = [x0 | x1]
          const float* x = g.aux + (long)m * g.ld_aux;
          out[j] = x[j];
          out[g.split + j] = (x[g.split + j] - lo) * expf(-coupling_logs(g, hi)) * rm;
        } else {  // kCouplingFwd: out holds x1
          const float logs = coupling_logs(g, hi);
          out[j] = (lo + expf(logs) * out[j]) * rm;
          g.out2[(long)m * g.ldo2 + j] = logs * rm;
        }
      }
      break;
    }
    case kResSkip: {
      for (int e = 0; e < kW; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        const float v = acc[e] + bias_at(g, n);
        if (n < g.split) {
          if (g.flag) {
            const float base = g.aux ? g.aux[(long)m * g.ld_aux + n] : out[n];
            out[n] = (base + v) * rm;
          }
        } else {
          float* s = g.out2 + (long)m * g.ldo2 + n - g.split;
          const float sum = g.skip_init ? v : *s + v;
          *s = g.skip_mask ? sum * rm : sum;
        }
      }
      break;
    }
    case kCouplingBwd: {
      // acc = logs_raw of column split + j (B and bias start there);
      // aux = dz, aux2 = zp (x1), aux3 = dld [batch]; out = dout, out2 = dzp
      const float dld = g.aux3[r.b];
      for (int e = 0; e < kW; ++e) {
        const int j = n0 + e;
        if (j >= g.n) break;
        const float raw = acc[e] + bias_at(g, j);
        const float logs = coupling_logs(g, raw);
        const float el = expf(logs);
        const long at = (long)m * g.ld_aux + g.split + j;
        const float dz1m = g.aux[at] * rm;
        float dlogs = dz1m * el * g.aux2[at] + dld * rm;
        if (g.flag) {
          const float s = sigmoidf(raw + 2.f);
          dlogs = dlogs * (s * (1.f - s)) / (1e-6f + s);
        }
        out[j] = dz1m;
        out[g.split + j] = dlogs;
        g.out2[(long)m * g.ldo2 + g.split + j] = dz1m * el * rm;
      }
      break;
    }
    case kGateBwd: {
      float du, dv;
      for (int e = 0; e < kW; ++e) {
        const int j = n0 + e;
        if (j >= g.n) break;
        gate_bwd(g, r, j, acc[e], du, dv);
      }
      break;
    }
    case kAccumMask: {
      for (int e = 0; e < kW; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        const float v = out[n] * rm + acc[e];
        out[n] = v;
        if (g.out2) g.out2[(long)m * g.ldo2 + n] = v * rm;
      }
      break;
    }
    case kMaskReluBwd: {
      const float sc = g.drop.on ? g.drop.scale * rm : rm;
      for (int e = 0; e < kW; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        out[n] = g.aux[(long)m * g.ld_aux + n] > 0.f ? acc[e] * sc : 0.f;
      }
      break;
    }
    case kMaskAdd: {
      for (int e = 0; e < kW; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        out[n] = acc[e] * rm + g.aux[(long)m * g.ld_aux + n];
      }
      break;
    }
    default: {
      for (int e = 0; e < kW; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        float v = acc[e] + bias_at(g, n);
        if (g.epilogue == kBiasRelu || g.epilogue == kBiasReluMask) v = fmaxf(v, 0.f);
        if (g.epilogue == kResidMask) v = (g.aux[(long)m * g.ld_aux + n] + v) * rm;
        if (g.epilogue == kBiasMask || g.epilogue == kBiasReluMask) v *= rm;
        if (g.epilogue != kResidMask) v = site_drop(g.drop, r.b, r.tr, g.n, n, v);
        out[n] = v;
      }
    }
  }
}

template <int kW>
__device__ __forceinline__ void epilogue_row(const ConvGemm& g, int m, int n0,
                                             const float (&acc)[kW]) {
  epilogue_cols<kW>(g, epilogue_row_of(g, m), n0, acc);
}

// The bf16 chains' epilogues (ConvGemm::bf16): the same tails, each operand
// read and written as its bit says, rounded to bf16 where the JAX kernel
// casts with dtype bf16.  What a product alone reads is not rounded here:
// the product rounds its operands as it stages them.
//  * kGate: out = th * sg (acts, read by the res/skip product); out2 / out3
//    the gates (the saves, bf16); aux the conditioning (bf16).
//  * kResSkip: rs = bf16(acc + b) (wn_pallas._layer_fwd's rs.astype);
//    residual half out = bf16(base + rs) * mask; skip half out2 += rs (f32)
//    and, with skip_mask, out3 = bf16(sum) * mask (skipm, bf16).
//  * kCouplingFwd: m, logs_raw = bf16(acc + b) (the end conv's out.astype);
//    out (holding x1) = bf16((m + e^logs x1) * mask); out2 = logs * mask.
//  * kCouplingBwd: logs_raw = bf16(acc + b); aux dz, aux2 zp (bf16).
//  * kGateBwd: aux / aux2 the saved gates (bf16); out3 (acts) per kOut3_16.
//  * kAccumMask: out2 per kOut2_16; out_c, where given, out's bf16 copy
//    (the WN stack's dx: its last layer's gx, rounded).
//  * the plain ones: aux per kAux16, out per kOut16, or rounded in f32 with
//    kRoundOut.
// Where the chain gives out_c / out2_c, the f32 cotangents written to out
// and out2 (dout and dzp's second half by kCouplingBwd, d_xin by kGateBwd,
// the masked gx by kAccumMask, dpre by kMaskReluBwd, the plain ones' out:
// the text chains' dout_h, and rm by kBiasReluMask) are also written there
// in bf16: the copy a product reads, rounded once as the JAX kernel's
// ``.astype(bf16)`` before its dots.  The flow chains' cotangents are read
// only through that copy and their column sums (ConvGemm::sums), so their
// f32 out / out2 are null and not written: the epilogue adds each f32
// value into cs[slot][e] (sum_slot: which sum and column), and the kernel
// adds cs over its tile's rows.
__device__ __forceinline__ void st_copy(float* p, long i, float v) {
  if (p) st_act(p, i, v, true);
}

// The column sums a cotangent epilogue keeps: slots a column.
__host__ __device__ __forceinline__ int sum_slots(int epilogue) {
  return epilogue == kGateBwd ? 4 : epilogue == kCouplingBwd ? 3 : 1;
}

// Slot s of column n's sums: the TileSums it goes to (p null: none kept)
// and its column there.  kGateBwd: d_xin's (du, dv) at (n, split + n) of
// sums, d_in_act's at the same columns of sums2; kCouplingBwd: dout's (dm,
// dlogs) at (n, split + n) of sums, dx1 at split + n of sums2 (dzp's);
// the rest: column n of sums.  By value: an address of a member of the
// kernel's parameter would copy the whole descriptor to local memory.
__device__ __forceinline__ TileSums sum_slot(const ConvGemm& g, int s, int n, int* col) {
  const bool dx1 = g.epilogue == kCouplingBwd && s == 2;
  *col = (s & 1) || dx1 ? g.split + n : n;
  return (g.epilogue == kGateBwd && s >= 2) || dx1 ? g.sums2 : g.sums;
}

// cs += v, never contracted into a multiply before it: a sum of the
// values as the epilogue computes them.
__device__ __forceinline__ void add_sum(float& cs, float v) { cs = __fadd_rn(cs, v); }

// kGate's gates of the pair (j, split + j) of row r from its
// pre-activations lo, hi (acc + b): dropout, the conditioning (in_lo,
// in_hi, where aux), then th = tanh, sg = sigmoid.
__device__ __forceinline__ void gate_values(const ConvGemm& g, const EpilogueRow& r, int j,
                                            float lo, float hi, float in_lo, float in_hi,
                                            float& th, float& sg) {
  lo = dropped(g, r, j, lo);
  hi = dropped(g, r, j + g.split, hi);
  if (g.aux) {
    lo += in_lo;
    hi += in_hi;
  }
  th = tanhf(lo);
  sg = sigmoidf(hi);
}

// kResSkip's value of one element, rs = bf16(acc + b): the residual half's
// next x, bf16(base + rs) * mask (its store rounds it), and the skip half's
// sum (+= rs; rs where it starts the sum).
__device__ __forceinline__ float res_skip_x(float base, float acc, float bias, float rm) {
  return round_bf16(base + round_bf16(acc + bias)) * rm;
}

__device__ __forceinline__ float res_skip_sum(const ConvGemm& g, float so_far, float acc,
                                              float bias) {
  const float v = round_bf16(acc + bias);
  return g.skip_init ? v : so_far + v;
}

// Elements i and i + 1 of a bf16 tensor (i even) as one 4-byte access.
__device__ __forceinline__ float2 ld_pair16(const float* p, long i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      reinterpret_cast<const __nv_bfloat16*>(p) + i));
}

__device__ __forceinline__ void st_pair16(float* p, long i, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(p) + i) =
      __floats2bfloat162_rn(a, b);
}

// kResSkip's operands and tail of one row's kW / 2 column pairs, pair p at
// n0 + p kS and + 1 (cnt elements below n), each operand loaded and each
// result stored as one pair (bf16x2 or float2): a bf16 chain's res/skip
// (x and skipm bf16, the skip sum f32) on the warp-specialised unit.  in:
// each element's base, the residual half's x (where the layer updates it)
// or the skip half's sum so far (where it adds to it); the tail: the
// residual half out = res_skip_x, the skip half out2 = res_skip_sum and,
// with skip_mask, out3 = bf16(sum) * mask.
template <int kW, int kS>
__device__ __forceinline__ void res_skip_pair_operands(const ConvGemm& g, long m, int n0,
                                                       int cnt, float (&in)[kW]) {
#pragma unroll
  for (int e = 0; e < kW; e += 2) {
    if (e >= cnt) break;
    const int n = n0 + (e >> 1) * kS;
    float2 v = make_float2(0.f, 0.f);
    if (n < g.split) {
      if (g.flag) v = ld_pair16(g.aux ? g.aux : g.out, m * (g.aux ? g.ld_aux : g.ldo) + n);
    } else if (!g.skip_init) {
      v = *reinterpret_cast<const float2*>(g.out2 + m * g.ldo2 + n - g.split);
    }
    in[e] = v.x;
    in[e + 1] = v.y;
  }
}

template <int kW, int kS>
__device__ __forceinline__ void res_skip_pair_tail(const ConvGemm& g, long m, float rm, int n0,
                                                   int cnt, const float (&acc)[kW],
                                                   const float (&bias)[kW],
                                                   const float (&in)[kW]) {
#pragma unroll
  for (int e = 0; e < kW; e += 2) {
    if (e >= cnt) break;
    const int n = n0 + (e >> 1) * kS;
    if (n < g.split) {
      if (g.flag)
        st_pair16(g.out, m * g.ldo + n, res_skip_x(in[e], acc[e], bias[e], rm),
                  res_skip_x(in[e + 1], acc[e + 1], bias[e + 1], rm));
    } else {
      const float s0 = res_skip_sum(g, in[e], acc[e], bias[e]);
      const float s1 = res_skip_sum(g, in[e + 1], acc[e + 1], bias[e + 1]);
      *reinterpret_cast<float2*>(g.out2 + m * g.ldo2 + n - g.split) = make_float2(s0, s1);
      if (g.skip_mask)
        st_pair16(g.out3, m * g.ldo3 + n - g.split, round_bf16(s0) * rm, round_bf16(s1) * rm);
    }
  }
}

// Columns: kW / 2 pairs, pair p at n0 + p kS and n0 + p kS + 1 (kS 2:
// kW neighbouring columns; the paired epilogues take only that); cs[s][e]
// is element e's.
template <int kW, int kS = 2>
__device__ __forceinline__ void epilogue_cols_bf16(const ConvGemm& g, const EpilogueRow& r,
                                                   int n0, const float (&acc)[kW],
                                                   float (&cs)[4][kW]) {
  const long m = r.m;
  const float rm = r.rm;
  const unsigned bits = g.bf16;
  const bool out16 = has(bits, kOut16), out2_16 = has(bits, kOut2_16);
  const bool out3_16 = has(bits, kOut3_16), aux16 = has(bits, kAux16);
  const bool aux2_16 = has(bits, kAux2_16);
  const long ob = m * g.ldo;  // this row's first element of out
  // Each case loads every operand of its columns before it stores a result
  // (a load cannot move above a store to a pointer that may alias it): the
  // loads of a call are in flight together, one latency a call, not one a
  // column.  cnt: the elements whose columns lie below n.
  auto col = [&](int e) { return n0 + (e >> 1) * kS + (e & 1); };
  int cnt = 0;
#pragma unroll
  for (int e = 0; e < kW; ++e) cnt += col(e) < g.n;
  switch (g.epilogue) {
    case kGate:
    case kCouplingFwd: {
      constexpr int kP = kW / 2;  // pairs (j, j + split) at columns n0 + 2p, + 1
      float b_lo[kP], b_hi[kP], in_lo[kP], in_hi[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (2 * p >= cnt) break;
        const int j = (n0 >> 1) + p;
        b_lo[p] = bias_at(g, j);
        b_hi[p] = bias_at(g, j + g.split);
        if (g.epilogue == kCouplingFwd) {  // out holds x1
          in_lo[p] = ld_act(g.out, ob + j, out16);
        } else if (g.aux) {  // the conditioning
          const long gb = (long)r.b * g.ld_aux;
          in_lo[p] = ld_act(g.aux, gb + j, aux16);
          in_hi[p] = ld_act(g.aux, gb + j + g.split, aux16);
        } else {
          in_lo[p] = in_hi[p] = 0.f;  // not read
        }
      }
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (2 * p >= cnt) break;
        const int j = (n0 >> 1) + p;
        float lo = acc[2 * p] + b_lo[p];
        float hi = acc[2 * p + 1] + b_hi[p];
        if (g.epilogue == kGate) {
          float th, sg;
          gate_values(g, r, j, lo, hi, in_lo[p], in_hi[p], th, sg);
          st_act(g.out, ob + j, th * sg, out16);
          if (g.out2) {
            st_act(g.out2, m * g.ldo2 + j, th, out2_16);
            st_act(g.out3, m * g.ldo3 + j, sg, out3_16);
          }
        } else {
          const float logs = coupling_logs(g, round_bf16(hi));
          st_act(g.out, ob + j, (round_bf16(lo) + expf(logs) * in_lo[p]) * rm, out16);
          g.out2[m * g.ldo2 + j] = logs * rm;
        }
      }
      break;
    }
    case kResSkip: {
      float bias[kW], in[kW];
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        const int n = col(e);
        bias[e] = bias_at(g, n);
        if (n < g.split) {  // the residual's base
          if (g.flag)
            in[e] = g.aux ? ld_act(g.aux, m * g.ld_aux + n, aux16) : ld_act(g.out, ob + n, out16);
        } else if (!g.skip_init) {  // the skip sum so far
          in[e] = g.out2[m * g.ldo2 + n - g.split];
        }
      }
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        const int n = col(e);
        if (n < g.split) {
          if (g.flag) st_act(g.out, ob + n, res_skip_x(in[e], acc[e], bias[e], rm), out16);
        } else {
          const float sum = res_skip_sum(g, in[e], acc[e], bias[e]);
          g.out2[m * g.ldo2 + n - g.split] = sum;
          if (g.skip_mask) st_act(g.out3, m * g.ldo3 + n - g.split, round_bf16(sum) * rm, out3_16);
        }
      }
      break;
    }
    case kCouplingBwd: {
      const float dld = g.aux3[r.b];
      float bias[kW], dz[kW], x1[kW];
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        const long at = m * g.ld_aux + g.split + col(e);
        bias[e] = bias_at(g, col(e));
        dz[e] = ld_act(g.aux, at, aux16);
        x1[e] = ld_act(g.aux2, at, aux2_16);
      }
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        const int j = col(e);
        const float raw = round_bf16(acc[e] + bias[e]);
        const float logs = coupling_logs(g, raw);
        const float el = expf(logs);
        const float dz1m = dz[e] * rm;
        float dlogs = dz1m * el * x1[e] + dld * rm;
        if (g.flag) {
          const float sgm = sigmoidf(raw + 2.f);
          dlogs = dlogs * (sgm * (1.f - sgm)) / (1e-6f + sgm);
        }
        const float dx1 = dz1m * el * rm;
        if (g.out) {
          g.out[ob + j] = dz1m;
          g.out[ob + g.split + j] = dlogs;
        }
        if (g.out2) g.out2[m * g.ldo2 + g.split + j] = dx1;
        add_sum(cs[0][e], dz1m);
        add_sum(cs[1][e], dlogs);
        add_sum(cs[2][e], dx1);
        st_copy(g.out_c, ob + j, dz1m);
        st_copy(g.out_c, ob + g.split + j, dlogs);
        st_copy(g.out2_c, m * g.ldo2 + g.split + j, dx1);
      }
      break;
    }
    case kGateBwd: {
      float th[kW], sg[kW];
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        th[e] = ld_act(g.aux, m * g.ld_aux + col(e), aux16);
        sg[e] = ld_act(g.aux2, m * g.ld_aux + col(e), aux2_16);
      }
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        const int j = col(e);
        const float da = acc[e];
        const float du = da * sg[e] * (1.f - th[e] * th[e]);
        const float dv = da * th[e] * sg[e] * (1.f - sg[e]);
        if (g.out) {
          g.out[ob + j] = du;
          g.out[ob + g.split + j] = dv;
        }
        const long dx = m * g.ldo2;
        const float du_x = dropped(g, r, j, du), dv_x = dropped(g, r, g.split + j, dv);
        if (g.out2) {
          g.out2[dx + j] = du_x;
          g.out2[dx + g.split + j] = dv_x;
        }
        add_sum(cs[0][e], du_x);
        add_sum(cs[1][e], dv_x);
        add_sum(cs[2][e], du);
        add_sum(cs[3][e], dv);
        st_copy(g.out2_c, dx + j, du_x);
        st_copy(g.out2_c, dx + g.split + j, dv_x);
        st_act(g.out3, m * g.ldo3 + j, th[e] * sg[e], out3_16);
      }
      break;
    }
    case kAccumMask: {
      float prev[kW];
#pragma unroll
      for (int e = 0; e < kW; ++e)
        if (e < cnt) prev[e] = g.out[ob + col(e)];
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        const int n = col(e);
        const float v = prev[e] * rm + acc[e];
        g.out[ob + n] = v;
        st_copy(g.out_c, ob + n, v);
        if (g.out2) st_act(g.out2, m * g.ldo2 + n, v * rm, out2_16);
        st_copy(g.out2_c, m * g.ldo2 + n, v * rm);
        add_sum(cs[0][e], v * rm);
      }
      break;
    }
    case kMaskReluBwd: {
      const float sc = g.drop.on ? g.drop.scale * rm : rm;
      for (int e = 0; e < kW; ++e) {
        const int n = col(e);
        if (n >= g.n) break;
        const float v = ld_act(g.aux, m * g.ld_aux + n, aux16) > 0.f ? acc[e] * sc : 0.f;
        g.out[ob + n] = v;
        st_copy(g.out_c, ob + n, v);
      }
      break;
    }
    case kMaskAdd: {
      for (int e = 0; e < kW; ++e) {
        const int n = col(e);
        if (n >= g.n) break;
        g.out[ob + n] = acc[e] * rm + ld_act(g.aux, m * g.ld_aux + n, aux16);
      }
      break;
    }
    case kCouplingInv:
      break;  // serving only: never a bf16 chain's
    default: {
      const bool round_out = has(bits, kRoundOut);
      float bias[kW], res[kW];
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        bias[e] = bias_at(g, col(e));
        if (g.epilogue == kResidMask) res[e] = ld_act(g.aux, m * g.ld_aux + col(e), aux16);
      }
#pragma unroll
      for (int e = 0; e < kW; ++e) {
        if (e >= cnt) break;
        const int n = col(e);
        float v = acc[e] + bias[e];
        if (g.epilogue == kBiasRelu || g.epilogue == kBiasReluMask) v = fmaxf(v, 0.f);
        if (g.epilogue == kResidMask) v = (res[e] + v) * rm;
        if (g.epilogue == kBiasMask || g.epilogue == kBiasReluMask) v *= rm;
        if (g.epilogue != kResidMask) v = site_drop(g.drop, r.b, r.tr, g.n, n, v);
        if (round_out) v = round_bf16(v);
        if (g.out) st_act(g.out, ob + n, v, out16);
        st_copy(g.out_c, ob + n, v);
        add_sum(cs[0][e], v);
      }
    }
  }
}

template <int kW, int kS = 2>
__device__ __forceinline__ void epilogue_row_bf16(const ConvGemm& g, int m, int n0,
                                                  const float (&acc)[kW], float (&cs)[4][kW]) {
  epilogue_cols_bf16<kW, kS>(g, epilogue_row_of(g, m), n0, acc, cs);
}

}  // namespace gtt
