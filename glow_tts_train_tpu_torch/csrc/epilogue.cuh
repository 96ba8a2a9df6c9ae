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

}  // namespace gtt
