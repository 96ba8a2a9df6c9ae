// conv_gemm, wgrad, col_sum, layer_norm and layer_norm_bwd (see common.cuh).
//
// conv_gemm is a shared-memory SGEMM: a 64x64 output tile per block of 256
// threads, a 4x4 accumulator per thread, 32-deep K slices double-buffered
// in shared memory with the next slice's global loads in flight while the
// current one is multiplied. At serving shapes (M = batch * t rows of a few
// hundred to a few thousand, N <= 768, K <= 2304) one launch is a single
// wave of at most ~100 blocks, so its time is the length of one block's
// serial K walk: latency, not FLOPs or bytes (every operand fits in L2).
// Hence the prefetch and the deep slices. The im2col gather happens while
// staging A, so the [rows, taps * c_in] matrix the TPU kernel builds in
// VMEM never exists in device memory, and the epilogue applies each TPU
// kernel's elementwise tail before the one store. Tensor cores (wgmma,
// TF32/bf16) and split-K for more blocks at b=1 are later work.
#include "common.cuh"

#include <math.h>

#include <algorithm>

namespace gtt {
namespace {

// Tile: kBM x kBN outputs per block, 4 x 4 per thread; kBM is 64, or 32
// when 64-row tiles would leave SMs idle (small batch).
constexpr int kBN = 64;
constexpr int kBK = 32;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ bool paired(int epilogue) {
  return epilogue == kGate || epilogue == kCouplingInv ||
         epilogue == kGateSave || epilogue == kCouplingFwd;
}

// Logical output column -> column of B / bias.
__device__ __forceinline__ int physical_col(const ConvGemm& g, int n) {
  return paired(g.epilogue) ? (n >> 1) + (n & 1) * g.split : n;
}

__device__ __forceinline__ float bias_at(const ConvGemm& g, int n) {
  return g.bias ? g.bias[n] : 0.f;
}

// Dropout of row m, JAX column col of the [t, 2 * split] pre-gate tensor.
__device__ __forceinline__ float dropped(const ConvGemm& g, int m, int col, float v) {
  const int b = m / g.t;
  return site_drop(g.drop, b, m - b * g.t, 2 * g.split, col, v);
}

__device__ __forceinline__ float coupling_logs(const ConvGemm& g, float raw) {
  return g.flag ? logf(1e-6f + sigmoidf(raw + 2.f)) : raw;
}

__device__ __forceinline__ void epilogue_row(const ConvGemm& g, int m, int n0,
                             const float (&acc)[4]) {
  const float rm = g.mask ? g.mask[m] : 1.f;
  float* out = g.out + (long)m * g.ldo;
  switch (g.epilogue) {
    case kGate:
    case kGateSave:
    case kCouplingInv:
    case kCouplingFwd: {
      // acc[2p], acc[2p + 1] are the pair (j, j + split), j = (n0 + 2p) / 2
      for (int p = 0; p < 2; ++p) {
        const int n = n0 + 2 * p;
        if (n >= g.n) break;
        const int j = n >> 1;
        float lo = acc[2 * p] + bias_at(g, j);
        float hi = acc[2 * p + 1] + bias_at(g, j + g.split);
        if (g.epilogue == kGate || g.epilogue == kGateSave) {
          if (g.epilogue == kGateSave) {
            lo = dropped(g, m, j, lo);
            hi = dropped(g, m, j + g.split, hi);
          }
          if (g.aux) {
            const float* gb = g.aux + (long)(m / g.t) * g.ld_aux;
            lo += gb[j];
            hi += gb[j + g.split];
          }
          const float th = tanhf(lo);
          const float sg = sigmoidf(hi);
          out[j] = th * sg;
          if (g.epilogue == kGateSave) {
            g.out2[(long)m * g.ldo2 + j] = th;
            g.out3[(long)m * g.ldo3 + j] = sg;
          }
        } else if (g.epilogue == kCouplingInv) {
          out[j] = (out[j] - lo) * expf(-coupling_logs(g, hi)) * rm;
        } else {  // kCouplingFwd: out holds x1
          const float logs = coupling_logs(g, hi);
          out[j] = (lo + expf(logs) * out[j]) * rm;
          g.out2[(long)m * g.ldo2 + j] = logs * rm;
        }
      }
      break;
    }
    case kResSkip: {
      for (int e = 0; e < 4; ++e) {
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
          *s = g.skip_mask ? (*s + v) * rm : *s + v;
        }
      }
      break;
    }
    case kCouplingBwd: {
      // acc = logs_raw of column split + j (B and bias start there);
      // aux = dz, aux2 = zp (x1), aux3 = dld [batch]; out = dout, out2 = dzp
      const float dld = g.aux3[m / g.t];
      for (int e = 0; e < 4; ++e) {
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
      // acc = da; aux = tanh, aux2 = sigmoid [rows, ld_aux]; out = d_in_act
      // and out2 = d_xin [rows, 2 * split], out3 = acts
      for (int e = 0; e < 4; ++e) {
        const int j = n0 + e;
        if (j >= g.n) break;
        const float da = acc[e];
        const float th = g.aux[(long)m * g.ld_aux + j];
        const float sg = g.aux2[(long)m * g.ld_aux + j];
        const float du = da * sg * (1.f - th * th);
        const float dv = da * th * sg * (1.f - sg);
        out[j] = du;
        out[g.split + j] = dv;
        float* dx = g.out2 + (long)m * g.ldo2;
        dx[j] = dropped(g, m, j, du);
        dx[g.split + j] = dropped(g, m, g.split + j, dv);
        g.out3[(long)m * g.ldo3 + j] = th * sg;
      }
      break;
    }
    case kAccumMask: {
      for (int e = 0; e < 4; ++e) {
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
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        out[n] = g.aux[(long)m * g.ld_aux + n] > 0.f ? acc[e] * sc : 0.f;
      }
      break;
    }
    case kMaskAdd: {
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        out[n] = acc[e] * rm + g.aux[(long)m * g.ld_aux + n];
      }
      break;
    }
    default: {
      const int b = m / g.t;
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        float v = acc[e] + bias_at(g, n);
        if (g.epilogue == kBiasRelu) v = fmaxf(v, 0.f);
        if (g.epilogue == kResidMask) v = (g.aux[(long)m * g.ld_aux + n] + v) * rm;
        if (g.epilogue == kBiasMask) v *= rm;
        if (g.epilogue != kResidMask) v = site_drop(g.drop, b, m - b * g.t, g.n, n, v);
        out[n] = v;
      }
    }
  }
}

template <int kBM>
__global__ void __launch_bounds__(kBM * 4) conv_gemm_kernel(const ConvGemm g) {
  constexpr int kThreads = kBM * 4;
  constexpr int kALoads = kBM * kBK / kThreads;  // A elements staged per thread
  constexpr int kBLoads = kBN * kBK / kThreads;
  constexpr int kARowStep = kThreads / kBK;
  constexpr int kBRowStep = kThreads / kBN;
  // Double-buffered K slices; A kept row-major (padded to keep float4
  // alignment) so the staging stores of a warp hit 32 consecutive words.
  __shared__ __align__(16) float as[2][kBM][kBK + 4];
  __shared__ __align__(16) float bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int rows = g.batch * g.t;
  const int kdim = g.taps * g.c_in;
  const int half_taps = g.taps / 2;

  // A staging: this thread loads im2col column a_kk of rows a_r0 +
  // kARowStep * i; a warp reads 32 neighbouring channels of one source row
  const int a_kk = tid % kBK;
  const int a_r0 = tid / kBK;
  int a_row0[kALoads];  // b * t of the row's sample, -1 past the last row
  int a_t[kALoads];     // the row's time index
#pragma unroll
  for (int i = 0; i < kALoads; ++i) {
    const int m = m0 + a_r0 + kARowStep * i;
    const int b = m / g.t;
    a_row0[i] = m < rows ? b * g.t : -1;
    a_t[i] = m - b * g.t;
  }
  // B staging: column b_nn of K rows b_k0 + kBRowStep * i
  const int b_nn = tid % kBN;
  const int b_k0 = tid / kBN;
  const bool b_ok = n0 + b_nn < g.n;
  const int b_col = b_ok ? physical_col(g, n0 + b_nn) : 0;
  const int ldb = g.ldb ? g.ldb : g.n;

  float ra[kALoads];
  float rb[kBLoads];
  auto load = [&](int k0) {
    const int kidx = k0 + a_kk;
    const bool k_ok = kidx < kdim;
    const int tap = k_ok ? kidx / g.c_in : 0;
    const int c = kidx - tap * g.c_in;
    const int off = g.tap_sign * (tap - half_taps) * g.dilation;
#pragma unroll
    for (int i = 0; i < kALoads; ++i) {
      const int ts = a_t[i] + off;
      float v = 0.f;
      if (k_ok && a_row0[i] >= 0 && ts >= 0 && ts < g.t) {
        const long src = (long)a_row0[i] + ts;
        v = g.a[src * g.lda + c];
        if (g.a_mask) v *= g.a_mask[src];
      }
      ra[i] = v;
    }
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) {
      const int kid = k0 + b_k0 + kBRowStep * i;
      rb[i] = (b_ok && kid < kdim) ? g.w[(long)kid * ldb + b_col] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kALoads; ++i) as[buf][a_r0 + kARowStep * i][a_kk] = ra[i];
#pragma unroll
    for (int i = 0; i < kBLoads; ++i) bs[buf][b_k0 + kBRowStep * i][b_nn] = rb[i];
  };

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    const bool more = k0 + kBK < kdim;
    if (more) load(k0 + kBK);  // in flight during the FMAs below
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a4[4], b4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a4[i] = *reinterpret_cast<const float4*>(&as[buf][ty * 4 + i][kk]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b4[q] = *reinterpret_cast<const float4*>(&bs[buf][kk + q][tx * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a[4] = {a4[i].x, a4[i].y, a4[i].z, a4[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(a[q], b4[q].x, acc[i][0]);
          acc[i][1] = fmaf(a[q], b4[q].y, acc[i][1]);
          acc[i][2] = fmaf(a[q], b4[q].z, acc[i][2]);
          acc[i][3] = fmaf(a[q], b4[q].w, acc[i][3]);
        }
      }
    }
    if (more) store(buf ^ 1);  // buf ^ 1 was last read before the previous barrier
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m < rows) epilogue_row(g, m, n0 + tx * 4, acc[i]);
  }
}

// Weight gradient: a 64 (kk) x 64 (n) output tile per block of 256
// threads, 4 x 4 per thread, reducing over this block's split of the rows
// in slices of 32 staged through shared memory.
constexpr int kWK = 64;
constexpr int kWN = 64;
constexpr int kWM = 32;

__global__ void __launch_bounds__(256) wgrad_kernel(const WGrad w, int rows_per_split,
                                                    float* dst) {
  __shared__ __align__(16) float as[kWM][kWK + 4];
  __shared__ __align__(16) float bs[kWM][kWN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int n0 = blockIdx.x * kWN;
  const int k0 = blockIdx.y * kWK;
  const int rows = w.batch * w.t;
  const int kdim = w.taps * w.c_in;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(rows, m_begin + rows_per_split);
  const int half_taps = w.taps / 2;
  // staging: column tid % 64 of rows tid / 64 + 4 * i
  const int s_col = tid % 64;
  const int s_row = tid / 64;
  const int kk = k0 + s_col;
  const bool k_ok = kk < kdim;
  const int tap = k_ok ? kk / w.c_in : 0;
  const int c = kk - tap * w.c_in;
  const int off = (tap - half_taps) * w.dilation;
  const bool n_ok = n0 + s_col < w.n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int m0 = m_begin; m0 < m_end; m0 += kWM) {
#pragma unroll
    for (int i = 0; i < kWM / 4; ++i) {
      const int r = s_row + 4 * i;
      const int m = m0 + r;
      float va = 0.f, vb = 0.f;
      if (m < m_end) {
        const int b = m / w.t;
        const int ts = m - b * w.t + off;
        if (k_ok && ts >= 0 && ts < w.t) {
          const long src = (long)b * w.t + ts;
          va = w.a[src * w.lda + c];
          if (w.a_mask) va *= w.a_mask[src];
        }
        if (n_ok) {
          vb = w.dy[(long)m * w.ldy + n0 + s_col];
          if (w.dy_mask) vb *= w.dy_mask[m];
        }
      }
      as[r][s_col] = va;
      bs[r][s_col] = vb;
    }
    __syncthreads();
#pragma unroll 8
    for (int mm = 0; mm < kWM; ++mm) {
      const float4 a4 = *reinterpret_cast<const float4*>(&as[mm][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&bs[mm][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a[i], b4.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b4.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b4.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b4.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
  float* out = dst + (long)blockIdx.z * kdim * w.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= kdim) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < w.n) out[(long)k * w.n + n] = acc[i][j];
    }
  }
}

// One column per threadIdx.x, 8 row groups per column, summed in a fixed
// order through shared memory.
__global__ void col_sum_kernel(const float* x, const float* mul, int ld, int n,
                               const float* mask, int T, float* out, int ldo) {
  __shared__ float part[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int s = blockIdx.y;
  float v = 0.f;
  if (j < n) {
    for (int r = threadIdx.y; r < T; r += 8) {
      const long row = (long)s * T + r;
      float e = x[row * ld + j];
      if (mul) e *= mul[row * ld + j];
      if (mask) e *= mask[row];
      v += e;
    }
  }
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    float total = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) total += part[y][threadIdx.x];
    out[(long)s * ldo + j] = total;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void layer_norm_kernel(const LayerNorm a) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= a.rows) return;
  const long base = (long)row * a.n;
  const float xm = a.x_mask ? a.x_mask[row] : 1.f;
  auto load = [&](int c) {
    float v = a.x[base + c] * xm;
    if (a.resid) v += a.resid[base + c];
    if (a.relu_before) v = fmaxf(v, 0.f);
    return v;
  };
  float s = 0.f;
  for (int c = lane; c < a.n; c += 32) s += load(c);
  const float mean = warp_sum(s) / a.n;
  float q = 0.f;
  for (int c = lane; c < a.n; c += 32) {
    const float d = load(c) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / a.n + 1e-4f);
  if (a.rstd && lane == 0) a.rstd[row] = rstd;
  const int b = a.t > 0 ? row / a.t : 0;
  const int tr = row - b * a.t;
  for (int c = lane; c < a.n; c += 32) {
    const float xh = (load(c) - mean) * rstd;
    if (a.xhat) a.xhat[base + c] = xh;
    float y = xh * a.gamma[c] + a.beta[c];
    if (a.relu_after) y = fmaxf(y, 0.f);
    a.out[base + c] = site_drop(a.drop, b, tr, a.n, c, y);
  }
}

__global__ void layer_norm_bwd_kernel(const LayerNormBwd a) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= a.rows) return;
  const long base = (long)row * a.n;
  const int b = a.t > 0 ? row / a.t : 0;
  const int tr = row - b * a.t;
  auto dy_eff = [&](int c) {
    float v = site_drop(a.drop, b, tr, a.n, c, a.dy[base + c]);
    if (a.relu_after && a.xhat[base + c] * a.gamma[c] + a.beta[c] <= 0.f) v = 0.f;
    return v;
  };
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < a.n; c += 32) {
    const float g = dy_eff(c) * a.gamma[c];
    s1 += g;
    s2 += g * a.xhat[base + c];
  }
  const float m1 = warp_sum(s1) / a.n;
  const float m2 = warp_sum(s2) / a.n;
  const float rstd = a.rstd[row];
  const float rm2 = a.mask2 ? a.mask2[row] : 1.f;
  for (int c = lane; c < a.n; c += 32) {
    const float de = dy_eff(c);  // before any aliased store below
    const float xh = a.xhat[base + c];
    float dx = (de * a.gamma[c] - m1 - xh * m2) * rstd;
    if (a.relu_src && a.relu_src[base + c] <= 0.f) dx = 0.f;
    if (a.dyeff) a.dyeff[base + c] = de;
    a.dx[base + c] = dx;
    if (a.dx2) a.dx2[base + c] = site_drop(a.drop2, b, tr, a.n, c, dx) * rm2;
  }
}

}  // namespace

cudaError_t conv_gemm(const ConvGemm& g, cudaStream_t stream) {
  const int rows = g.batch * g.t;
  if (rows <= 0 || g.n <= 0) return cudaSuccess;
  int dev = 0, sms = 0;  // SM count of the caller's current device
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int n_tiles = (g.n + kBN - 1) / kBN;
  if (((rows + 63) / 64) * n_tiles >= sms) {
    conv_gemm_kernel<64><<<dim3(n_tiles, (rows + 63) / 64), 256, 0, stream>>>(g);
  } else {
    conv_gemm_kernel<32><<<dim3(n_tiles, (rows + 31) / 32), 128, 0, stream>>>(g);
  }
  return cudaGetLastError();
}

cudaError_t col_sum(const float* x, int ld, int n, const float* mask, int n_seg,
                    int T, float* out, int ldo, cudaStream_t stream) {
  if (n <= 0 || n_seg <= 0) return cudaSuccess;
  col_sum_kernel<<<dim3((n + 31) / 32, n_seg), dim3(32, 8), 0, stream>>>(
      x, nullptr, ld, n, mask, T, out, ldo);
  return cudaGetLastError();
}

cudaError_t ln_param_grads(const float* dy, const float* xhat, int n, int batch,
                           int t, float* part, float* dgamma, float* dbeta,
                           cudaStream_t stream) {
  if (n <= 0 || batch <= 0) return cudaSuccess;
  col_sum_kernel<<<dim3((n + 31) / 32, batch), dim3(32, 8), 0, stream>>>(
      dy, xhat, n, n, nullptr, t, part, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = col_sum(part, n, n, nullptr, 1, batch, dgamma, n, stream)) != cudaSuccess)
    return err;
  return bias_grad(dy, n, n, nullptr, batch, t, part, dbeta, stream);
}

cudaError_t bias_grad(const float* x, int ld, int n, const float* mask,
                      int batch, int t, float* part, float* out,
                      cudaStream_t stream) {
  cudaError_t err = col_sum(x, ld, n, mask, batch, t, part, n, stream);
  if (err != cudaSuccess) return err;
  return col_sum(part, n, n, nullptr, 1, batch, out, n, stream);
}

cudaError_t wgrad(const WGrad& w, cudaStream_t stream) {
  const int rows = w.batch * w.t;
  const int kdim = w.taps * w.c_in;
  if (kdim <= 0 || w.n <= 0) return cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = ((w.n + kWN - 1) / kWN) * ((kdim + kWK - 1) / kWK);
  const long per_split = (long)kdim * w.n;
  // about four waves of blocks, at least 64 rows a split, within scratch
  long splits = (4 * sms + tiles - 1) / tiles;
  splits = std::min(splits, std::max(1L, (rows + 63L) / 64));
  splits = std::min(splits, std::max(1L, w.scratch_floats / per_split));
  if (w.scratch == nullptr) splits = 1;
  int rows_per_split = (int)((rows + splits - 1) / splits);
  rows_per_split = ((rows_per_split + kWM - 1) / kWM) * kWM;
  splits = std::max(1, (rows + rows_per_split - 1) / rows_per_split);
  const dim3 grid((w.n + kWN - 1) / kWN, (kdim + kWK - 1) / kWK, (unsigned)splits);
  if (splits == 1) {
    wgrad_kernel<<<grid, 256, 0, stream>>>(w, rows_per_split, w.out);
    return cudaGetLastError();
  }
  wgrad_kernel<<<grid, 256, 0, stream>>>(w, rows_per_split, w.scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  // the splits' partial sums, added in split order
  return col_sum(w.scratch, (int)per_split, (int)per_split, nullptr, 1, (int)splits,
                 w.out, (int)per_split, stream);
}

cudaError_t wn_layers(float* xcur, float* acts, float* skip, const float* mask,
                      const float* w_in, const float* b_in, const float* w_rs,
                      const float* b_rs, const float* g_all, int g_stride,
                      int batch, int t, int h, int n_layers, int taps,
                      int dilation_rate, cudaStream_t stream) {
  int dilation = 1;
  for (int l = 0; l < n_layers; ++l) {
    {  // acts = tanh(u + g_u) * sigmoid(v + g_v), [u | v] = conv(xcur) + b_in
      ConvGemm g;
      g.a = xcur; g.lda = h; g.c_in = h; g.taps = taps; g.dilation = dilation;
      g.batch = batch; g.t = t;
      g.w = w_in + (long)l * taps * h * 2 * h; g.bias = b_in + l * 2 * h;
      g.n = 2 * h; g.split = h; g.epilogue = kGate; g.out = acts; g.ldo = h;
      if (g_all) {
        g.aux = g_all + l * 2 * h;
        g.ld_aux = g_stride;
      }
      cudaError_t err = conv_gemm(g, stream);
      if (err != cudaSuccess) return err;
    }
    {  // xcur = (xcur + rs[:, :h]) * mask; skip += rs[:, h:]
      ConvGemm g;
      g.a = acts; g.lda = h; g.c_in = h; g.batch = batch; g.t = t;
      g.w = w_rs + (long)l * h * 2 * h; g.bias = b_rs + l * 2 * h;
      g.n = 2 * h; g.split = h; g.epilogue = kResSkip;
      g.out = xcur; g.ldo = h; g.mask = mask; g.out2 = skip; g.ldo2 = h;
      g.flag = l < n_layers - 1;  // the last layer's residual half is zero
      cudaError_t err = conv_gemm(g, stream);
      if (err != cudaSuccess) return err;
    }
    dilation *= dilation_rate;
  }
  return cudaSuccess;
}

cudaError_t layer_norm(const LayerNorm& a, cudaStream_t stream) {
  if (a.rows <= 0) return cudaSuccess;
  const int rows_per_block = 8;
  const int blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  layer_norm_kernel<<<blocks, rows_per_block * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t layer_norm_bwd(const LayerNormBwd& a, cudaStream_t stream) {
  if (a.rows <= 0) return cudaSuccess;
  const int rows_per_block = 8;
  const int blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  layer_norm_bwd_kernel<<<blocks, rows_per_block * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gtt
