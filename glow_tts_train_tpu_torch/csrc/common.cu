// conv_gemm, wgrad, col_sum, layer_norm and layer_norm_bwd (see common.cuh).
//
// conv_gemm and wgrad each dispatch between two device kernels.  A chain
// that asks for the tensor cores (the flow block's and the WN stack's:
// block_train.cu, block.cu; the text side's: encoder.cu, encoder_train.cu,
// text.cu, text_train.cu, which also allow split-K; the serving inverse,
// which also allows split-K at any row count and 64-row tiles) gets
// conv_gemm_tc_kernel / wgrad_tc_kernel of tc_gemm.cu where the shape fits
// (conv_gemm_tc_fits, wgrad_tc_fits: 16-byte alignable operands, at least
// 64 / 32 columns, 32 deep, enough blocks or rows); everything else
// (narrow widths, the text side's products of a single short sentence,
// the serving block's 1x1 products at 160 rows, the folded A's forward
// product in training) runs the two kernels of this file on the CUDA
// cores.  product_counts says which way the products of a run went.
//
// conv_gemm_kernel is a shared-memory SGEMM: a 64x64 output tile per block
// of 256 threads, a 4x4 accumulator per thread, 32-deep K slices
// double-buffered in shared memory with the next slice's global loads in
// flight while the current one is multiplied. At serving shapes (M = batch
// * t rows of a few hundred to a few thousand, N <= 768, K <= 2304) one
// launch is a single wave of at most ~100 blocks, so its time is the length
// of one block's serial K walk: latency, not FLOPs or bytes (every operand
// fits in L2). Hence the prefetch, the deep slices and, below one wave of
// 64-row tiles, 32-row tiles (the products that take the tensor cores at
// b=1 get more blocks from split-K there instead). The im2col gather
// happens while staging A, so
// the [rows, taps * c_in] matrix the TPU kernel builds in VMEM never exists
// in device memory, and the epilogue (epilogue.cuh) applies each TPU
// kernel's elementwise tail before the one store. At training shapes it is
// bound by shared-memory bandwidth at about a third of the f32 peak (64 FMAs
// for 8 float4 loads a thread).
//
// wgrad_kernel: a 64x64 output tile per block over one split of the rows,
// about four waves of blocks, the splits' partial sums added in split order
// by col_sum.
#include "common.cuh"
#include "epilogue.cuh"

#include <math.h>

#include <algorithm>

namespace gtt {
namespace {

// Tile: kBM x kBN outputs per block, 4 x 4 per thread; kBM is 64, or 32
// when 64-row tiles would leave SMs idle (small batch).
constexpr int kBN = 64;
constexpr int kBK = 32;

// kWT: B is read through ConvGemm::w_t's per-tap transpose (a separate
// instantiation, so the plain one keeps its loads)
template <int kBM, bool kWT>
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
      if (kWT) {  // B[tap * c_in + j, col] = w[tap * n + col, j]
        const int tap_b = kid / g.c_in;
        rb[i] = (b_ok && kid < kdim)
                    ? g.w[((long)tap_b * g.n + b_col) * g.c_in + (kid - tap_b * g.c_in)]
                    : 0.f;
      } else {
        rb[i] = (b_ok && kid < kdim) ? g.w[(long)kid * ldb + b_col] : 0.f;
      }
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
    if (m < rows) epilogue_row<4>(g, m, n0 + tx * 4, acc[i]);
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
__global__ void col_sum_kernel(const float* x, int ld, int n, const float* mask, int T,
                               float* out, int ldo) {
  __shared__ float part[8][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  const int s = blockIdx.y;
  float v = 0.f;
  if (j < n) {
    for (int r = threadIdx.y; r < T; r += 8) {
      const long row = (long)s * T + r;
      float e = x[row * ld + j];
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

// One block per 8 columns and 128 row groups (a warp: 8 neighbouring
// columns of 4 rows), so that a 192-wide sum still spreads over 24 SMs;
// eight rows in flight a thread in independent sums; everything combined
// in a fixed order.
constexpr int kSumCols = 8, kSumGroups = 128;

__global__ void __launch_bounds__(kSumCols * kSumGroups)
    column_sums_kernel(const float* x, int ld, int n, const float* mul, int rows, float* out,
                       float* out2) {
  __shared__ float part[2][kSumGroups][kSumCols + 1];
  const int j = blockIdx.x * kSumCols + threadIdx.x;
  float a8[8] = {}, b8[8] = {};
  if (j < n)
    for (int r0 = 8 * threadIdx.y; r0 < rows; r0 += 8 * kSumGroups) {
      float v[8], m[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = r0 + i < rows;
        const long at = (long)(r0 + i) * ld + j;
        v[i] = ok ? x[at] : 0.f;
        m[i] = ok && mul ? mul[at] : 1.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a8[i] = fmaf(v[i], m[i], a8[i]);
        b8[i] += v[i];
      }
    }
  part[0][threadIdx.y][threadIdx.x] = ((a8[0] + a8[1]) + (a8[2] + a8[3])) +
                                      ((a8[4] + a8[5]) + (a8[6] + a8[7]));
  part[1][threadIdx.y][threadIdx.x] = ((b8[0] + b8[1]) + (b8[2] + b8[3])) +
                                      ((b8[4] + b8[5]) + (b8[6] + b8[7]));
  __syncthreads();
  if (threadIdx.y < 2 && j < n && (threadIdx.y == 0 || out2)) {
    float total = 0.f;
#pragma unroll 8
    for (int y = 0; y < kSumGroups; ++y) total += part[threadIdx.y][y][threadIdx.x];
    (threadIdx.y == 0 ? out : out2)[j] = total;
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
    y = site_drop(a.drop, b, tr, a.n, c, y);
    if (a.out) a.out[base + c] = y;
    if (a.out_masked) a.out_masked[base + c] = y * a.out_mask[row];
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

ProductCounts& product_counts() {
  static ProductCounts counts;
  return counts;
}

long long& product_splits() {
  static long long count = 0;
  return count;
}

cudaError_t conv_gemm(const ConvGemm& g, cudaStream_t stream) {
  const int rows = g.batch * g.t;
  if (rows <= 0 || g.n <= 0) return cudaSuccess;
  int dev = 0, sms = 0;  // SM count of the caller's current device
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (g.tc_scratch != nullptr || g.w_split != nullptr) {  // the chain asks
    if (conv_gemm_tc_fits(g, sms)) {
      ++product_counts().tc_gemm;
      return conv_gemm_tc(g, sms, stream);
    }
    ++product_counts().declined_gemm;
  }
  ++product_counts().core_gemm;
  const int n_tiles = (g.n + kBN - 1) / kBN;
  const bool tall = ((rows + 63) / 64) * n_tiles >= sms;
  const dim3 grid(n_tiles, tall ? (rows + 63) / 64 : (rows + 31) / 32);
  if (tall) {
    if (g.w_t) conv_gemm_kernel<64, true><<<grid, 256, 0, stream>>>(g);
    else conv_gemm_kernel<64, false><<<grid, 256, 0, stream>>>(g);
  } else {
    if (g.w_t) conv_gemm_kernel<32, true><<<grid, 128, 0, stream>>>(g);
    else conv_gemm_kernel<32, false><<<grid, 128, 0, stream>>>(g);
  }
  return cudaGetLastError();
}

cudaError_t col_sum(const float* x, int ld, int n, const float* mask, int n_seg,
                    int T, float* out, int ldo, cudaStream_t stream) {
  if (n <= 0 || n_seg <= 0) return cudaSuccess;
  col_sum_kernel<<<dim3((n + 31) / 32, n_seg), dim3(32, 8), 0, stream>>>(
      x, ld, n, mask, T, out, ldo);
  return cudaGetLastError();
}

cudaError_t column_sums(const float* x, int ld, int n, const float* mul, int rows, float* out,
                        float* out2, cudaStream_t stream) {
  if (n <= 0 || rows <= 0) return cudaSuccess;
  column_sums_kernel<<<(n + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumGroups), 0, stream>>>(
      x, ld, n, mul, rows, out, out2);
  return cudaGetLastError();
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
  if (w.tc) {
    if (wgrad_tc_fits(w)) {
      ++product_counts().tc_wgrad;
      return wgrad_tc(w, sms, stream);
    }
    ++product_counts().declined_wgrad;
  }
  ++product_counts().core_wgrad;
  if (w.bias_out) {  // the bias gradient: one column-sum launch
    if (w.a_mask) return cudaErrorInvalidValue;
    if ((err = col_sum(w.dy, w.ldy, w.n, w.dy_mask, 1, rows, w.bias_out, w.n, stream)) !=
        cudaSuccess)
      return err;
  }
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

void wn_layer_products(const WnLayers& a, int l, int dilation, ConvGemm* in, ConvGemm* rs) {
  const int h = a.h;
  const long rh = (long)a.batch * a.t * h;
  const bool save = a.th != nullptr;
  float* x_l = save ? a.x + l * rh : a.x;
  const bool last = l == a.n_layers - 1;
  {  // acts = tanh(u + g_u) * sigmoid(v + g_v), [u | v] = drop(conv(x_l) + b_in)
    ConvGemm& g = *in = ConvGemm();
    g.a = x_l; g.lda = h; g.c_in = h; g.taps = a.taps; g.dilation = dilation;
    g.batch = a.batch; g.t = a.t;
    g.w = a.w_in + (long)l * a.taps * h * 2 * h; g.bias = a.b_in + l * 2 * h;
    g.n = 2 * h; g.split = h; g.epilogue = kGate; g.out = a.acts; g.ldo = h;
    if (save) {
      g.out2 = a.th + l * rh; g.ldo2 = h;
      g.out3 = a.sg + l * rh; g.ldo3 = h;
    }
    if (a.g_all) {
      g.aux = a.g_all + l * 2 * h;
      g.ld_aux = a.g_stride;
    }
    g.drop = a.drop.at(l);
    g.tc_scratch = a.tc_scratch; g.tc_scratch_floats = a.tc_scratch_floats;
    if (a.w_in_split) g.w_split = a.w_in_split + (long)l * 2 * a.taps * h * 2 * h;
    g.part = a.part; g.small_batch = a.small_batch;
  }
  {  // x_next = (x_l + rs[:, :h]) * mask; skip += rs[:, h:]
    ConvGemm& g = *rs = ConvGemm();
    g.a = a.acts; g.lda = h; g.c_in = h; g.batch = a.batch; g.t = a.t;
    g.w = a.w_rs + (long)l * h * 2 * h; g.bias = a.b_rs + l * 2 * h;
    g.n = 2 * h; g.split = h; g.epilogue = kResSkip;
    g.out = save && !last ? x_l + rh : x_l; g.ldo = h; g.mask = a.mask;
    g.aux = x_l; g.ld_aux = h; g.out2 = a.skip; g.ldo2 = h;
    g.flag = !last;  // the last layer's residual half is zero
    g.skip_mask = last && a.skip_mask;
    g.skip_init = l == 0;
    g.tc_scratch = a.tc_scratch; g.tc_scratch_floats = a.tc_scratch_floats;
    if (a.w_rs_split) g.w_split = a.w_rs_split + (long)l * 2 * h * 2 * h;
    g.part = a.part; g.small_batch = a.small_batch;
  }
}

cudaError_t wn_layers(const WnLayers& a, cudaStream_t stream) {
  int dilation = 1;
  for (int l = 0; l < a.n_layers; ++l) {
    ConvGemm in, rs;
    wn_layer_products(a, l, dilation, &in, &rs);
    cudaError_t err = conv_gemm(in, stream);
    if (err == cudaSuccess) err = conv_gemm(rs, stream);
    if (err != cudaSuccess) return err;
    dilation *= a.dilation_rate;
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
