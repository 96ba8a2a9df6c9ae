// conv_gemm and layer_norm (see common.cuh).
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
  return epilogue == kGate || epilogue == kCouplingInv;
}

// Logical output column -> column of B / bias.
__device__ __forceinline__ int physical_col(const ConvGemm& g, int n) {
  return paired(g.epilogue) ? (n >> 1) + (n & 1) * g.split : n;
}

__device__ __forceinline__ void epilogue_row(const ConvGemm& g, int m, int n0,
                             const float (&acc)[4]) {
  const float rm = g.mask ? g.mask[m] : 1.f;
  float* out = g.out + (long)m * g.ldo;
  switch (g.epilogue) {
    case kGate:
    case kCouplingInv: {
      // acc[2p], acc[2p + 1] are the pair (j, j + split), j = (n0 + 2p) / 2
      for (int p = 0; p < 2; ++p) {
        const int n = n0 + 2 * p;
        if (n >= g.n) break;
        const int j = n >> 1;
        const float lo = acc[2 * p] + g.bias[j];
        const float hi = acc[2 * p + 1] + g.bias[j + g.split];
        if (g.epilogue == kGate) {
          float gu = 0.f, gv = 0.f;
          if (g.aux) {
            const float* gb = g.aux + (long)(m / g.t) * g.ld_aux;
            gu = gb[j];
            gv = gb[j + g.split];
          }
          out[j] = tanhf(lo + gu) * sigmoidf(hi + gv);
        } else {
          const float logs =
              g.flag ? logf(1e-6f + sigmoidf(hi + 2.f)) : hi;
          out[j] = (out[j] - lo) * expf(-logs) * rm;
        }
      }
      break;
    }
    case kResSkip: {
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        const float v = acc[e] + g.bias[n];
        if (n < g.split) {
          if (g.flag) out[n] = (out[n] + v) * rm;
        } else {
          g.out2[(long)m * g.ldo2 + n - g.split] += v;
        }
      }
      break;
    }
    default: {
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + e;
        if (n >= g.n) break;
        float v = acc[e] + g.bias[n];
        if (g.epilogue == kBiasRelu) v = fmaxf(v, 0.f);
        if (g.epilogue == kResidMask) v = (g.aux[(long)m * g.ld_aux + n] + v) * rm;
        if (g.epilogue == kBiasMask) v *= rm;
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

  float ra[kALoads];
  float rb[kBLoads];
  auto load = [&](int k0) {
    const int kidx = k0 + a_kk;
    const bool k_ok = kidx < kdim;
    const int tap = k_ok ? kidx / g.c_in : 0;
    const int c = kidx - tap * g.c_in;
    const int off = (tap - half_taps) * g.dilation;
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
      rb[i] = (b_ok && kid < kdim) ? g.w[(long)kid * g.n + b_col] : 0.f;
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
  for (int c = lane; c < a.n; c += 32) {
    float y = (load(c) - mean) * rstd * a.gamma[c] + a.beta[c];
    if (a.relu_after) y = fmaxf(y, 0.f);
    a.out[base + c] = y;
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

cudaError_t layer_norm(const LayerNorm& a, cudaStream_t stream) {
  if (a.rows <= 0) return cudaSuccess;
  const int rows_per_block = 8;
  const int blocks = (a.rows + rows_per_block - 1) / rows_per_block;
  layer_norm_kernel<<<blocks, rows_per_block * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace gtt
