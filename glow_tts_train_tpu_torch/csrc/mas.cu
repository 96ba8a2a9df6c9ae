// Monotonic alignment search, the counterpart of
// glow_tts_train_tpu/ops/mas_pallas.py::_kernel (whole DP in VMEM) and its
// streaming pair ::_fwd_stream_kernel / ::_bwd_stream_kernel (y-blocks
// through VMEM for shapes that do not fit).  On the card one kernel takes
// every shape: one thread block per sample, the text axis over the threads
// (each thread loops over x = tid + k * blockDim.x), the value column
// double-buffered in shared memory (2 * t_x floats), the direction bits in
// device memory [b, t_y, t_x] as uint8, and one thread backtracing.
//
// Semantics of ops/mas.py's column scan (:193): value = logp * mask; per
// column y, v[x] = max(v[x], v[x - 1]) + value[x, y] for x <= y, -1e9
// above the diagonal and as v[-1]; stay = v[x] >= v[x - 1] (ties stay),
// forced to stay outside the mask; backtrace from (t_x_len - 1,
// t_y_len - 1) with explicit moves: never at row 0, always where row ==
// column.  Only the t_x_len x t_y_len rectangle is computed: no cell the
// backtrace reads depends on anything outside it.  The add is __fadd_rn
// and the product __fmul_rn (no FMA contraction), so the path equals the
// numpy oracle bit for bit.
//
// Bound: the serial column recurrence (one block barrier per mel frame);
// the batch's samples run as independent blocks.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr float kMaxNeg = -1e9f;

__global__ void mas_kernel(const float* logp, const float* mask, float* path,
                           unsigned char* dir, int t_x, int t_y) {
  extern __shared__ float v[];  // [2][t_x]
  __shared__ int s_tx, s_ty;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long base = (long)b * t_x * t_y;
  const float* lp = logp + base;
  const float* mk = mask + base;
  unsigned char* dr = dir + base;
  if (tid == 0) {
    s_tx = 0;
    s_ty = 0;
  }
  __syncthreads();
  // lengths as JAX takes them: sum(mask[:, :, 0]), sum(mask[:, 0, :])
  int cx = 0, cy = 0;
  for (int x = tid; x < t_x; x += nt) cx += mk[(long)x * t_y] != 0.f;
  for (int y = tid; y < t_y; y += nt) cy += mk[y] != 0.f;
  atomicAdd(&s_tx, cx);
  atomicAdd(&s_ty, cy);
  for (int x = tid; x < t_x; x += nt) v[x] = 0.f;
  __syncthreads();
  const int tx = s_tx;
  const int ty = s_ty;

  int cur = 0;
  for (int y = 0; y < ty; ++y) {
    const float* vc = v + cur * t_x;
    float* vn = v + (cur ^ 1) * t_x;
    for (int x = tid; x < tx; x += nt) {
      const float vp = vc[x];
      const float v0 = x == 0 ? kMaxNeg : vc[x - 1];
      const bool stay = vp >= v0;
      const long at = (long)x * t_y + y;
      const float m = mk[at];
      const float value = __fmul_rn(lp[at], m);
      vn[x] = x <= y ? __fadd_rn(stay ? vp : v0, value) : kMaxNeg;
      dr[(long)y * t_x + x] = (m != 0.f) ? stay : 1;
    }
    __syncthreads();
    cur ^= 1;
  }

  if (tid == 0) {
    int index = tx > 0 ? tx - 1 : 0;
    for (int y = ty - 1; y >= 0; --y) {
      const long at = (long)index * t_y + y;
      path[base + at] = mk[at];
      int d = dr[(long)y * t_x + index];
      if (index == 0) {
        d = 1;
      } else if (index == y) {
        d = 0;
      }
      index = max(index + d - 1, 0);
    }
  }
}

}  // namespace

// path must hold zeros on entry (the wrapper allocates it zeroed).
extern "C" int gtt_mas(const float* logp, const float* mask, float* path,
                       unsigned char* dir, int batch, int t_x, int t_y,
                       cudaStream_t stream) {
  if (batch <= 0 || t_x <= 0 || t_y <= 0) return (int)cudaSuccess;
  const int threads = std::min(1024, ((t_x + 31) / 32) * 32);
  const size_t smem = sizeof(float) * 2 * (size_t)t_x;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mas_kernel<<<batch, threads, smem, stream>>>(logp, mask, path, dir, t_x, t_y);
  return (int)cudaGetLastError();
}
