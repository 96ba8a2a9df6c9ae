// Monotonic Alignment Search — native CPU kernel.
//
// The reference ships this as a Cython extension with OpenMP-style prange
// over the batch (reference: glow_tts_train/monotonic_align/core.pyx:9-45).
// This is a fresh C++ implementation of the same DP semantics, used for
// CPU-parity testing and as a host-side fallback; the TPU path
// (glow_tts_train_tpu/ops/mas.py) never calls the host.
//
// Semantics (per sample, value is logp*mask, updated in place):
//   forward, banded:  Q[x,y] = logp[x,y] + max(Q[x,y-1] if x<y else -inf,
//                                              Q[x-1,y-1] if x>0 else (0 at
//                                              y==0, else -inf))
//   backtrace: start at x=t_x-1; move down iff x==y or Q[x,y-1] < Q[x-1,y-1]
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC mas.cpp -o libmas.so

#include <algorithm>
#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

void maximum_path_each(int32_t* path, float* value, int t_x, int t_y,
                       int t_y_stride, float max_neg_val) {
  for (int y = 0; y < t_y; ++y) {
    const int x_lo = std::max(0, t_x + y - t_y);
    const int x_hi = std::min(t_x, y + 1);
    for (int x = x_lo; x < x_hi; ++x) {
      float v_cur = (x == y) ? max_neg_val : value[x * t_y_stride + (y - 1)];
      float v_prev;
      if (x == 0) {
        v_prev = (y == 0) ? 0.0f : max_neg_val;
      } else {
        v_prev = value[(x - 1) * t_y_stride + (y - 1)];
      }
      value[x * t_y_stride + y] += std::max(v_cur, v_prev);
    }
  }

  int index = t_x - 1;
  for (int y = t_y - 1; y >= 0; --y) {
    path[index * t_y_stride + y] = 1;
    if (index != 0 &&
        (index == y || value[index * t_y_stride + (y - 1)] <
                           value[(index - 1) * t_y_stride + (y - 1)])) {
      --index;
    }
  }
}

}  // namespace

extern "C" {

// paths:  [b, t_x_max, t_y_max] int32, zero-initialized by the caller
// values: [b, t_x_max, t_y_max] float32 (logp * mask), clobbered
// t_xs, t_ys: [b] per-sample lengths
void maximum_path_batch(int32_t* paths, float* values, const int32_t* t_xs,
                        const int32_t* t_ys, int b, int t_x_max, int t_y_max,
                        float max_neg_val) {
  const long plane = static_cast<long>(t_x_max) * t_y_max;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < b; ++i) {
    maximum_path_each(paths + i * plane, values + i * plane, t_xs[i], t_ys[i],
                      t_y_max, max_neg_val);
  }
}

}  // extern "C"
