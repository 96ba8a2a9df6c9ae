// Monotonic alignment search, the counterpart of
// glow_tts_train_tpu/ops/mas_pallas.py::_kernel (whole DP in VMEM) and its
// streaming pair ::_fwd_stream_kernel / ::_bwd_stream_kernel (y-blocks
// through VMEM for shapes that do not fit).  On the card one kernel takes
// every shape: one thread block per sample.
//
// Semantics of ops/mas.py's column scan (:193): value = logp * mask; per
// column y, v[x] = max(v[x], v[x - 1]) + value[x, y] for x <= y, -1e9
// above the diagonal and as v[-1]; stay = v[x] >= v[x - 1] (ties stay),
// forced to stay outside the mask; backtrace from (t_x_len - 1,
// t_y_len - 1) with explicit moves: never at row 0, always where row ==
// column.  The mask is rectangular per sample, so only the t_x_len x
// t_y_len rectangle is computed and read (the lengths come from the mask's
// first column and first row; inside, value = logp): no cell the backtrace
// reads depends on anything outside it.  The add is __fadd_rn (no FMA
// contraction), so the path equals the numpy oracle bit for bit.
//
// Bound: the serial column recurrence, t_y steps whose every step depends
// on the last; the bytes (logp read once, the path written once) are a
// few microseconds of the card's bandwidth.  One warp's issue rate and the
// recurrence's latency set the time, so:
//  * A scan warp holds the value column in registers: lane l owns the R
//    consecutive text rows l * R .. l * R + R - 1 of its band (R <=
//    kMaxRows), so a column costs one __shfl_up_sync (the lane's first row
//    takes the previous lane's last) and per cell a compare, a select, an
//    add and a ballot, with no block barrier.  A full tile of columns is
//    straight-line code, so one column's tail overlaps the next one's head
//    (a branch between columns keeps the compiler from overlapping them).  Up to
//    32 * kMaxRows = 512 rows one warp scans; wider texts take W scan
//    warps, a band of 32 R rows each, that pass their last row's value on
//    through shared memory with one named barrier a column.
//  * kProducers more warps stage logp ahead into shared memory by
//    cp.async: tiles of [rows, kTileCols] in a ring of 2-4 stages, 16-byte
//    copies along t_y (4-byte ones where t_y is not a multiple of 4), one
//    block barrier a tile.  The scan warps issue no copy (issuing them
//    cost the scan warp about as much as the scan).  The mask is not read
//    per cell.
//  * The stay bits of a column are the scan warps' ballots, one word per
//    (band, row of a lane) whose bit l is lane l's row (t_x * t_y / 8 bytes
//    in all): in shared memory where they fit beside the ring (192 x 1408:
//    33.8 KB; 400 x 2600: 135 KB), else in the caller's device memory.
//    Lane (y & 31) keeps column y's words, and every lane stores its own
//    every 32 columns (a store a column from one lane diverged the warp).
//  * The backtrace is warp 0's: its lanes take 32 columns at once, one
//    ballot a row gives the row's moves in them (a clear stay bit, or the
//    forced one at row == column), and the rows' moves follow one another
//    on those ballots alone; it records each row's run of columns.
//  * A second kernel writes the [t_x, t_y] path from the rows' runs, zeros
//    included (no separate fill of the output), a warp a row over the whole
//    card in 16-byte stores: one block a sample is bound by its SM's store
//    rate.
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr float kMaxNeg = -1e9f;
constexpr int kMaxRows = 16;    // text rows a scan lane holds (registers)
constexpr int kProducers = 3;   // staging warps a block
constexpr int kMaxWarps = 8;    // scan and staging warps a block
constexpr int kTileCols = 16;   // logp columns a stage
constexpr int kPitch = 20;      // floats a staged row: 5 units of 16 bytes, so a
                                // lane's 16-byte reads of odd R rows miss no bank
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLookahead = 4;  // rows a backtrace round resolves

struct MasArgs {
  const float* logp = nullptr;  // [batch, t_x, t_y]
  const float* mask = nullptr;
  float* path = nullptr;
  // the stay bits [batch, t_y, scan warps * R] in device memory, or null:
  // in shared memory after the ring
  unsigned* bits = nullptr;
  int* runs = nullptr;  // [batch, 2, t_x]: each row's first and last column of the path
  int t_x = 0, t_y = 0;
  int scan_warps = 1;
  int stages = 2;
  long ring_floats = 0;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

// wait until at most `pending` groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

// the scan warps' barrier (named barrier 1; the staging warps never join it)
__device__ __forceinline__ void scan_barrier(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Columns c0 .. c0 + cols - 1 of one staged tile for one scan lane: v holds
// its R rows' values, row0 the first of them.  The stay words of a column
// are the same in every lane: lane (y & 31) keeps column y's in `kept`
// (stored every 32 columns, flush_kept).  kDiag: a row of the block may lie
// above the diagonal in this tile (x > y), where v is -1e9.  kBands: the
// scan warps take bands of rows and pass their last row on.  kFullTile:
// cols == kTileCols, straight-line code (no branch between columns, so the
// compiler overlaps one column's tail with the next one's head).
template <int R, bool kDiag, bool kBands, bool kFullTile>
__device__ __forceinline__ void scan_tile(float (&v)[R], unsigned (&kept)[R], const float* tile,
                                          int c0, int cols, int row0, int lane, int warp,
                                          int scan_warps, float (*bnd)[kMaxWarps]) {
  const int lane_in_group = lane - (c0 & 31);  // the column (in its 32) this lane keeps
#pragma unroll
  for (int c4 = 0; c4 < kTileCols; c4 += 4) {
    if (!kFullTile && c4 >= cols) break;
    float4 val[R];
#pragma unroll
    for (int j = 0; j < R; ++j)
      val[j] = *reinterpret_cast<const float4*>(tile + (row0 + j) * kPitch + c4);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!kFullTile && c4 + k >= cols) break;
      const int y = c0 + c4 + k;
      // v[x - 1] of the lane's first row: the previous lane's last row, or
      // for lane 0 the previous band's (-1e9 for the first band)
      float left = kMaxNeg;
      if (kBands && warp > 0) left = bnd[y & 1][warp - 1];
      float up = __shfl_up_sync(kFull, v[R - 1], 1);
      up = lane == 0 ? left : up;
      unsigned stay_words[R];
#pragma unroll
      for (int j = R - 1; j >= 0; --j) {  // downwards: v[j - 1] is still the old value
        const float vp = v[j];
        const float v0 = j > 0 ? v[j > 0 ? j - 1 : 0] : up;
        const bool stay = vp >= v0;
        const float value = k == 0 ? val[j].x : k == 1 ? val[j].y : k == 2 ? val[j].z : val[j].w;
        float nv = __fadd_rn(stay ? vp : v0, value);
        if (kDiag && row0 + j > y) nv = kMaxNeg;
        v[j] = nv;
        stay_words[j] = __ballot_sync(kFull, stay);
      }
      const bool mine = lane_in_group == c4 + k;
#pragma unroll
      for (int j = 0; j < R; ++j) kept[j] = mine ? stay_words[j] : kept[j];
      if (kBands) {  // the band's last row, for the next band's first
        if (lane == 31) bnd[(y + 1) & 1][warp] = v[R - 1];
        scan_barrier(32 * scan_warps);
      }
    }
  }
}

// Store the kept stay words of the columns of end - 1's 32 up to end.
template <int R>
__device__ __forceinline__ void flush_kept(const unsigned (&kept)[R], int end, int lane, int warp,
                                           int words, unsigned* bits) {
  const int col = ((end - 1) & ~31) + lane;
  if (col < end) {
    unsigned* w = bits + (long)col * words + warp * R;
#pragma unroll
    for (int j = 0; j < R; ++j) w[j] = kept[j];
  }
}

template <int R, bool kBands>
__global__ void __launch_bounds__(kMaxWarps * 32) mas_kernel(const MasArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float bnd[2][kMaxWarps];
  __shared__ int s_len[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, scan_warps = a.scan_warps;
  const int t_x = a.t_x, t_y = a.t_y;
  const long base = (long)blockIdx.x * t_x * t_y;
  const float* lp = a.logp + base;
  const int words = scan_warps * R;
  float* ring = smem;
  // the stay bits: in device memory (a.bits) or in shared memory after the
  // ring; two pointers, so that the shared case takes shared loads
  unsigned* gbits = a.bits + (long)blockIdx.x * t_y * words;
  unsigned* sbits = reinterpret_cast<unsigned*>(smem + a.ring_floats);
  unsigned* bits = a.bits ? gbits : sbits;

  // lengths as JAX takes them: sum(mask[:, :, 0]), sum(mask[:, 0, :])
  if (tid < 2) s_len[tid] = 0;
  __syncthreads();
  int cx = 0, cy = 0;
  for (int x = tid; x < t_x; x += nt) cx += a.mask[base + (long)x * t_y] != 0.f;
  for (int y = tid; y < t_y; y += nt) cy += a.mask[base + y] != 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    cx += __shfl_xor_sync(kFull, cx, o);
    cy += __shfl_xor_sync(kFull, cy, o);
  }
  if (lane == 0) {
    atomicAdd(&s_len[0], cx);
    atomicAdd(&s_len[1], cy);
  }
  if (tid < kMaxWarps) bnd[0][tid] = 0.f;  // v before column 0
  __syncthreads();
  const int tx = s_len[0];
  const int ty = tx > 0 ? s_len[1] : 0;

  // ---- the column scan (scan warps) fed by the staging warps ----
  const int rows = scan_warps * 32 * R;  // rows of a stage
  const long slot = (long)rows * kPitch;
  const bool scans = warp < scan_warps;
  const int row0 = (warp * 32 + lane) * R;  // a scan lane's first row
  const int n_tiles = (ty + kTileCols - 1) / kTileCols;
  const bool vec = (t_y & 3) == 0 && (reinterpret_cast<unsigned long long>(lp) & 15) == 0;
  const int ptid = tid - 32 * scan_warps, pthreads = 32 * kProducers;
  auto stage = [&](int k) {  // tile k's copies: rows < tx, columns < ty
    if (scans || k >= n_tiles) return;
    float* dst0 = ring + (k % a.stages) * slot;
    const int c0 = k * kTileCols;
    constexpr int kChunks = kTileCols / 4;
    for (int q = ptid; q < tx * kChunks; q += pthreads) {
      const int row = q / kChunks, c = c0 + (q % kChunks) * 4;
      if (c >= ty) continue;
      float* dst = dst0 + (long)row * kPitch + (c - c0);
      const float* src = lp + (long)row * t_y + c;
      if (vec && c + 4 <= ty) {
        cp_async16(dst, src);
      } else {
        for (int j = 0; j < 4 && c + j < ty; ++j) cp_async4(dst + j, src + j);
      }
    }
  };
  float v[R];
  unsigned kept[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    v[j] = 0.f;
    kept[j] = 0u;
  }
  for (int k = 0; k < a.stages - 1; ++k) {
    stage(k);
    cp_async_commit();
  }
  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait(a.stages - 2);
    __syncthreads();  // tile k landed; every scan warp is done with tile k - 1's slot
    stage(k + a.stages - 1);
    cp_async_commit();
    if (scans) {
      const float* tile = ring + (k % a.stages) * slot;
      const int c0 = k * kTileCols, cols = min(kTileCols, ty - c0);
      const bool diag = c0 < rows - 1, full = cols == kTileCols;
      if (!diag && full) {
        scan_tile<R, false, kBands, true>(v, kept, tile, c0, cols, row0, lane, warp, scan_warps, bnd);
      } else if (!diag) {
        scan_tile<R, false, kBands, false>(v, kept, tile, c0, cols, row0, lane, warp, scan_warps, bnd);
      } else if (full) {
        scan_tile<R, true, kBands, true>(v, kept, tile, c0, cols, row0, lane, warp, scan_warps, bnd);
      } else {
        scan_tile<R, true, kBands, false>(v, kept, tile, c0, cols, row0, lane, warp, scan_warps, bnd);
      }
      const int end = c0 + cols;
      if ((end & 31) == 0 || end == ty) flush_kept(kept, end, lane, warp, words, bits);
    }
  }
  cp_async_wait(0);
  __syncthreads();  // every stay word is written

  // ---- backtrace (warp 0): each row's run of columns [first, last], in the
  // ring (free now), then copied out ----
  int* first = reinterpret_cast<int*>(ring);
  int* last = first + t_x;
  for (int x = tid; x < t_x; x += nt) {
    first[x] = 1 << 30;
    last[x] = -1;
  }
  __syncthreads();
  if (warp == 0 && ty > 0) {
    // Every lane runs the walk alike and stores the same values (no
    // divergent branch).  A round takes the 32 columns y - lane and the next
    // kLookahead rows: per row one ballot of the moves (a clear stay bit, or
    // the forced one where the column equals the row) over those columns,
    // all independent, then the rows' moves one after the other on the
    // ballots alone (a mask for the columns left of the last move, the
    // highest set bit).  Row x = band * 32 R + l * R + j is bit l of stay
    // word band * R + j.
    int index = tx - 1, y = ty - 1;
    int band = index / (32 * R), l = (index - band * 32 * R) / R;
    int j = index - band * 32 * R - l * R;
    last[index] = y;
    while (index > 0) {  // row 0 never moves: it keeps every column down to 0
      const int col = y - lane;
      unsigned moves[kLookahead];  // bit k: column y - k is a move of row index - r
      {
        int b = band, ll = l, jj = j;
#pragma unroll
        for (int r = 0; r < kLookahead; ++r) {
          const int row = index - r;
          const long at = (long)col * words + b * R + jj;
          const unsigned w = col >= 0 && row > 0 ? (a.bits ? gbits[at] : sbits[at]) : kFull;
          moves[r] = __ballot_sync(kFull, col >= 0 && row > 0 &&
                                              (col == row || ((w >> ll) & 1u) == 0u));
          if (--jj < 0) {  // the row above: the previous lane's last row, or band's
            jj = R - 1;
            if (--ll < 0) {
              ll = 31;
              --b;
            }
          }
        }
      }
      int top = y;  // the current row's highest column left to look at
#pragma unroll
      for (int r = 0; r < kLookahead; ++r) {
        const unsigned m = moves[r] & (kFull << (y - top));  // columns <= top
        if (m == 0u) {  // the row's move lies left of this window
          if (y < 32) {  // none left: the row keeps every column down to 0
            first[index] = 0;
            index = -1;
          } else {
            top = y - 32;
          }
          break;
        }
        const int p = y - (__ffs(m) - 1);  // the rightmost move
        first[index] = p;
        if (p == 0) {
          index = -1;
          break;
        }
        --index;
        top = p - 1;
        last[index] = top;
        if (--j < 0) {
          j = R - 1;
          if (--l < 0) {
            l = 31;
            --band;
          }
        }
        if (index == 0 || y - top >= 32) break;  // done, or the next row needs new columns
      }
      y = top;
    }
    if (index == 0) first[0] = 0;
  }
  __syncthreads();
  int* runs = a.runs + (long)blockIdx.x * 2 * t_x;
  for (int x = tid; x < 2 * t_x; x += nt) runs[x] = first[x];
}

// The path from each row's run of columns, zeros included: a warp a row,
// the rows of all samples spread over the card (16-byte stores).
__global__ void __launch_bounds__(256) mas_path_kernel(const int* runs, float* path, int t_x,
                                                       int t_y) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int b = blockIdx.y;
  const int* first = runs + (long)b * 2 * t_x;
  const int* last = first + t_x;
  float* out = path + (long)b * t_x * t_y;
  const bool vec = (t_y & 3) == 0 && (reinterpret_cast<unsigned long long>(out) & 15) == 0;
  for (int x = blockIdx.x * warps + (threadIdx.x >> 5); x < t_x; x += gridDim.x * warps) {
    const int f = first[x], l = last[x];
    float* row = out + (long)x * t_y;
    if (vec) {
      for (int c = lane; c < t_y / 4; c += 32) {
        const int y = 4 * c;
        reinterpret_cast<float4*>(row)[c] =
            make_float4(y >= f && y <= l, y + 1 >= f && y + 1 <= l, y + 2 >= f && y + 2 <= l,
                        y + 3 >= f && y + 3 <= l);
      }
    } else {
      for (int y = lane; y < t_y; y += 32) row[y] = y >= f && y <= l;
    }
  }
}

// The launch of one sample's block: scan warps, rows a lane, stages of the
// ring and where the stay bits live, within the card's shared memory.
struct MasPlan {
  int scan_warps = 1, rows_per_lane = 1, stages = 2;
  bool bits_in_shared = true;
  long ring_floats = 0;
  size_t smem = 0;
};

bool mas_plan(int t_x, int t_y, int smem_limit, MasPlan* p) {
  p->scan_warps = (t_x + 32 * kMaxRows - 1) / (32 * kMaxRows);
  if (p->scan_warps + kProducers > kMaxWarps) return false;
  // rows a lane, rounded up to an instantiated count (6 at t_x 192)
  const int rows = std::max(1, (t_x + 32 * p->scan_warps - 1) / (32 * p->scan_warps));
  p->rows_per_lane = rows <= 6 ? rows : (rows + 1) / 2 * 2;
  const long rows_staged = 32L * p->scan_warps * p->rows_per_lane;
  const long bits = (long)t_y * p->scan_warps * p->rows_per_lane;
  for (const bool shared_bits : {true, false}) {
    for (int stages = 4; stages >= 2; --stages) {
      const long ring = stages * rows_staged * kPitch;
      const size_t smem = sizeof(float) * (ring + (shared_bits ? bits : 0));
      if (smem <= (size_t)smem_limit) {
        p->stages = stages;
        p->bits_in_shared = shared_bits;
        p->ring_floats = ring;
        p->smem = smem;
        return true;
      }
    }
  }
  return false;
}

template <int R, bool kBands>
cudaError_t launch_mas(const MasArgs& a, int batch, const MasPlan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mas_kernel<R, kBands>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  mas_kernel<R, kBands><<<batch, 32 * (p.scan_warps + kProducers), p.smem, stream>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  mas_path_kernel<<<dim3(std::min((a.t_x + 7) / 8, 64), batch), 256, 0, stream>>>(
      a.runs, a.path, a.t_x, a.t_y);
  return cudaGetLastError();
}

}  // namespace

// Words of device memory a call needs for the stay bits where shared
// memory cannot hold them: [batch, t_y, words a column] (0: they fit), on
// the current device (whose index the caller passes for its cache).
extern "C" long long gtt_mas_bits_words(int batch, int t_x, int t_y, int /*device*/) {
  int dev = 0, smem_limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return -1;
  MasPlan p;
  if (!mas_plan(t_x, t_y, smem_limit - 1024, &p)) return -1;
  return p.bits_in_shared ? 0 : (long long)batch * t_y * p.scan_warps * p.rows_per_lane;
}

// logp, mask [batch, t_x, t_y] -> path [batch, t_x, t_y] (every element
// written).  bits: gtt_mas_bits_words(batch, t_x, t_y) words of device
// memory (null where that is 0); runs: [batch, 2, t_x] ints.
extern "C" int gtt_mas(const float* logp, const float* mask, float* path, unsigned* bits,
                       int* runs, int batch, int t_x, int t_y, cudaStream_t stream) {
  if (batch <= 0 || t_x <= 0 || t_y <= 0) return (int)cudaSuccess;
  int dev = 0, smem_limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  MasPlan p;
  // room for the kernel's static shared memory (the band values, lengths)
  if (!mas_plan(t_x, t_y, smem_limit - 1024, &p)) return (int)cudaErrorInvalidValue;
  if (!p.bits_in_shared && bits == nullptr) return (int)cudaErrorInvalidValue;
  MasArgs a;
  a.logp = logp; a.mask = mask; a.path = path; a.bits = p.bits_in_shared ? nullptr : bits;
  a.runs = runs;
  a.t_x = t_x; a.t_y = t_y; a.scan_warps = p.scan_warps; a.stages = p.stages;
  a.ring_floats = p.ring_floats;
  // one scan warp: no band logic; bands of warps (t_x > 512) have at least
  // 10 rows a lane
  if (p.scan_warps == 1) switch (p.rows_per_lane) {
    case 1: return (int)launch_mas<1, false>(a, batch, p, stream);
    case 2: return (int)launch_mas<2, false>(a, batch, p, stream);
    case 3: return (int)launch_mas<3, false>(a, batch, p, stream);
    case 4: return (int)launch_mas<4, false>(a, batch, p, stream);
    case 5: return (int)launch_mas<5, false>(a, batch, p, stream);
    case 6: return (int)launch_mas<6, false>(a, batch, p, stream);
    case 8: return (int)launch_mas<8, false>(a, batch, p, stream);
    case 10: return (int)launch_mas<10, false>(a, batch, p, stream);
    case 12: return (int)launch_mas<12, false>(a, batch, p, stream);
    case 14: return (int)launch_mas<14, false>(a, batch, p, stream);
    case 16: return (int)launch_mas<16, false>(a, batch, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
  switch (p.rows_per_lane) {
    case 10: return (int)launch_mas<10, true>(a, batch, p, stream);
    case 12: return (int)launch_mas<12, true>(a, batch, p, stream);
    case 14: return (int)launch_mas<14, true>(a, batch, p, stream);
    case 16: return (int)launch_mas<16, true>(a, batch, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
