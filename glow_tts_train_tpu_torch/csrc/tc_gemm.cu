// The products on the H100's tensor cores, f32-accurate by the 3xTF32
// split: the tensor-core conv-GEMM behind gtt::conv_gemm and the
// tensor-core weight-gradient GEMM behind gtt::wgrad (common.cuh).  The
// launch chains of block_train.cu and block.cu ask for them (every TPU
// kernel of block_pallas.py and wn_pallas.py), and so do the text side's
// (encoder.cu, encoder_train.cu, text.cu, text_train.cu: encoder_pallas.py
// _fwd_kernel, _bwd_kernel, text_pallas.py's four), which also allow
// split-K, and the serving inverse's (block.cu), which allows split-K at
// any row count and a 64-row tile.
//
// Arithmetic.  A TF32 operand keeps 10 mantissa bits.  Each f32 value v is
// split into big = v rounded to 10 bits and small = the exact remainder
// v - big cut to 10 bits, and a product accumulates small_a * big_b +
// big_a * small_b + big_a * big_b, small terms first, into f32
// accumulators; what is dropped is below 2^-21 of each term.  It costs
// three tensor-core products for one: an effective peak of 495 / 3 = 165
// TFLOP/s against 67 on the CUDA cores.  Two things the hardware does
// shape the rest:
//  * The tensor cores round toward zero when they add into their f32
//    accumulator.  Over a K walk of 960 that alone costs 1e-5 of the
//    largest output, more than the split saves.  So a chain of products is
//    kept short: those of one 32-deep slice start from zero in a second
//    accumulator set (`part`), and the slices are added on the CUDA cores,
//    rounding to nearest.  A product then stays within 7e-7 of its largest
//    output against float64 (chip_smoke.py measures it), closer than the
//    CUDA-core kernel's FMA chain, where one TF32 pass is off by 1e-3.
//  * What remains is a lean: every output reads about 1e-7 low, all alike
//    (9e-8 for the conv-GEMM, 2e-7 for the weight gradient; 5e-7 when big
//    was truncated instead of rounded).  One product does not mind; a
//    gradient that is a small difference of large sums does, which is why
//    block_fwd_chain keeps one product on the CUDA cores.
//
// conv_gemm_tc_kernel: a 128 x kBN output tile per block of two
// warpgroups, each owning 64 rows, over the whole K walk or over one share
// of it (split-K, for the short, deep products of the text chains and of
// serving: [3072, 2304, 192] at t_x 192 has 72 tiles for 132 SMs, the
// in-layer conv of a lone 250-phoneme request [832, 960, 384] 21; the
// shares' raw sums go to scratch and splitk_reduce_kernel adds them in
// split order and runs the epilogue: no atomics, the same bits from run to
// run; conv_gemm_tc_plan picks the count from the waves it makes).  The
// serving chain may take a 64 x kBN tile instead, one warpgroup a block:
// twice the row tiles, the same loop (a lone sentence's 1x1 products: 7
// row tiles of 128 at 832 rows, 2 at 160).  wgmma.mma_async m64n{kBN}k8 with .tf32
// operands, A from registers, B from shared memory, kBN / 2 f32
// accumulators a thread and as many again for `part`.  kBN is 128 where
// that divides the width (N = 384: two waves of 264 blocks at [16, 704]),
// else 64.  K is walked in slices of 32 through a ring
// of 4 (kBN 128) or 3 stages in dynamic shared memory filled by 16-byte
// cp.async copies.  The loop is software-pipelined: a slice's twelve
// wgmmas are issued, and while they run the thread waits for the next
// slice's copies, passes the block's one barrier, issues the copies of a
// later slice and loads and splits the next slice's A fragments into a
// second register set; then it waits for the wgmmas and adds `part`.
//  * B.  wgmma takes TF32 operands K-major only, and reads a raw f32 as its
//    top 19 bits, so `small` has to exist in memory: split_weights_kernel
//    lays a product's [K, N] weights out [N, K] as two arrays, big and
//    small, into the caller's scratch before the GEMM (weights are at most
//    960 x 384; the pass takes 2.5 us), or a chain splits all of its
//    weights in one launch first (presplit_weights, ConvGemm::w_split).  A stage holds both as 128-byte
//    rows in the 128-byte swizzle wgmma's descriptor names (16-byte chunk
//    index XOR row mod 8, 8-row groups 1024 bytes apart), which the copies
//    apply to their destination address.  Paired epilogues (kGate,
//    kCoupling*) want columns (j, j + split) side by side: the copies read
//    row physical_col(n) of the K-major weights into tile row n, so a pair
//    is two neighbouring columns of the tile.
//  * A.  The im2col gather is done by the copies: a 16-byte chunk is 4
//    channels of one tap's source row (c_in is a multiple of 4), zero-filled
//    (cp.async src-size 0) outside [0, t), past the last row and past K.
//    Rows are padded to 36 floats, so a warp's fragment loads touch 32
//    banks.  a_mask multiplies the fragment before the split (only without
//    taps: the source row is the output row).
//  * Epilogue.  The accumulators go through shared memory, and each thread
//    takes 4 neighbouring columns of one row to epilogue_cols<4>
//    (epilogue.cuh), one thread per element, so the in-place epilogues need
//    no ordering.  Straight from the fragments (2 columns of 16 rows a
//    thread) the epilogue took a third of the kernel: its branches are a
//    long dependent chain per call, and two warps a scheduler hide none of
//    it.
// What bounds it: at [11264, 960, 384] it reaches 65-73 TFLOP/s of the 165.
// Without its wgmmas and its epilogue the loop alone takes 78 us of the
// bound's 50: its copies move 380 MB from L2 to shared memory (every block
// its own A tile and both parts of B), 4.9 TB/s, which is what L2 gives.
// Splitting B inside the kernel from one raw copy (a third less traffic)
// cost a second barrier a slice and was slower; a 192-wide tile (A read
// once for N = 192) ran at 255 registers and was no faster.  The k8
// instruction is the other limit: 12 wgmmas of 64 clocks a warpgroup and
// slice, each paying its issue.
//
// wgrad_tc_kernel: out[k, n] = sum_m A_im2col[m, k] dY[m, n].  Both
// operands are contiguous along the non-reduced dimension, so neither is
// K-major for wgmma.  The A operand does not have to be: it comes from
// registers, and a thread loads its fragment (rows = im2col columns, k =
// the slice's rows) from the raw tile as it lies.  dY is transposed on the
// way: a block of two warpgroups owns a 128 (im2col columns) x kBN (dY
// columns, 128 where that divides the width, else 64) output tile over one
// split of the rows, walked in slices of 32 rows.  The raw slices (A
// gathered by source address, zero fill as above; dY; the two row masks)
// come through a ring of 3 stages of 16-byte cp.async copies; each thread
// then takes 4 neighbouring rows of one dY column, multiplies the row
// masks in, splits, and writes one 16-byte chunk each of the big and the
// small K-major tile in wgmma's 128-byte swizzle (conflict-free both ways:
// a warp reads 32 neighbouring columns and a quarter warp writes 8
// different chunk positions).  Those tiles are double-buffered, so the
// transposition of slice s + 1 and the split of its A fragments run under
// the twelve wgmmas of slice s, with one barrier a slice.  A slice's
// products start from zero and are added to the accumulators on the CUDA
// cores, as above.  (The first version was mma.sync.m16n8k8 with both
// operands split in registers by every warp that used them: 203-209 us at
// dW_in [960, 384] over 11,264 rows, where this one takes 158.)
// Determinism: no atomics; the rows are cut into a fixed number of splits,
// as many as fill one wave of one block an SM (a second, partly filled
// wave would double the time) with at least 256 rows each; every split
// writes its partial tile to scratch and col_sum adds them in split order,
// so a gradient is the same bits from run to run.  Scratch traffic at dW_in
// [960, 384] over 11,264 rows: 5 splits, 7.4 MB written and read (8.8 MB
// with the CUDA-core kernel's 6).  It reaches 53 TFLOP/s of the 165 there,
// a slice taking about as long as one of the conv-GEMM's: the same twelve
// k8 wgmmas a warpgroup, and per slice 32 KB from L2 and about 200 KB of
// shared-memory traffic (the tensor cores read B twelve times).
//
// The WN reverse walk's modes (block_train.cu): conv_gemm_tap_kernel,
// the transposed conv with A staged once a channel slice for all taps;
// wgrad_tc_split_kernel, a weight gradient reading dY's K-major split that
// the gate backward's epilogue writes (tile_epilogue, ConvGemm::out4), as
// the conv-GEMM reads its weights (123 against 162 us at dW_in [960, 11264,
// 384]); and in both weight-gradient kernels a bias row (WGrad::bias_out),
// the output row of one more im2col column, of ones, added through
// wgrad_reduce_kernel's split-ordered pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"
#include "epilogue.cuh"
#include "mma.cuh"

namespace gtt {
namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; `bytes` 0 fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// ---------------------------------------------------------------------------
// K-major 3xTF32 split of a weight matrix
// ---------------------------------------------------------------------------

// The K-major 3xTF32 splits of up to kMaxSplits weight matrices, one 32 x
// 32 tile a block (blockIdx.y: the matrix): big, small [n, kdim] of B
// [kdim, n].  B is w [kdim, n] (row stride ldb), or with w_t the per-tap
// transpose of the forward conv's w [taps * n, c_in], B[tap * c_in + j, c]
// = w[tap * n + c, j], read along its rows.  Both go through shared memory
// so that reads and writes are coalesced.
__global__ void split_weights_kernel(const WeightSplits s) {
  __shared__ float tile[32][33];  // [k][c]
  const WeightSplit& job = s.job[blockIdx.y];
  const int tiles_k = (job.kdim + 31) / 32;
  if ((int)blockIdx.x >= tiles_k * ((job.n + 31) / 32)) return;
  const int c0 = (blockIdx.x / tiles_k) * 32, k0 = (blockIdx.x % tiles_k) * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    if (job.w_t) {  // lanes along k: contiguous within a tap
      const int k = k0 + threadIdx.x, c = c0 + r;
      float v = 0.f;
      if (k < job.kdim && c < job.n) {
        const int tap = k / job.c_in;
        v = job.w[((long)tap * job.n + c) * job.c_in + (k - tap * job.c_in)];
      }
      tile[threadIdx.x][r] = v;
    } else {  // lanes along c
      const int k = k0 + r, c = c0 + threadIdx.x;
      tile[r][threadIdx.x] = (k < job.kdim && c < job.n) ? job.w[(long)k * job.ldb + c] : 0.f;
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r, k = k0 + threadIdx.x;
    if (c < job.n && k < job.kdim) {
      uint32_t b, sm;
      split_tf32(tile[threadIdx.x][r], b, sm);
      job.big[(long)c * job.kdim + k] = __uint_as_float(b);
      job.small[(long)c * job.kdim + k] = __uint_as_float(sm);
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core conv-GEMM
// ---------------------------------------------------------------------------

constexpr int kTK = 32;       // K slice: one 128-byte swizzled row of B
constexpr int kAStride = 36;  // floats a row of the A tile

// d = a @ b + (scale_d ? d : 0): A [64, 8] from registers, B [kBN, 8]
// K-major from shared memory
template <int kBN>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};


__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Shared-memory descriptor of a K-major B tile in the 128-byte swizzle:
// start address, leading offset 1 (unused by this layout), 1024 bytes
// between 8-row groups, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// The block's kTM x kBN output tile from the accumulators (the fragment
// layout of conv_gemm_tc_kernel's wgmmas) through shared memory at
// smem_base, so that a warp writes 32 neighbouring columns of one row (a
// fragment holds 2 columns of 16 rows: stored as it lies, a row's 32-byte
// sectors would each take four partial writes).  Split-K: the raw sums go to
// this split's partial tile instead.
//
// kGateBwd with out4 (the WN reverse walk): each element's two d_xin values
// (the u and the v half, dropped) also go to a second staging tile [2 kBN]
// [kTM] (d_xin columns by rows, 4-row chunks XOR-swizzled by column / 4: the
// row pass's stores meet two-way bank conflicts at most, the column pass's
// 16-byte loads none), and a second pass writes them out K-major, split in
// big and small, a warp 128 neighbouring rows of one column: dW_in's B
// operand, read as the conv-GEMM reads its weights.  The staging needs
// (kTM (kBN + 8) + 2 kBN kTM) floats: within every instantiation's shared
// memory (conv_gemm_tc_can).
template <int kBN, int kTM>
__device__ __forceinline__ void tile_epilogue(const ConvGemm& g, const float (&acc)[kBN / 2],
                                              unsigned char* smem_raw, uint32_t smem_base,
                                              float* __restrict__ part_out, int m0, int n0,
                                              int frag_row, int frag_col) {
  constexpr int kThreads = 2 * kTM;
  constexpr int kCStride = kBN + 8;  // floats a row: conflict-free 8-byte stores
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int rows = g.batch * g.t;
  float* c_tile = reinterpret_cast<float*>(smem_raw + (smem_base - smem_addr(smem_raw)));
  // Accumulator fragment: acc[4 j + {0, 1}] are columns 8 j + 2 t + {0, 1}
  // of row frag_row, acc[4 j + {2, 3}] the same columns of row frag_row + 8.
  __syncthreads();  // the last slice's fragment loads are done
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    float* at = c_tile + frag_row * kCStride + 8 * j + 2 * frag_col;
    *reinterpret_cast<float2*>(at) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(at + 8 * kCStride) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  const bool stash = g.epilogue == kGateBwd && g.out4 != nullptr;  // alike in the block
  float* tt = c_tile + kTM * kCStride;
  auto tt_at = [](int jj, int r) {
    return jj * kTM + ((((r >> 2) ^ ((jj >> 2) & 7)) << 2) | (r & 3));
  };
  // a lane takes 4 neighbouring columns (two pairs of a paired epilogue) of
  // one row, a warp 128 / kBN rows at a time: the epilogue's branches are a
  // long dependent chain, which 4 elements a call amortise
  constexpr int kLanesPerRow = kBN / 4;
  const int warp = tid >> 5;
  const int col = 4 * (lane % kLanesPerRow);
  for (int r = warp * (32 / kLanesPerRow) + lane / kLanesPerRow; r < kTM;
       r += (kThreads / 32) * (32 / kLanesPerRow)) {
    const int m = m0 + r;
    if (m >= rows || n0 + col >= g.n) {
      if (stash) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tt[tt_at(col + e, r)] = 0.f;
          tt[tt_at(kBN + col + e, r)] = 0.f;
        }
      }
      continue;
    }
    const float4 v = *reinterpret_cast<const float4*>(c_tile + r * kCStride + col);
    if (part_out != nullptr) {  // n is a multiple of 4 here
      *reinterpret_cast<float4*>(part_out + ((long)blockIdx.z * rows + m) * g.n + n0 + col) = v;
      continue;
    }
    const float four[4] = {v.x, v.y, v.z, v.w};
    if (stash) {
      const EpilogueRow er = epilogue_row_of(g, m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float du = 0.f, dv = 0.f;
        if (n0 + col + e < g.n) gate_bwd(g, er, n0 + col + e, four[e], du, dv);
        tt[tt_at(col + e, r)] = du;
        tt[tt_at(kBN + col + e, r)] = dv;
      }
    } else {
      epilogue_cols<4>(g, epilogue_row_of(g, m), n0 + col, four);
    }
  }
  if (!stash) return;
  __syncthreads();
  constexpr int kChunks = kTM / 4;  // 16-byte chunks a staged column
  const long small_off = 2L * g.split * g.ldo4;  // d_xin has 2 * split columns
  for (int q = tid; q < 2 * kBN * kChunks; q += kThreads) {
    const int jj = q / kChunks, c4 = q - jj * kChunks;
    const int cl = jj < kBN ? jj : jj - kBN;  // the column within the tile
    const int m = m0 + 4 * c4;
    if (n0 + cl >= g.n || m >= g.ldo4) continue;
    const float4 v =
        *reinterpret_cast<const float4*>(tt + jj * kTM + ((c4 ^ ((jj >> 2) & 7)) << 2));
    uint32_t big[4], small[4];
    split_tf32(v.x, big[0], small[0]);
    split_tf32(v.y, big[1], small[1]);
    split_tf32(v.z, big[2], small[2]);
    split_tf32(v.w, big[3], small[3]);
    float* dst = g.out4 + (long)((jj < kBN ? 0 : g.split) + n0 + cl) * g.ldo4 + m;
    *reinterpret_cast<uint4*>(dst) = make_uint4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<uint4*>(dst + small_off) = make_uint4(small[0], small[1], small[2], small[3]);
  }
}

// Stages of the ring: 4 at 128 columns, 3 at 64 (either way one block an
// SM: 244 and 186 registers a thread).
template <int kBN>
__host__ __device__ constexpr int conv_gemm_tc_stages() {
  return kBN == 128 ? 4 : 3;
}

template <int kBN, int kTM>
constexpr int conv_gemm_tc_smem() {
  return conv_gemm_tc_stages<kBN>() * (2 * kBN * 128 + kTM * kAStride * 4) + 1024;
}

// A kTM x kBN output tile per block of kTM / 64 warpgroups (kTM 128, or 64
// for the serving chain's short products: twice the row tiles).
// `part_out` null: the epilogue; else the block's raw sums go to
// part_out[blockIdx.z] ([rows, n]) and the block walks only its share of
// the K slices (split-K, added by splitk_reduce_kernel).
template <int kBN, int kTM>
__global__ void __launch_bounds__(2 * kTM, 1)
    conv_gemm_tc_kernel(const ConvGemm g, const float* __restrict__ w_big,
                        float* __restrict__ part_out, int slices_per_split) {
  constexpr int kThreads = 2 * kTM;
  constexpr int kRowStep = kThreads / 8;  // tile rows one pass of 16-byte copies covers
  constexpr int kATileBytes = kTM * kAStride * 4;
  constexpr int kStages = conv_gemm_tc_stages<kBN>();
  constexpr int kBTileBytes = kBN * 128;
  constexpr int kACopies = kTM / kRowStep;  // 16-byte copies a thread, A
  constexpr int kBRows = kBN / kRowStep;    // B tile rows a thread copies, big and small each
  extern __shared__ unsigned char smem_raw[];
  // B tiles first, 1024-byte aligned for the swizzle; then the A tiles
  const uint32_t smem_base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_base = smem_base;
  const uint32_t a_base = smem_base + kStages * 2 * kBTileBytes;
  const float* a_tiles = reinterpret_cast<const float*>(smem_raw + (a_base - smem_addr(smem_raw)));

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kBN;
  const int rows = g.batch * g.t;
  const int kdim = g.taps * g.c_in;
  const int half_taps = g.taps / 2;
  // this block's slices: [slice0, slice0 + n_slices)
  const int slice0 = blockIdx.z * slices_per_split;
  const int n_slices = min((kdim + kTK - 1) / kTK - slice0, slices_per_split);
  const long small_off = (long)kdim * g.n;  // the small part follows the big one

  // staging: this thread copies 16-byte chunk `cc` of tile rows tid / 8 +
  // kRowStep i
  const int cc = tid & 7;
  const int r0 = tid >> 3;
  int a_row0[kACopies];  // b * t of the row's sample, -1 past the last row
  int a_t[kACopies];
#pragma unroll
  for (int i = 0; i < kACopies; ++i) {
    const int m = m0 + r0 + kRowStep * i;
    const int b = m / g.t;
    a_row0[i] = m < rows ? b * g.t : -1;
    a_t[i] = m - b * g.t;
  }
  long b_row[kBRows];  // offset of the K-major row this tile row reads, -1 past n
#pragma unroll
  for (int i = 0; i < kBRows; ++i) {
    const int n = n0 + r0 + kRowStep * i;
    b_row[i] = n < g.n ? (long)physical_col(g, n) * kdim : -1;
  }
  const uint32_t a_dst0 = a_base + (r0 * kAStride + 4 * cc) * 4;
  // rows r0 + kRowStep i share r0's swizzle phase (kRowStep is a multiple of 8)
  const uint32_t b_dst0 = b_base + r0 * 128 + ((cc ^ (r0 & 7)) << 4);

  auto load_slice = [&](int slice, int stage) {
    const int kidx = (slice0 + slice) * kTK + 4 * cc;
    const bool k_ok = kidx < kdim;
    const int tap = k_ok ? kidx / g.c_in : 0;
    const int c = kidx - tap * g.c_in;
    const int off = g.tap_sign * (tap - half_taps) * g.dilation;
    const uint32_t a_dst = a_dst0 + stage * kATileBytes;
#pragma unroll
    for (int i = 0; i < kACopies; ++i) {
      const int ts = a_t[i] + off;
      const bool ok = k_ok && a_row0[i] >= 0 && ts >= 0 && ts < g.t;
      const float* src = ok ? g.a + ((long)a_row0[i] + ts) * g.lda + c : g.a;
      cp_async16(a_dst + kRowStep * i * kAStride * 4, src, ok ? 16 : 0);
    }
    const uint32_t b_dst = b_dst0 + stage * 2 * kBTileBytes;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const bool ok = k_ok && b_row[i] >= 0;
      const float* src = ok ? w_big + b_row[i] + kidx : w_big;
      cp_async16(b_dst + i * kRowStep * 128, src, ok ? 16 : 0);
      cp_async16(b_dst + kBTileBytes + i * kRowStep * 128, ok ? src + small_off : w_big,
                 ok ? 16 : 0);
    }
  };

  // this thread's fragment rows: frag_row and frag_row + 8 of its warp's 16
  const int wg = tid >> 7;
  const int warp_in_wg = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int frag_row = wg * 64 + warp_in_wg * 16 + (lane >> 2);
  const int frag_col = lane & 3;
  const int m_lo = m0 + frag_row;
  const int m_hi = m_lo + 8;
  float mask_lo = 1.f, mask_hi = 1.f;
  if (g.a_mask) {
    mask_lo = m_lo < rows ? g.a_mask[m_lo] : 0.f;
    mask_hi = m_hi < rows ? g.a_mask[m_hi] : 0.f;
  }

  // The slice's A fragments, split: [k8 step][a0..a3], a0 (row, k), a1
  // (row + 8, k), a2 (row, k + 4), a3 (row + 8, k + 4).
  auto load_fragments = [&](int stage, uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
    const float* at = a_tiles + stage * (kATileBytes / 4) + frag_row * kAStride + frag_col;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float v0 = at[ks * 8];
      float v1 = at[ks * 8 + 8 * kAStride];
      float v2 = at[ks * 8 + 4];
      float v3 = at[ks * 8 + 8 * kAStride + 4];
      if (g.a_mask) { v0 *= mask_lo; v1 *= mask_hi; v2 *= mask_lo; v3 *= mask_hi; }
      split_tf32(v0, big[ks][0], small[ks][0]);
      split_tf32(v1, big[ks][1], small[ks][1]);
      split_tf32(v2, big[ks][2], small[ks][2]);
      split_tf32(v3, big[ks][3], small[ks][3]);
    }
  };

  // The tensor cores add into their f32 accumulator rounding toward zero,
  // which over a long K walk costs more than the split saves (measured: 1e-5
  // of max |out| at K = 960).  So each slice's twelve products start from
  // zero in `part`, and `acc` adds the slices on the CUDA cores, rounding
  // to nearest.
  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  // One slice: its twelve wgmmas run while this thread waits for the next
  // slice's copies, issues the copies of the one after and splits the next
  // slice's A fragments into the other register set.
  auto step = [&](int slice, uint32_t (&big)[4][4], uint32_t (&small)[4][4],
                  uint32_t (&next_big)[4][4], uint32_t (&next_small)[4][4]) {
    const int stage = slice % kStages;
    const uint64_t d_big = b_descriptor(b_base + (stage * 2) * kBTileBytes);
    const uint64_t d_small = b_descriptor(b_base + (stage * 2 + 1) * kBTileBytes);
    wgmma_fence();
    // The slice's eight small products first, then its four big ones: each
    // addition into the accumulator rounds toward zero by up to an ulp of
    // what it holds, and it holds little until the big products come.  (A
    // k8 step is 32 bytes along the swizzled row: 2 in the address field.)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<kBN>::run(part, small[ks], d_big + 2 * ks, ks > 0);
      Wgmma<kBN>::run(part, big[ks], d_small + 2 * ks, 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<kBN>::run(part, big[ks], d_big + 2 * ks, 1);
    wgmma_commit();
    cp_async_wait<kStages - 3>();  // this thread's copies of slice + 1 have landed
    // make them visible to the tensor cores' reads of shared memory
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // everyone's have landed, and everyone has waited for the wgmmas of
    // slice - 1, whose stage the copies below overwrite
    __syncthreads();
    if (slice + kStages - 1 < n_slices)
      load_slice(slice + kStages - 1, (slice + kStages - 1) % kStages);
    cp_async_commit();
    if (slice + 1 < n_slices) load_fragments((slice + 1) % kStages, next_big, next_small);
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_slices) load_slice(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // slice 0
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t big0[4][4], small0[4][4], big1[4][4], small1[4][4];
  load_fragments(0, big0, small0);
  for (int slice = 0; slice < n_slices; slice += 2) {
    step(slice, big0, small0, big1, small1);
    if (slice + 1 < n_slices) step(slice + 1, big1, small1, big0, small0);
  }

  tile_epilogue<kBN, kTM>(g, acc, smem_raw, smem_base, part_out, m0, n0, frag_row, frag_col);
}

// Split-K: the splits' partial sums of 4 neighbouring columns of one row,
// added in split order, then the epilogue, one thread per 4 elements.
__global__ void splitk_reduce_kernel(const ConvGemm g, const float* __restrict__ part,
                                     int splits) {
  const int rows = g.batch * g.t;
  const int n4 = g.n / 4;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)rows * n4) return;
  const int m = (int)(i / n4);
  const int col = 4 * (int)(i - (long)m * n4);
  const long split_stride = (long)rows * g.n;
  float4 v = *reinterpret_cast<const float4*>(part + (long)m * g.n + col);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(part + z * split_stride + (long)m * g.n + col);
    v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
  }
  const float four[4] = {v.x, v.y, v.z, v.w};
  epilogue_cols<4>(g, epilogue_row_of(g, m), col, four);
}

template <int kBN, int kTM>
cudaError_t launch_conv_gemm_tc(const ConvGemm& g, const float* big, int splits,
                                cudaStream_t stream) {
  // per device, so set on every launch: a process may drive several
  cudaError_t err = cudaFuncSetAttribute(conv_gemm_tc_kernel<kBN, kTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         conv_gemm_tc_smem<kBN, kTM>());
  if (err != cudaSuccess) return err;
  const int rows = g.batch * g.t;
  const int n_slices = (g.taps * g.c_in + kTK - 1) / kTK;
  const int per_split = (n_slices + splits - 1) / splits;
  splits = (n_slices + per_split - 1) / per_split;  // no empty split
  const dim3 grid((g.n + kBN - 1) / kBN, (rows + kTM - 1) / kTM, splits);
  conv_gemm_tc_kernel<kBN, kTM><<<grid, 2 * kTM, conv_gemm_tc_smem<kBN, kTM>(), stream>>>(
      g, big, splits > 1 ? g.part : nullptr, per_split);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const long threads = (long)rows * (g.n / 4);
  splitk_reduce_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(g, g.part, splits);
  return cudaGetLastError();
}

// 128-column tiles where they divide the width, else 64
int conv_gemm_tc_bn(int n) { return n % 128 == 0 ? 128 : 64; }

// ---------------------------------------------------------------------------
// the tap-staged conv-GEMM (the WN reverse walk's transposed conv)
// ---------------------------------------------------------------------------

// The B ring's stages (one (channel slice, tap) step each); A has two
// stages, one a channel slice.  An A stage is overwritten kTapStages - 1
// steps before its step; the last read of the stage two channel slices back
// is taps steps earlier, so the ring needs taps >= kTapStages - 2.
constexpr int kTapStages = 4;

// Rows of a tile's A stage: the tile and its dilated halo.
__host__ __device__ constexpr int tap_halo_rows(int tile_rows, int taps, int dilation) {
  return tile_rows + (taps - 1) * dilation;
}

__host__ __device__ constexpr long conv_gemm_tap_smem(int bn, int tile_rows, int taps,
                                                      int dilation) {
  return (long)kTapStages * 2 * bn * 128 +
         2L * tap_halo_rows(tile_rows, taps, dilation) * kAStride * 4 + 1024;
}

// conv_gemm_tc_kernel's product with K walked channel slice outer and tap
// inner (c_in a multiple of 32): per 32-channel slice the tile's rows and
// their (taps - 1) * dilation halo rows are copied once, and each tap's A
// fragments are loaded from that stage at the tap's row offset (A comes
// from registers, so the offset is an address, not a copy).  A stage row
// is a source row of the whole batch; an output row's gather reads it only
// where the tap stays inside the row's own sample (else zero, as the
// tap-by-tap walk's copies zero-fill).  B keeps its ring of K-major split
// slices, one a (channel slice, tap) step.  At the transposed conv of the
// WN walk [11264, 5 * 384, 192] this cuts A's copies from L2 to shared
// memory from 64 * 5 to 68 rows a channel slice in 64-row tiles (the
// tap-by-tap walk's copies at 128 rows: A 260 MB, B 260 MB).  No split-K
// (part_out is null); the epilogue and the software pipeline of
// conv_gemm_tc_kernel.  (A second set of `part`, so that a step's wgmmas
// are issued before the previous step's are added, made ptxas serialize
// the wgmmas, C7514: 121.5 -> 159.5 us at [11264, 1920, 192]; three
// blocks an SM at 64 rows, 168 registers, read 130.8.)
template <int kBN, int kTM>
__global__ void __launch_bounds__(2 * kTM, 1)
    conv_gemm_tap_kernel(const ConvGemm g, const float* __restrict__ w_big) {
  constexpr int kThreads = 2 * kTM;
  constexpr int kRowStep = kThreads / 8;  // stage rows one pass of 16-byte copies covers
  constexpr int kStages = kTapStages;
  constexpr int kBTileBytes = kBN * 128;
  constexpr int kBRows = kBN / kRowStep;  // B tile rows a thread copies, big and small each
  extern __shared__ unsigned char smem_raw[];
  // B tiles first, 1024-byte aligned for the swizzle; then the two A stages
  const uint32_t smem_base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_base = smem_base;
  const uint32_t a_base = smem_base + kStages * 2 * kBTileBytes;
  const float* a_tiles = reinterpret_cast<const float*>(smem_raw + (a_base - smem_addr(smem_raw)));

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kBN;
  const int rows = g.batch * g.t;
  const int kdim = g.taps * g.c_in;
  const int halo = (g.taps / 2) * g.dilation;  // stage rows before the tile's first
  const int halo_rows = tap_halo_rows(kTM, g.taps, g.dilation);
  const int a_stage_floats = halo_rows * kAStride;
  const int n_steps = (g.c_in / kTK) * g.taps;
  const long small_off = (long)kdim * g.n;

  const int cc = tid & 7;
  const int r0 = tid >> 3;
  long b_row[kBRows];  // offset of the K-major row this tile row reads, -1 past n
#pragma unroll
  for (int i = 0; i < kBRows; ++i) {
    const int n = n0 + r0 + kRowStep * i;
    b_row[i] = n < g.n ? (long)physical_col(g, n) * kdim : -1;
  }
  const uint32_t a_dst0 = a_base + (r0 * kAStride + 4 * cc) * 4;
  const uint32_t b_dst0 = b_base + r0 * 128 + ((cc ^ (r0 & 7)) << 4);

  // step s: channel slice s / taps, tap s % taps; at tap 0 also the slice's A stage
  auto load_step = [&](int s, int stage) {
    const int cs = s / g.taps, tap = s - cs * g.taps;
    if (tap == 0) {
      const uint32_t a_dst = a_dst0 + (cs & 1) * a_stage_floats * 4;
      for (int r = r0; r < halo_rows; r += kRowStep) {
        const int gm = m0 - halo + r;
        const bool ok = gm >= 0 && gm < rows;
        const float* src = ok ? g.a + (long)gm * g.lda + cs * kTK + 4 * cc : g.a;
        cp_async16(a_dst + (r - r0) * kAStride * 4, src, ok ? 16 : 0);
      }
    }
    const int kidx = tap * g.c_in + cs * kTK + 4 * cc;
    const uint32_t b_dst = b_dst0 + stage * 2 * kBTileBytes;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const bool ok = b_row[i] >= 0;
      const float* src = ok ? w_big + b_row[i] + kidx : w_big;
      cp_async16(b_dst + i * kRowStep * 128, src, ok ? 16 : 0);
      cp_async16(b_dst + kBTileBytes + i * kRowStep * 128, ok ? src + small_off : w_big,
                 ok ? 16 : 0);
    }
  };

  // this thread's fragment rows: frag_row and frag_row + 8 of its warp's 16,
  // and their time indices (a tap's row is read only inside the sample)
  const int wg = tid >> 7;
  const int warp_in_wg = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int frag_row = wg * 64 + warp_in_wg * 16 + (lane >> 2);
  const int frag_col = lane & 3;
  const int t_lo = (m0 + frag_row) % g.t;
  const int t_hi = (m0 + frag_row + 8) % g.t;

  auto load_fragments = [&](int s, uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
    const int cs = s / g.taps, tap = s - cs * g.taps;
    const int off = g.tap_sign * (tap - g.taps / 2) * g.dilation;
    const bool ok_lo = (unsigned)(t_lo + off) < (unsigned)g.t;
    const bool ok_hi = (unsigned)(t_hi + off) < (unsigned)g.t;
    const float* at = a_tiles + (cs & 1) * a_stage_floats + (frag_row + off + halo) * kAStride +
                      frag_col;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const float v0 = ok_lo ? at[ks * 8] : 0.f;
      const float v1 = ok_hi ? at[ks * 8 + 8 * kAStride] : 0.f;
      const float v2 = ok_lo ? at[ks * 8 + 4] : 0.f;
      const float v3 = ok_hi ? at[ks * 8 + 8 * kAStride + 4] : 0.f;
      split_tf32(v0, big[ks][0], small[ks][0]);
      split_tf32(v1, big[ks][1], small[ks][1]);
      split_tf32(v2, big[ks][2], small[ks][2]);
      split_tf32(v3, big[ks][3], small[ks][3]);
    }
  };

  // a step's products start from zero in `part`, added on the CUDA cores
  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  auto step = [&](int s, uint32_t (&big)[4][4], uint32_t (&small)[4][4],
                  uint32_t (&next_big)[4][4], uint32_t (&next_small)[4][4]) {
    const int stage = s % kStages;
    const uint64_t d_big = b_descriptor(b_base + (stage * 2) * kBTileBytes);
    const uint64_t d_small = b_descriptor(b_base + (stage * 2 + 1) * kBTileBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<kBN>::run(part, small[ks], d_big + 2 * ks, ks > 0);
      Wgmma<kBN>::run(part, big[ks], d_small + 2 * ks, 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<kBN>::run(part, big[ks], d_big + 2 * ks, 1);
    wgmma_commit();
    cp_async_wait<kStages - 3>();  // this thread's copies of step s + 1 have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    // everyone's copies of s + 1 have landed; everyone is done with the
    // wgmmas of s - 1 (whose B stage the copies below overwrite) and with
    // the fragment loads of s (the A stage two channel slices back)
    __syncthreads();
    if (s + kStages - 1 < n_steps) load_step(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    if (s + 1 < n_steps) load_fragments(s + 1, next_big, next_small);
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_steps) load_step(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();  // step 0
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t big0[4][4], small0[4][4], big1[4][4], small1[4][4];
  load_fragments(0, big0, small0);
  for (int s = 0; s < n_steps; s += 2) {
    step(s, big0, small0, big1, small1);
    if (s + 1 < n_steps) step(s + 1, big1, small1, big0, small0);
  }

  tile_epilogue<kBN, kTM>(g, acc, smem_raw, smem_base, nullptr, m0, n0, frag_row, frag_col);
}

template <int kBN, int kTM>
cudaError_t launch_conv_gemm_tap(const ConvGemm& g, const float* big, cudaStream_t stream) {
  const int smem = (int)conv_gemm_tap_smem(kBN, kTM, g.taps, g.dilation);
  cudaError_t err = cudaFuncSetAttribute(conv_gemm_tap_kernel<kBN, kTM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = g.batch * g.t;
  const dim3 grid((g.n + kBN - 1) / kBN, (rows + kTM - 1) / kTM);
  conv_gemm_tap_kernel<kBN, kTM><<<grid, 2 * kTM, smem, stream>>>(g, big);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the tensor-core weight-gradient GEMM
// ---------------------------------------------------------------------------

constexpr int kGK = 128;        // output tile: im2col columns (64 a warpgroup)
constexpr int kGM = 32;         // rows a slice: one 128-byte swizzled row of dY^T
constexpr int kGAStride = 136;  // floats a row of the raw A tile
constexpr int kGStages = 3;     // raw slices in flight

// floats of one raw stage: A [kGM, kGAStride], dY [kGM, kBN + 8], two row masks
template <int kBN>
__host__ __device__ constexpr int wgrad_tc_stage_floats() {
  return kGM * kGAStride + kGM * (kBN + 8) + 2 * kGM;
}

// two buffers of dY^T (big and small), the raw ring, room to align
template <int kBN>
constexpr int wgrad_tc_smem() {
  return 4 * kBN * 128 + kGStages * wgrad_tc_stage_floats<kBN>() * 4 + 1024;
}

// A weight-gradient block's output tile from its accumulators: acc[4 j +
// {0, 1}] are columns 8 j + 2 tig + {0, 1} of output row k, acc[4 j + {2,
// 3}] the same columns of row k + 8; four lanes write one 32-byte sector.
// dst: this split's partial tile of kout rows (kdim, and the bias row
// where bias_out is given), or the final [kdim, n] with the bias row to
// bias_dst.
template <int kBN>
__device__ __forceinline__ void wgrad_tile_out(const WGrad& w, const float (&acc)[kBN / 2],
                                               float* dst, float* bias_dst, int n0, int k,
                                               int tig) {
  const int kdim = w.taps * w.c_in;
  const int kout = kdim + (w.bias_out != nullptr);
  float* out = dst + (long)blockIdx.z * kout * w.n;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * tig;
    if (n >= w.n) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kh = k + 8 * half;
      if (kh >= kout) continue;
      float* at = kh == kdim && bias_dst != nullptr ? bias_dst + n : out + (long)kh * w.n + n;
      *reinterpret_cast<float2*>(at) = make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
}

// The bias row (WGrad::bias_out): im2col column kdim is a column of ones on
// the rows (zero past the last), copied from here.
__device__ __align__(16) float kOnesChunk[4] = {1.f, 0.f, 0.f, 0.f};

// dst: [splits, kout, n] partial tiles (kout = kdim, plus the bias row);
// bias_dst: where the bias row goes when dst is the final [kdim, n] (one
// split), else null.
template <int kBN>
__global__ void __launch_bounds__(256, 1)
    wgrad_tc_kernel(const WGrad w, int rows_per_split, float* dst, float* bias_dst) {
  constexpr int kBTileBytes = kBN * 128;
  constexpr int kYStride = kBN + 8;
  constexpr int kYChunks = kBN / 4;  // 16-byte chunks a row of the raw dY tile
  constexpr int kStageFloats = wgrad_tc_stage_floats<kBN>();
  extern __shared__ unsigned char smem_raw[];
  // dY^T tiles first, 1024-byte aligned for the swizzle; then the raw ring
  const uint32_t smem_base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (smem_base - smem_addr(smem_raw));
  const uint32_t raw_base = smem_base + 4 * kBTileBytes;
  const float* raw = reinterpret_cast<const float*>(smem + 4 * kBTileBytes);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kGK;
  const int rows = w.batch * w.t;
  const int kdim = w.taps * w.c_in;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(rows, m_begin + rows_per_split);
  const int n_slices = (m_end - m_begin + kGM - 1) / kGM;

  // staging: A's 16-byte chunk tid % 32 of tile rows tid / 32 + 8 i, dY's
  // chunk tid % kYChunks of rows tid / kYChunks + (256 / kYChunks) i
  const int cc_a = tid & 31;
  const int kk = k0 + 4 * cc_a;
  const bool k_ok = kk < kdim;
  const bool ones = w.bias_out != nullptr && kk == kdim;  // the bias row's column
  const int tap = k_ok ? kk / w.c_in : 0;
  const int c = kk - tap * w.c_in;
  const int off = (tap - w.taps / 2) * w.dilation;
  const int cc_b = tid % kYChunks;
  const int ncol = n0 + 4 * cc_b;
  const bool n_ok = ncol < w.n;

  auto load_slice = [&](int slice, int stage) {
    const int m_first = m_begin + slice * kGM;
    const int b_first = m_first / w.t;
    const uint32_t a_dst = raw_base + (stage * kStageFloats + (tid >> 5) * kGAStride + 4 * cc_a) * 4;
#pragma unroll
    for (int i = 0; i < kGM / 8; ++i) {
      const int m = m_first + (tid >> 5) + 8 * i;
      int b = b_first, tr = m - b_first * w.t;  // the row's sample and time index
      while (tr >= w.t) { tr -= w.t; ++b; }
      const int ts = tr + off;
      const bool ok = m < m_end && k_ok && ts >= 0 && ts < w.t;
      const float* src = ok ? w.a + ((long)b * w.t + ts) * w.lda + c : ones ? kOnesChunk : w.a;
      cp_async16(a_dst + 8 * i * kGAStride * 4, src, ok || (ones && m < m_end) ? 16 : 0);
    }
    constexpr int kYRows = 256 / kYChunks;  // rows one pass of the block covers
    const uint32_t y_dst = raw_base + (stage * kStageFloats + kGM * kGAStride +
                                       (tid / kYChunks) * kYStride + 4 * cc_b) * 4;
#pragma unroll
    for (int i = 0; i < kGM / kYRows; ++i) {
      const int m = m_first + tid / kYChunks + kYRows * i;
      const bool ok = m < m_end && n_ok;
      const float* src = ok ? w.dy + (long)m * w.ldy + ncol : w.dy;
      cp_async16(y_dst + kYRows * i * kYStride * 4, src, ok ? 16 : 0);
    }
    if (tid < kGM) {  // the slice's row masks (null: ones are used instead)
      const int m = m_first + tid;
      const uint32_t m_dst =
          raw_base + (stage * kStageFloats + kGM * kGAStride + kGM * kYStride + tid) * 4;
      if (w.dy_mask) cp_async4(m_dst, m < m_end ? w.dy_mask + m : w.dy_mask, m < m_end ? 4 : 0);
      if (w.a_mask) cp_async4(m_dst + kGM * 4, m < m_end ? w.a_mask + m : w.a_mask, m < m_end ? 4 : 0);
    }
  };

  // dY^T of a raw slice, masked and split, into buffer `buf`: a thread takes
  // 4 neighbouring rows of one column, one 16-byte chunk of the K-major tile
  // (rows of 128 bytes in the 128-byte swizzle, as conv_gemm_tc_kernel's B)
  auto transpose_dy = [&](int stage, int buf) {
    const float* ys = raw + stage * kStageFloats + kGM * kGAStride;
    const float* dy_mask = ys + kGM * kYStride;
    const float* a_mask = dy_mask + kGM;
    unsigned char* tile = smem + buf * 2 * kBTileBytes;
#pragma unroll
    for (int i = 0; i < kBN * 8 / 256; ++i) {
      const int q = tid + 256 * i;
      const int n = q % kBN, mc = q / kBN;
      uint32_t big[4], small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * mc + e;
        float v = ys[r * kYStride + n];
        if (w.dy_mask) v *= dy_mask[r];
        if (w.a_mask) v *= a_mask[r];
        split_tf32(v, big[e], small[e]);
      }
      unsigned char* at = tile + n * 128 + ((mc ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(at) = make_uint4(big[0], big[1], big[2], big[3]);
      *reinterpret_cast<uint4*>(at + kBTileBytes) =
          make_uint4(small[0], small[1], small[2], small[3]);
    }
  };

  // this thread's fragment rows (im2col columns of the tile): frag_row and
  // frag_row + 8 of its warp's 16; the fragment's k runs over the slice's rows
  const int wg = tid >> 7;
  const int warp_in_wg = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int frag_row = wg * 64 + warp_in_wg * 16 + (lane >> 2);
  const int tig = lane & 3;
  auto load_fragments = [&](int stage, uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
    const float* at = raw + stage * kStageFloats + tig * kGAStride + frag_row;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      split_tf32(at[ks * 8 * kGAStride], big[ks][0], small[ks][0]);
      split_tf32(at[ks * 8 * kGAStride + 8], big[ks][1], small[ks][1]);
      split_tf32(at[(ks * 8 + 4) * kGAStride], big[ks][2], small[ks][2]);
      split_tf32(at[(ks * 8 + 4) * kGAStride + 8], big[ks][3], small[ks][3]);
    }
  };

  // a slice's products start from zero in `part` and are added to `acc` on
  // the CUDA cores (see conv_gemm_tc_kernel)
  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  // One slice: its twelve wgmmas run while this thread issues the copies of
  // a later slice and prepares the next one (dY^T into the other buffer, the
  // A fragments into the other register set).  The one barrier says that
  // everyone's copies of slice + 1 have landed, everyone's part of this
  // slice's dY^T is written, and everyone is done with the wgmmas of
  // slice - 1 (whose dY^T buffer the next one overwrites) and with the raw
  // stage of this slice (which the copies below overwrite).
  auto step = [&](int slice, uint32_t (&big)[4][4], uint32_t (&small)[4][4],
                  uint32_t (&next_big)[4][4], uint32_t (&next_small)[4][4]) {
    const int buf = slice & 1;
    const uint64_t d_big = b_descriptor(smem_base + (buf * 2) * kBTileBytes);
    const uint64_t d_small = b_descriptor(smem_base + (buf * 2 + 1) * kBTileBytes);
    cp_async_wait<1>();
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<kBN>::run(part, small[ks], d_big + 2 * ks, ks > 0);
      Wgmma<kBN>::run(part, big[ks], d_small + 2 * ks, 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<kBN>::run(part, big[ks], d_big + 2 * ks, 1);
    wgmma_commit();
    if (slice + kGStages < n_slices) load_slice(slice + kGStages, slice % kGStages);
    cp_async_commit();
    if (slice + 1 < n_slices) {
      transpose_dy((slice + 1) % kGStages, buf ^ 1);
      // make the tile visible to the tensor cores' reads of shared memory
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_fragments((slice + 1) % kGStages, next_big, next_small);
    }
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
  };

#pragma unroll
  for (int s = 0; s < kGStages; ++s) {
    if (s < n_slices) load_slice(s, s);
    cp_async_commit();
  }
  uint32_t big0[4][4], small0[4][4], big1[4][4], small1[4][4];
  if (n_slices > 0) {
    cp_async_wait<kGStages - 1>();  // slice 0
    __syncthreads();
    transpose_dy(0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    load_fragments(0, big0, small0);
  }
  for (int slice = 0; slice < n_slices; slice += 2) {
    step(slice, big0, small0, big1, small1);
    if (slice + 1 < n_slices) step(slice + 1, big1, small1, big0, small0);
  }

  wgrad_tile_out<kBN>(w, acc, dst, bias_dst, n0, k0 + frag_row, tig);
}

// wgrad_tc_kernel with dY read as its K-major 3xTF32 split (WGrad::dy_t:
// the WN reverse walk's dW_in, whose gate-backward epilogue writes d_xin so):
// B comes through a ring of split slices by 16-byte copies into the 128-byte
// swizzle, as conv_gemm_tc_kernel reads its weights, beside the raw A
// slices, with the software pipeline of conv_gemm_tc_kernel: no
// transposition, no split and no second buffer of dY^T in the kernel, one
// barrier a slice.  No row masks.
constexpr int kGSplitStages = 4;

template <int kBN>
constexpr int wgrad_split_smem() {
  return kGSplitStages * (2 * kBN * 128 + kGM * kGAStride * 4) + 1024;
}

template <int kBN>
__global__ void __launch_bounds__(256, 1)
    wgrad_tc_split_kernel(const WGrad w, int rows_per_split, float* dst, float* bias_dst) {
  constexpr int kStages = kGSplitStages;
  constexpr int kBTileBytes = kBN * 128;
  constexpr int kBRows = kBN / 32;  // dY^T tile rows a thread copies, big and small each
  extern __shared__ unsigned char smem_raw[];
  // dY^T tiles first, 1024-byte aligned for the swizzle; then the raw A ring
  const uint32_t smem_base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_base = smem_base;
  const uint32_t a_base = smem_base + kStages * 2 * kBTileBytes;
  const float* a_raw = reinterpret_cast<const float*>(smem_raw + (a_base - smem_addr(smem_raw)));

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kGK;
  const int rows = w.batch * w.t;
  const int kdim = w.taps * w.c_in;
  const int m_begin = blockIdx.z * rows_per_split;
  const int m_end = min(rows, m_begin + rows_per_split);
  const int n_slices = (m_end - m_begin + kGM - 1) / kGM;

  // A staging as wgrad_tc_kernel's: chunk tid % 32 of tile rows tid / 32 + 8 i
  const int cc_a = tid & 31;
  const int kk = k0 + 4 * cc_a;
  const bool k_ok = kk < kdim;
  const bool ones = w.bias_out != nullptr && kk == kdim;
  const int tap = k_ok ? kk / w.c_in : 0;
  const int c = kk - tap * w.c_in;
  const int off = (tap - w.taps / 2) * w.dilation;
  // dY^T staging: chunk tid % 8 (4 rows) of tile rows (dY columns) tid / 8 + 32 i
  const int cc = tid & 7;
  const int r0 = tid >> 3;
  long y_row[kBRows];  // offset of the K-major row this tile row reads, -1 past n
#pragma unroll
  for (int i = 0; i < kBRows; ++i) {
    const int n = n0 + r0 + 32 * i;
    y_row[i] = n < w.n ? (long)n * w.ldt : -1;
  }
  const long small_off = (long)w.n * w.ldt;
  const uint32_t b_dst0 = b_base + r0 * 128 + ((cc ^ (r0 & 7)) << 4);

  auto load_slice = [&](int slice, int stage) {
    const int m_first = m_begin + slice * kGM;
    const int b_first = m_first / w.t;
    const uint32_t a_dst = a_base + (stage * kGM * kGAStride + (tid >> 5) * kGAStride + 4 * cc_a) * 4;
#pragma unroll
    for (int i = 0; i < kGM / 8; ++i) {
      const int m = m_first + (tid >> 5) + 8 * i;
      int b = b_first, tr = m - b_first * w.t;
      while (tr >= w.t) { tr -= w.t; ++b; }
      const int ts = tr + off;
      const bool ok = m < m_end && k_ok && ts >= 0 && ts < w.t;
      const float* src = ok ? w.a + ((long)b * w.t + ts) * w.lda + c : ones ? kOnesChunk : w.a;
      cp_async16(a_dst + 8 * i * kGAStride * 4, src, ok || (ones && m < m_end) ? 16 : 0);
    }
    const int mc = m_first + 4 * cc;
    const uint32_t b_dst = b_dst0 + stage * 2 * kBTileBytes;
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const bool ok = y_row[i] >= 0 && mc < m_end;
      const float* src = ok ? w.dy_t + y_row[i] + mc : w.dy_t;
      cp_async16(b_dst + 32 * i * 128, src, ok ? 16 : 0);
      cp_async16(b_dst + kBTileBytes + 32 * i * 128, ok ? src + small_off : w.dy_t, ok ? 16 : 0);
    }
  };

  const int wg = tid >> 7;
  const int warp_in_wg = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int frag_row = wg * 64 + warp_in_wg * 16 + (lane >> 2);
  const int tig = lane & 3;
  auto load_fragments = [&](int stage, uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
    const float* at = a_raw + stage * kGM * kGAStride + tig * kGAStride + frag_row;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      split_tf32(at[ks * 8 * kGAStride], big[ks][0], small[ks][0]);
      split_tf32(at[ks * 8 * kGAStride + 8], big[ks][1], small[ks][1]);
      split_tf32(at[(ks * 8 + 4) * kGAStride], big[ks][2], small[ks][2]);
      split_tf32(at[(ks * 8 + 4) * kGAStride + 8], big[ks][3], small[ks][3]);
    }
  };

  float acc[kBN / 2], part[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

  auto step = [&](int slice, uint32_t (&big)[4][4], uint32_t (&small)[4][4],
                  uint32_t (&next_big)[4][4], uint32_t (&next_small)[4][4]) {
    const int stage = slice % kStages;
    const uint64_t d_big = b_descriptor(b_base + (stage * 2) * kBTileBytes);
    const uint64_t d_small = b_descriptor(b_base + (stage * 2 + 1) * kBTileBytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      Wgmma<kBN>::run(part, small[ks], d_big + 2 * ks, ks > 0);
      Wgmma<kBN>::run(part, big[ks], d_small + 2 * ks, 1);
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<kBN>::run(part, big[ks], d_big + 2 * ks, 1);
    wgmma_commit();
    cp_async_wait<kStages - 3>();  // this thread's copies of slice + 1 have landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (slice + kStages - 1 < n_slices)
      load_slice(slice + kStages - 1, (slice + kStages - 1) % kStages);
    cp_async_commit();
    if (slice + 1 < n_slices) load_fragments((slice + 1) % kStages, next_big, next_small);
    wgmma_wait();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] += part[i];
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_slices) load_slice(st, st);
    cp_async_commit();
  }
  uint32_t big0[4][4], small0[4][4], big1[4][4], small1[4][4];
  if (n_slices > 0) {
    cp_async_wait<kStages - 2>();  // slice 0
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_fragments(0, big0, small0);
  }
  for (int slice = 0; slice < n_slices; slice += 2) {
    step(slice, big0, small0, big1, small1);
    if (slice + 1 < n_slices) step(slice + 1, big1, small1, big0, small0);
  }
  wgrad_tile_out<kBN>(w, acc, dst, bias_dst, n0, k0 + frag_row, tig);
}

template <int kBN>
cudaError_t launch_wgrad_tc(const WGrad& w, int rows_per_split, int splits, float* dst,
                            float* bias_dst, cudaStream_t stream) {
  const bool split_dy = w.dy_t != nullptr;
  const int smem = split_dy ? wgrad_split_smem<kBN>() : wgrad_tc_smem<kBN>();
  cudaError_t err =
      split_dy ? cudaFuncSetAttribute(wgrad_tc_split_kernel<kBN>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
               : cudaFuncSetAttribute(wgrad_tc_kernel<kBN>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int kout = w.taps * w.c_in + (w.bias_out != nullptr);
  const dim3 grid((w.n + kBN - 1) / kBN, (kout + kGK - 1) / kGK, (unsigned)splits);
  if (split_dy)
    wgrad_tc_split_kernel<kBN><<<grid, 256, smem, stream>>>(w, rows_per_split, dst, bias_dst);
  else
    wgrad_tc_kernel<kBN><<<grid, 256, smem, stream>>>(w, rows_per_split, dst, bias_dst);
  return cudaGetLastError();
}

// The splits' partial tiles [splits, per_split] added in split order: the
// first out_floats to out, the rest (the bias row) to bias.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, long per_split, int splits,
                                    float* __restrict__ out, long out_floats,
                                    float* __restrict__ bias) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= per_split) return;
  float v = part[i];
  for (int z = 1; z < splits; ++z) v += part[z * per_split + i];
  if (i < out_floats) out[i] = v;
  else bias[i - out_floats] = v;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

bool conv_gemm_tc_can(const ConvGemm& g) {
  const long kdim = (long)g.taps * g.c_in;
  const bool b_ok = g.w_split != nullptr
                        ? aligned16(g.w_split)
                        : aligned16(g.tc_scratch) && 2 * kdim * g.n <= g.tc_scratch_floats;
  // d_xin's K-major split (the gate backward's out4): the whole K walk a
  // block, 16-byte stores
  const bool out4_ok =
      g.out4 == nullptr || (g.epilogue == kGateBwd && g.part == nullptr && !g.small_batch &&
                            !g.tap_staged && aligned16(g.out4) && g.ldo4 % 4 == 0 &&
                            g.ldo4 >= (long)g.batch * g.t);
  return g.c_in % 4 == 0 && g.lda % 4 == 0 && aligned16(g.a) && kdim > 0 &&
         (g.a_mask == nullptr || g.taps == 1) &&
         (g.tc_scratch != nullptr || g.w_split != nullptr) && b_ok && out4_ok;
}

// Split-K, for a chain that gives scratch for the partial sums (the text
// side's and the serving inverse's): the count of K shares, at most
// max_splits with at least min_slices slices each and within max_cols
// partial sums a row, whose waves of blocks times slices a block,
// ceil(tiles s / sms) ceil(slices / s), is least (ties go to fewer
// shares).  Wave quantisation is what a short, deep product loses: at
// [3072, 2304, 192] 72 tiles walk 72 slices in one wave, where 3 shares
// walk 24 in two.  A chain's share walks at least 128 deep: the 192-deep
// products lost more to their partial sums' round trip than the waves gave
// back (PERF.md).  Only for products of at least kSplitKMinRows rows: a
// lone short sentence of the text side keeps the dispatch it had.
struct SplitLimits {
  long max_splits, min_slices, max_cols;
};
constexpr SplitLimits kChainSplits{4, 4, kSplitKCols};
constexpr long kSplitKMinRows = 512;
// The serving chain (ConvGemm::small_batch) takes the tensor cores for
// every product, in 128- or 64-row tiles, whichever with its best share
// count makes the fewest waves times slices a block (ties to fewer shares,
// then to the 64-row tile).  Below kLoneSentenceRows rows (a lone sentence
// of up to about 340 phonemes) every product is latency-bound, one block's
// serial K walk and the launch, and its partial sums are few, so the K
// walk may be cut as fine as 64 deep into up to 8 shares; a batch keeps
// the chains' limits.  Measured at base width
// (scripts/torch-serve-plan-sweep.py, PERF.md): within 3% of the best
// tile and share count at 160 and 832 rows, where the chains' limits on
// 128-row tiles lost 25-30%, and within 1% at 3,328 and 4,352.
constexpr SplitLimits kLoneSplits{8, 2, kLoneSplitKCols};
constexpr long kLoneSentenceRows = 1024;

// The tap-staged kernel (ConvGemm::tap_staged, the WN reverse walk's
// transposed conv) takes 64-row tiles, one warpgroup a block and two
// blocks an SM: at [11264, 5 * 384, 192] 121.5 us on the device against
// 140.6 in 128-row tiles (both warpgroups of a block behind one barrier a
// step) and 132.7 and 146.4 tap by tap; at h 256 253.9 against 263.4
// (scripts/torch-wn-walk-sweep.py, PERF.md).  It needs 32-channel
// slices, taps >= kTapStages - 2 (its A ring), a halo shorter than the
// tile (else the tap-by-tap walk copies less) and the stages within a
// block's shared memory; and, like every chain's tile, blocks for a
// quarter of the SMs.  Else the product takes the tap-by-tap walk.
constexpr int kTapTileRows = 64;
constexpr long kMaxBlockSmem = 232448;

namespace {

long row_tiles(const ConvGemm& g, int tile_rows) {
  return ((long)g.batch * g.t + tile_rows - 1) / tile_rows;
}

bool tap_staged_takes(const ConvGemm& g, int sms) {
  const int bn = conv_gemm_tc_bn(g.n);
  return g.tap_staged && g.c_in % kTK == 0 && g.taps > 1 && g.taps >= kTapStages - 2 &&
         (g.taps - 1) * g.dilation < kTapTileRows && g.a_mask == nullptr &&
         g.out4 == nullptr && g.part == nullptr && !g.small_batch &&
         conv_gemm_tap_smem(bn, kTapTileRows, g.taps, g.dilation) <= kMaxBlockSmem &&
         4 * row_tiles(g, kTapTileRows) * ((g.n + bn - 1) / bn) >= sms;
}

// (waves times slices a block, shares) of the best share count
void best_shares(const ConvGemm& g, int sms, int tile_rows, const SplitLimits& lim,
                 long* cost, int* splits) {
  const int bn = conv_gemm_tc_bn(g.n);
  const long tiles = row_tiles(g, tile_rows) * ((g.n + bn - 1) / bn);
  const long n_slices = (g.taps * g.c_in + kTK - 1) / kTK;
  long best = 1, best_cost = ((tiles + sms - 1) / sms) * n_slices;
  if (g.part != nullptr && g.n % 4 == 0) {
    for (long s = 2; s <= lim.max_splits; ++s) {
      const long per_split = (n_slices + s - 1) / s;
      const long shares = (n_slices + per_split - 1) / per_split;  // no empty share
      if (per_split < lim.min_slices || shares * g.n > lim.max_cols) break;
      const long c = ((tiles * shares + sms - 1) / sms) * per_split;
      if (c < best_cost) { best = shares; best_cost = c; }
    }
  }
  *cost = best_cost;
  *splits = (int)best;
}

}  // namespace

TcPlan conv_gemm_tc_plan(const ConvGemm& g, int sms) {
  TcPlan p;
  const long rows = (long)g.batch * g.t;
  if (tap_staged_takes(g, sms)) {
    p.tile_rows = kTapTileRows;
    p.tap_staged = 1;
    return p;
  }
  if (g.small_batch) {  // the serving chain
    const SplitLimits& lim = rows < kLoneSentenceRows ? kLoneSplits : kChainSplits;
    long cost64, cost128;
    int splits64, splits128;
    best_shares(g, sms, 64, lim, &cost64, &splits64);
    best_shares(g, sms, 128, lim, &cost128, &splits128);
    const bool take64 = cost64 < cost128 || (cost64 == cost128 && splits64 <= splits128);
    p.tile_rows = take64 ? 64 : 128;
    p.splits = take64 ? splits64 : splits128;
    return p;
  }
  long cost;
  if (rows >= kSplitKMinRows) best_shares(g, sms, 128, kChainSplits, &cost, &p.splits);
  // blocks for a quarter of the SMs: below that one block's serial K walk
  // decides, and the CUDA-core kernel's 32-row tiles win
  const int bn = conv_gemm_tc_bn(g.n);
  if (4 * row_tiles(g, 128) * ((g.n + bn - 1) / bn) * p.splits >= sms) p.tile_rows = 128;
  return p;
}

bool conv_gemm_tc_fits(const ConvGemm& g, int sms) {
  return conv_gemm_tc_can(g) && g.n >= 64 && g.taps * g.c_in >= 32 &&
         conv_gemm_tc_plan(g, sms).tile_rows > 0;
}

cudaError_t split_weights(const WeightSplits& s, cudaStream_t stream) {
  if (s.count <= 0) return cudaSuccess;
  int tiles = 0;
  for (int i = 0; i < s.count; ++i)
    tiles = std::max(tiles, ((s.job[i].kdim + 31) / 32) * ((s.job[i].n + 31) / 32));
  split_weights_kernel<<<dim3(tiles, s.count), dim3(32, 8), 0, stream>>>(s);
  return cudaGetLastError();
}

namespace {

WeightSplit split_job(const ConvGemm& g, float* big) {
  WeightSplit job;
  job.w = g.w; job.ldb = g.ldb ? g.ldb : g.n; job.kdim = g.taps * g.c_in; job.n = g.n;
  job.c_in = g.c_in; job.w_t = g.w_t; job.big = big; job.small = big + (long)job.kdim * g.n;
  return job;
}

}  // namespace

cudaError_t presplit_weights(ConvGemm* const* gs, int count, float* scratch, long floats,
                             cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  WeightSplits s;
  long used = 0;
  for (int i = 0; i < count; ++i) {
    ConvGemm& g = *gs[i];
    const long need = 2L * g.taps * g.c_in * g.n;
    if (used + need > floats || !conv_gemm_tc_fits(g, sms)) continue;
    s.job[s.count++] = split_job(g, scratch + used);
    g.w_split = scratch + used;
    used += (need + 3) / 4 * 4;
    if (s.count == kMaxSplits) {
      if ((err = split_weights(s, stream)) != cudaSuccess) return err;
      s = WeightSplits();
    }
  }
  return split_weights(s, stream);
}

cudaError_t conv_gemm_tc(const ConvGemm& g, int sms, cudaStream_t stream) {
  if (!conv_gemm_tc_can(g)) return cudaErrorInvalidValue;
  const float* big = g.w_split;
  if (big == nullptr) {  // split here, into the chain's scratch
    WeightSplits s;
    s.job[s.count++] = split_job(g, g.tc_scratch);
    const cudaError_t err = split_weights(s, stream);
    if (err != cudaSuccess) return err;
    ++product_splits();
    big = g.tc_scratch;
  }
  // a plan that declines (the bare kernel forced on a shape): 128-row tiles
  const TcPlan p = conv_gemm_tc_plan(g, sms);
  const bool bn128 = conv_gemm_tc_bn(g.n) == 128;
  if (p.tap_staged) {
    ++product_counts().tap_staged_gemm;
    return bn128 ? launch_conv_gemm_tap<128, kTapTileRows>(g, big, stream)
                 : launch_conv_gemm_tap<64, kTapTileRows>(g, big, stream);
  }
  if (p.tile_rows == 64)
    return bn128 ? launch_conv_gemm_tc<128, 64>(g, big, p.splits, stream)
                 : launch_conv_gemm_tc<64, 64>(g, big, p.splits, stream);
  return bn128 ? launch_conv_gemm_tc<128, 128>(g, big, p.splits, stream)
               : launch_conv_gemm_tc<64, 128>(g, big, p.splits, stream);
}

bool wgrad_tc_can(const WGrad& w) {
  const bool bias_ok = w.bias_out == nullptr || (w.a_mask == nullptr && aligned16(w.bias_out));
  const bool split_ok =
      w.dy_t == nullptr || (w.a_mask == nullptr && w.dy_mask == nullptr && aligned16(w.dy_t) &&
                            w.ldt % 4 == 0 && w.ldt >= (long)w.batch * w.t);
  return w.c_in % 4 == 0 && w.lda % 4 == 0 && w.n % 4 == 0 && w.ldy % 4 == 0 &&
         aligned16(w.a) && aligned16(w.dy) && aligned16(w.out) && aligned16(w.scratch) &&
         (w.a_mask == nullptr || w.taps == 1) && bias_ok && split_ok;
}

bool wgrad_tc_fits(const WGrad& w) {
  return wgrad_tc_can(w) && w.n >= 32 && w.taps * w.c_in >= 32 && w.batch * w.t >= 256;
}

cudaError_t wgrad_tc(const WGrad& w, int sms, cudaStream_t stream) {
  if (!wgrad_tc_can(w)) return cudaErrorInvalidValue;
  const int rows = w.batch * w.t;
  const int kdim = w.taps * w.c_in;
  const int kout = kdim + (w.bias_out != nullptr);  // the bias row: one more output row
  const int bn = conv_gemm_tc_bn(w.n);
  const int tiles = ((w.n + bn - 1) / bn) * ((kout + kGK - 1) / kGK);
  const long per_split = (long)kout * w.n;
  // one wave of one block an SM (a second, partly filled wave would double
  // the time), at least 256 rows a split, within scratch
  long splits = std::max(1, sms / tiles);
  splits = std::min(splits, std::max(1L, rows / 256L));
  splits = std::min(splits, std::max(1L, w.scratch_floats / per_split));
  if (w.scratch == nullptr) splits = 1;
  int rows_per_split = (int)((rows + splits - 1) / splits);
  rows_per_split = ((rows_per_split + kGM - 1) / kGM) * kGM;
  splits = std::max(1, (rows + rows_per_split - 1) / rows_per_split);
  float* dst = splits == 1 ? w.out : w.scratch;
  float* bias_dst = splits == 1 ? w.bias_out : nullptr;
  if (w.bias_out) ++product_counts().bias_wgrad;
  if (w.dy_t) ++product_counts().split_dy_wgrad;
  cudaError_t err =
      bn == 128 ? launch_wgrad_tc<128>(w, rows_per_split, (int)splits, dst, bias_dst, stream)
                : launch_wgrad_tc<64>(w, rows_per_split, (int)splits, dst, bias_dst, stream);
  if (err != cudaSuccess || splits == 1) return err;
  // the splits' partial sums, added in split order
  if (w.bias_out) {
    wgrad_reduce_kernel<<<(unsigned)((per_split + 255) / 256), 256, 0, stream>>>(
        w.scratch, per_split, (int)splits, w.out, (long)kdim * w.n, w.bias_out);
    return cudaGetLastError();
  }
  return col_sum(w.scratch, (int)per_split, (int)per_split, nullptr, 1, (int)splits, w.out,
                 (int)per_split, stream);
}

}  // namespace gtt

// ---------------------------------------------------------------------------
// the two device kernels alone, and the counters
// ---------------------------------------------------------------------------

// out [batch * t, n] = im2col(a) @ w: the bare product (kBias, no bias).
// mode 0: as the flow training chains run it; 1: the tensor-core kernel
// over the whole K walk, tap by tap (an error where it cannot run); 2: CUDA
// cores; 3: as the text chains run it (split-K allowed); 4: as the serving
// inverse chain runs it (finer split-K for a lone sentence, 64-row tiles);
// 5: as the WN reverse walk runs its transposed conv (tap-staged where the
// plan takes it).  The
// scratch holds the weights' split, then the split-K partial sums
// (kSplitKCols floats a row, kLoneSplitKCols in mode 4).  w_t: w is the forward conv's [taps * n, c_in] and the
// product its per-tap transpose.
extern "C" int gtt_tc_conv_gemm(const float* a, const float* w, const float* a_mask, float* out,
                                float* scratch, long long scratch_floats, int batch, int t,
                                int c_in, int lda, int taps, int dilation, int tap_sign, int n,
                                int w_t, int mode, cudaStream_t stream) {
  using namespace gtt;
  ConvGemm g;
  g.a = a; g.lda = lda; g.c_in = c_in; g.a_mask = a_mask; g.taps = taps;
  g.dilation = dilation; g.batch = batch; g.t = t; g.tap_sign = tap_sign;
  g.w = w; g.w_t = w_t; g.n = n; g.epilogue = kBias; g.out = out; g.ldo = n;
  if (mode != 2) {
    const long split_floats = ((2L * taps * c_in * n + 3) / 4) * 4;
    g.tc_scratch = scratch; g.tc_scratch_floats = split_floats;
    const long part_cols = mode == 4 ? kLoneSplitKCols : mode == 3 ? kSplitKCols : 0;
    if (split_floats + part_cols * batch * t > scratch_floats)
      return (int)cudaErrorInvalidValue;
    const bool split_k = part_cols > 0;
    if (split_k) g.part = scratch + split_floats;
    g.small_batch = mode == 4;
    g.tap_staged = mode == 5;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (mode != 1) return (int)conv_gemm(g, stream);
  if (!conv_gemm_tc_can(g)) return (int)cudaErrorInvalidValue;
  ++product_counts().tc_gemm;
  return (int)conv_gemm_tc(g, sms, stream);
}

// out [batch * t, n] = im2col(a) @ w on the tensor cores in a given tile
// (tile_rows 128 or 64) and K shares, whatever the plan would take: for
// sweeping the serving chain's plan.  Scratch as gtt_tc_conv_gemm's mode 4.
extern "C" int gtt_tc_conv_gemm_tiled(const float* a, const float* w, float* out,
                                      float* scratch, long long scratch_floats, int batch,
                                      int t, int c_in, int taps, int n, int tile_rows,
                                      int splits, cudaStream_t stream) {
  using namespace gtt;
  ConvGemm g;
  g.a = a; g.lda = c_in; g.c_in = c_in; g.taps = taps; g.batch = batch; g.t = t;
  g.w = w; g.n = n; g.epilogue = kBias; g.out = out; g.ldo = n;
  const long split_floats = ((2L * taps * c_in * n + 3) / 4) * 4;
  if (split_floats + (long)splits * n * batch * t > scratch_floats ||
      (tile_rows != 128 && tile_rows != 64) || splits < 1 || (splits > 1 && n % 4))
    return (int)cudaErrorInvalidValue;
  g.tc_scratch = scratch; g.tc_scratch_floats = split_floats; g.part = scratch + split_floats;
  if (!conv_gemm_tc_can(g)) return (int)cudaErrorInvalidValue;
  WeightSplits s;
  s.job[s.count++] = split_job(g, scratch);
  cudaError_t err = split_weights(s, stream);
  if (err != cudaSuccess) return (int)err;
  g.w_split = scratch;
  const bool bn128 = conv_gemm_tc_bn(n) == 128;
  if (tile_rows == 64)
    err = bn128 ? launch_conv_gemm_tc<128, 64>(g, scratch, splits, stream)
                : launch_conv_gemm_tc<64, 64>(g, scratch, splits, stream);
  else
    err = bn128 ? launch_conv_gemm_tc<128, 128>(g, scratch, splits, stream)
                : launch_conv_gemm_tc<64, 128>(g, scratch, splits, stream);
  return (int)err;
}

// out [batch * t, n] = the transposed conv sum_k a[t - off_k] W_k^T of the
// forward conv's w [taps * n, c_in] (the WN reverse walk's), on the tensor
// cores in `tile_rows`-row tiles (128 or 64), tap-staged or tap by tap,
// whatever the plan would take: for sweeping the walk's plan.  Scratch as
// gtt_tc_conv_gemm's.
extern "C" int gtt_tc_conv_gemm_walk(const float* a, const float* w, float* out, float* scratch,
                                     long long scratch_floats, int batch, int t, int c_in,
                                     int taps, int dilation, int n, int tile_rows, int tap_staged,
                                     cudaStream_t stream) {
  using namespace gtt;
  ConvGemm g;
  g.a = a; g.lda = c_in; g.c_in = c_in; g.taps = taps; g.dilation = dilation; g.tap_sign = -1;
  g.batch = batch; g.t = t; g.w = w; g.w_t = 1; g.n = n; g.epilogue = kBias; g.out = out;
  g.ldo = n;
  const long split_floats = ((2L * taps * c_in * n + 3) / 4) * 4;
  const int bn = conv_gemm_tc_bn(n);
  if (split_floats > scratch_floats || (tile_rows != 128 && tile_rows != 64) ||
      (tap_staged && (c_in % kTK || taps < kTapStages - 2 ||
                      conv_gemm_tap_smem(bn, tile_rows, taps, dilation) > kMaxBlockSmem)))
    return (int)cudaErrorInvalidValue;
  g.tc_scratch = scratch; g.tc_scratch_floats = split_floats;
  if (!conv_gemm_tc_can(g)) return (int)cudaErrorInvalidValue;
  WeightSplits s;
  s.job[s.count++] = split_job(g, scratch);
  cudaError_t err = split_weights(s, stream);
  if (err != cudaSuccess) return (int)err;
  g.w_split = scratch;
  if (tap_staged) {
    if (tile_rows == 64)
      return (int)(bn == 128 ? launch_conv_gemm_tap<128, 64>(g, scratch, stream)
                             : launch_conv_gemm_tap<64, 64>(g, scratch, stream));
    return (int)(bn == 128 ? launch_conv_gemm_tap<128, 128>(g, scratch, stream)
                           : launch_conv_gemm_tap<64, 128>(g, scratch, stream));
  }
  if (tile_rows == 64)
    return (int)(bn == 128 ? launch_conv_gemm_tc<128, 64>(g, scratch, 1, stream)
                           : launch_conv_gemm_tc<64, 64>(g, scratch, 1, stream));
  return (int)(bn == 128 ? launch_conv_gemm_tc<128, 128>(g, scratch, 1, stream)
                         : launch_conv_gemm_tc<64, 128>(g, scratch, 1, stream));
}

// out [taps * c_in, n] = im2col(a)^T @ dy: the bare weight gradient; with
// bias_out also the column sums of dy (times dy_mask) there, the weight
// gradient's bias row; with dy_t the tensor-core kernel reads dy's K-major
// split (big [n, ldt], small after it) instead of dy.
extern "C" int gtt_tc_wgrad(const float* a, const float* dy, const float* a_mask,
                            const float* dy_mask, float* out, float* bias_out, const float* dy_t,
                            float* scratch, int scratch_floats, int batch, int t, int c_in,
                            int lda, int taps, int dilation, int n, int ldy, int ldt, int mode,
                            cudaStream_t stream) {
  using namespace gtt;
  WGrad w;
  w.a = a; w.lda = lda; w.c_in = c_in; w.a_mask = a_mask; w.taps = taps; w.dilation = dilation;
  w.batch = batch; w.t = t; w.dy = dy; w.ldy = ldy; w.n = n; w.dy_mask = dy_mask;
  w.out = out; w.scratch = scratch; w.scratch_floats = scratch_floats; w.tc = mode != 2;
  w.bias_out = bias_out; w.dy_t = dy_t; w.ldt = ldt;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // mode 0: as the chains run it; 1: the tensor-core kernel (an error
  // where it cannot run); 2: CUDA cores
  if (mode != 1) return (int)wgrad(w, stream);
  if (!wgrad_tc_can(w)) return (int)cudaErrorInvalidValue;
  ++product_counts().tc_wgrad;
  return (int)wgrad_tc(w, sms, stream);
}

// big, small [n, kdim] = the K-major 3xTF32 split of w [kdim, n].
extern "C" int gtt_split_weights(const float* w, float* big, float* small, int kdim, int n,
                                 cudaStream_t stream) {
  gtt::WeightSplits s;
  gtt::WeightSplit& job = s.job[s.count++];
  job.w = w; job.ldb = n; job.kdim = kdim; job.n = n; job.c_in = kdim; job.big = big;
  job.small = small;
  return (int)gtt::split_weights(s, stream);
}

// counts [9] = tensor-core conv-GEMMs, tensor-core weight gradients,
// CUDA-core conv-GEMMs, CUDA-core weight gradients, of those last two the
// ones whose chain had asked for the tensor cores, and of the tensor-core
// ones the tap-staged conv-GEMMs, the weight gradients with a bias row and
// those reading dY's K-major split; `reset` zeroes them after the read.
extern "C" void gtt_product_counts(long long* counts, int reset) {
  gtt::ProductCounts& c = gtt::product_counts();
  counts[0] = c.tc_gemm; counts[1] = c.tc_wgrad; counts[2] = c.core_gemm;
  counts[3] = c.core_wgrad; counts[4] = c.declined_gemm; counts[5] = c.declined_wgrad;
  counts[6] = c.tap_staged_gemm; counts[7] = c.bias_wgrad; counts[8] = c.split_dy_wgrad;
  if (reset) c = gtt::ProductCounts();
}

// The weight splits tensor-core conv-GEMMs launched for themselves since
// the last reset; `reset` zeroes the count after the read.
extern "C" long long gtt_product_splits(int reset) {
  const long long n = gtt::product_splits();
  if (reset) gtt::product_splits() = 0;
  return n;
}
