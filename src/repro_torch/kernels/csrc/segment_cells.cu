// The Eq. 9 delta window of removing a candidate point, from the segment's
// endpoints to its cells on the target series (Def. 2), in one launch for
// every candidate of every lane.
//
// For candidate i of a lane (reconstruction x [n], alive neighbours prev,
// nxt [n] int32): p, q = prev[i], nxt[i] (a negative i wraps once, then
// every index is clamped, JAX's gather rule), start = p + 1, span = q - p -
// 1, and for j < W, with absj = clamp(start + j, 0, n - 1) and pc, qc the
// clamped endpoints,
//   t    = (absj - pc) / max(q - p, 1)                  (IEEE division)
//   term = (fma(x[qc] - x[pc], t, x[pc]) - x[absj]) * (j < span)
// which is the reference's segment_deltas (src/repro/core/aggregates.py:298)
// as strict XLA compiles it: the line's multiply-add rounded once (ROADMAP
// C19), every other operation rounded on its own, and the mask a multiply,
// so the terms past the span carry the reference's signed zeros.  At kappa
// 1 the terms are the output.  At kappa > 1 the window is summed onto the
// Wy = W / kappa + 2 cells from start / kappa on, as cell_sum.cu does
// (x_window_to_y, src/repro/kernels/ops.py:256): cell c adds the terms j
// with (start + j) / kappa - start / kappa == c left to right from +0 in
// the window's type and divides once by kappa, correctly rounded.  The
// outputs equal segment_cells.py's plain version (segment_deltas, then
// cell_sum_plain) bit for bit.
//
// Replaces no Pallas kernel: on the TPU path XLA fuses segment_deltas and
// the segment_sum.  In PyTorch the pair is ~94 dispatched operations a call
// (35 of them the FMA's emulation, ref.fma_rn) and a cell_sum launch; the
// rounds pay for it twice a round, the sequential mode twice a pop.
//
// Bound on the H100: a window reads its candidate, p and q, two endpoint
// values and its min(span, W) points, and writes W (kappa 1) or Wy cells
// and two ints; ~10 operations a term.  Bytes bound it, and at the main
// path's sizes (a few thousand windows of W <= 64) it sits at the launch
// floor.
//
// Design: a group of G lanes a window, 32 / G windows a warp (G a power of
// two, 4 to 32, about a quarter of W: 8 windows a warp at tier B's W = 8,
// two at tier C's W = 64), so a warp has several windows' chains of
// dependent loads in flight.  Lane 0 of a group loads the candidate, p and
// q and hands them to its group by __shfl_sync; then each lane forms terms
// j = g, g + G, ... from a coalesced run of x[absj], reading the two
// endpoint values beside them (one broadcast transaction, a level off the
// chain of dependent loads: candidate, neighbours, values).  At kappa 1 the
// lanes store their terms straight out.  At kappa > 1 the group stages its
// terms in shared memory, and after a barrier the block's (window, cell)
// pairs go to its first threads, a thread a cell chaining its at most
// kappa terms (<= 48 dependent adds): the chains then take a few warps'
// instructions, not every warp's with most lanes idle.  A block holds kWarps
// warps; the grid covers every window of every lane at once.  Index
// arithmetic is 32-bit (fewer than 2^31 windows a launch), the offsets of
// rows and windows 64-bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "rn.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__device__ __forceinline__ int clamp_i(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor division and modulus by k > 0
__device__ __forceinline__ int floor_div(int a, int k) {
  const int q = a / k;
  return (a % k != 0 && a < 0) ? q - 1 : q;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kWarps * 32)
    segment_cells_kernel(const T* __restrict__ x, const int* __restrict__ prev,
                         const int* __restrict__ nxt,
                         const I* __restrict__ cand, int64_t cand_stride,
                         T* __restrict__ cells, int* __restrict__ ystart,
                         int* __restrict__ span_out, T* __restrict__ xwin,
                         int* __restrict__ xstart, int windows, int K,
                         int n, int W, int Wy, int kappa, int log_g) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int G = 1 << log_g;
  const int g = lane & (G - 1);         // lane in its group
  const int slot = lane >> log_g;       // the group's window in the warp
  const int per_warp = 32 >> log_g;
  const int per_block = kWarps * per_warp;
  const int mine = threadIdx.x / 32 * per_warp + slot;  // window in block
  // at kappa > 1: the block's windows staged, then their starts
  T* const block_stage = reinterpret_cast<T*>(smem_raw);
  int* const block_start =
      reinterpret_cast<int*>(block_stage + per_block * W);
  T* const stage = block_stage + mine * W;
  // block-uniform loop: every thread takes part in each barrier
  for (int bbase = blockIdx.x * per_block; bbase < windows;
       bbase += gridDim.x * per_block) {
    const int w = bbase + mine;
    const bool live = w < windows;
    const int r = live ? w / K : 0;
    const int k = live ? w - r * K : 0;
    const T* xs = x + int64_t(r) * n;
    int p = 0, q = 0;
    if (live && g == 0) {
      int64_t i = static_cast<int64_t>(cand[r * cand_stride + k]);
      if (i < 0) i += n;
      const int ic = static_cast<int>(i < 0 ? 0 : (i > n - 1 ? n - 1 : i));
      p = prev[int64_t(r) * n + ic];
      q = nxt[int64_t(r) * n + ic];
    }
    p = __shfl_sync(kAll, p, 0, G);
    q = __shfl_sync(kAll, q, 0, G);
    const int start = p + 1;
    const int span = q - p - 1;
    const int pc = clamp_i(p, 0, n - 1);
    const bool staged = kappa > 1;
    if (live) {
      const T xp = xs[pc];
      const T xq = xs[clamp_i(q, 0, n - 1)];
      const T dq = rn::sub(xq, xp);
      const T qp = static_cast<T>(q - p);
      const T denom = qp > T(1) ? qp : T(1);
      T* out = staged ? stage : cells + int64_t(w) * W;
      for (int j = g; j < W; j += G) {
        const int absj = clamp_i(start + j, 0, n - 1);
        const T t = rn::quot(static_cast<T>(absj - pc), denom);
        const T m = j < span ? T(1) : T(0);
        const T term = rn::mul(rn::sub(fma_rn(dq, t, xp), xs[absj]), m);
        out[j] = term;
        if (staged && xwin != nullptr) xwin[int64_t(w) * W + j] = term;
      }
    }
    if (staged) {
      if (g == 0) block_start[mine] = start;
      __syncthreads();
      // the block's (window, cell) chains on its first threads, a thread a
      // cell, each from +0 left to right
      const T kap = static_cast<T>(kappa);
      for (int task = threadIdx.x; task < per_block * Wy;
           task += kWarps * 32) {
        const int s = task / Wy;
        const int c = task - s * Wy;
        if (bbase + s >= windows) break;
        const int st = block_start[s];
        const int j0 = c * kappa - (st - floor_div(st, kappa) * kappa);
        const int j1 = min(j0 + kappa, W);
        const T* row = block_stage + s * W;
        T acc = T(0);
        for (int j = max(j0, 0); j < j1; ++j) acc = rn::add(acc, row[j]);
        cells[int64_t(bbase + s) * Wy + c] = rn::quot(acc, kap);
      }
      __syncthreads();
    }
    if (live && g == 0) {
      ystart[w] = staged ? floor_div(start, kappa) : start;
      span_out[w] = span;
      if (xstart != nullptr) xstart[w] = start;
    }
  }
}

// log2 of the lanes a window: a power of two near W / 4, 4 to 32
inline int group_log(int W) {
  int lg = 2;
  while (lg < 5 && (4 << lg) < W) ++lg;
  return lg;
}

template <typename T, typename I>
int launch(const void* x, const void* prev, const void* nxt, const void* cand,
           void* cells, void* ystart, void* span, void* xwin, void* xstart,
           int rows, int K, int cand_stride, int n, int W, int kappa,
           void* stream) {
  const int64_t all = int64_t(rows) * K;
  if (all == 0) return 0;
  if (all > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int windows = static_cast<int>(all);
  const int Wy = kappa > 1 ? W / kappa + 2 : W;
  const int log_g = group_log(W);
  const int per_block = kWarps * (32 >> log_g);
  const size_t smem =
      kappa > 1 ? size_t(per_block) * (W * sizeof(T) + sizeof(int)) : 0;
  auto kernel = segment_cells_kernel<T, I>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int want = (windows + per_block - 1) / per_block;
  const int grid = want < 65535 * 16 ? want : 65535 * 16;
  kernel<<<grid, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(prev),
      static_cast<const int*>(nxt), static_cast<const I*>(cand), cand_stride,
      static_cast<T*>(cells), static_cast<int*>(ystart),
      static_cast<int*>(span), static_cast<T*>(xwin),
      static_cast<int*>(xstart), windows, K, n, W, Wy, kappa, log_g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x, prev, nxt [rows, n] contiguous (prev, nxt int32); cand [rows, K], row
// stride cand_stride (0: one row for every lane), int32 (_i32) or int64
// (_i64); cells [rows, K, Wy], ystart and span [rows, K] int32; xwin
// [rows, K, W] and xstart [rows, K] (null, or at kappa > 1 the x-space
// window and its start).
#define SEGMENT_CELLS(NAME, T, I)                                             \
  int NAME(const void* x, const void* prev, const void* nxt,                  \
           const void* cand, void* cells, void* ystart, void* span,          \
           void* xwin, void* xstart, int rows, int K, int cand_stride, int n, \
           int W, int kappa, void* stream) {                                  \
    return launch<T, I>(x, prev, nxt, cand, cells, ystart, span, xwin,        \
                        xstart, rows, K, cand_stride, n, W, kappa, stream);   \
  }

SEGMENT_CELLS(segment_cells_f64_i32, double, int32_t)
SEGMENT_CELLS(segment_cells_f64_i64, double, int64_t)
SEGMENT_CELLS(segment_cells_f32_i32, float, int32_t)
SEGMENT_CELLS(segment_cells_f32_i64, float, int64_t)

#undef SEGMENT_CELLS

}  // extern "C"
