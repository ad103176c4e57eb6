// The Eq. 9 aggregate map of a delta window (Def. 2): each x-space window
// x [W] starting at `start` is summed onto the Wy = W / kappa + 2 y cells it
// covers, cell c taking the terms j with (start + j) / kappa - start / kappa
// == c, and each cell's sum is divided by kappa.  A cell adds its terms left
// to right from +0 in the window's type and divides once, correctly
// rounded: the order of XLA's segment_sum, which the JAX reference uses
// (jax.ops.segment_sum in src/repro/kernels/ops.py:256 x_window_to_y), so
// the cells equal the reference's bit for bit.  Skipping a cell's terms
// outside [0, W) is adding +0 to a running sum that is never -0, which
// leaves it as it is; a cell with no term is +0 / kappa = +0.
// cell_sum.py's plain version computes the same order with PyTorch ops: one
// gather into [..., Wy, kappa] and kappa vectorised adds.
//
// Replaces no Pallas kernel: on the TPU path XLA computes this
// segment_sum.  It exists because the plain version is kappa launches on
// the card (48 at aus_elec), 2-3 calls a round, on a host-bound loop.
//
// Bound on the H100: the function reads W values and a start and writes Wy
// values a window, about W + 1 operations a window, so it is bound by
// bytes; at the main path's sizes (a few thousand windows of W <= 64) it
// sits at the launch floor.
//
// Design: one thread per (window, cell), chaining the cell's at most kappa
// terms; neighbouring threads take neighbouring cells of one window, so a
// warp's loads fall in the few cache lines that window spans.  Any number
// of windows (every leading axis, lanes included, flattened by the
// wrapper) in one launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    cell_sum_kernel(const T* __restrict__ x, const int* __restrict__ start,
                    T* __restrict__ out, int64_t cells, int W, int Wy,
                    int kappa) {
  for (int64_t i = blockIdx.x * int64_t(THREADS) + threadIdx.x; i < cells;
       i += int64_t(gridDim.x) * THREADS) {
    const int64_t r = i / Wy;
    const int c = static_cast<int>(i - r * Wy);
    const int s = start[r];
    // floor modulus: the window's offset inside its first cell
    const int off = ((s % kappa) + kappa) % kappa;
    const T* row = x + r * W;
    int j0 = c * kappa - off;
    int j1 = j0 + kappa;
    j0 = j0 < 0 ? 0 : j0;
    j1 = j1 > W ? W : j1;
    T acc = T(0);
    for (int j = j0; j < j1; ++j) acc = acc + row[j];
    out[i] = div_rn(acc, static_cast<T>(kappa));
  }
}

template <typename T>
int launch(const void* x, const void* start, void* out, int rows, int W,
           int Wy, int kappa, void* stream) {
  const int64_t cells = int64_t(rows) * Wy;
  if (cells == 0) return 0;
  const int64_t want = (cells + THREADS - 1) / THREADS;
  const int grid = static_cast<int>(want < 65535 * 16 ? want : 65535 * 16);
  cell_sum_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(start),
      static_cast<T*>(out), cells, W, Wy, kappa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [rows, W] and out [rows, Wy] contiguous, start [rows] int32.
int cell_sum_f64(const void* x, const void* start, void* out, int rows, int W,
                 int Wy, int kappa, void* stream) {
  return launch<double>(x, start, out, rows, W, Wy, kappa, stream);
}

int cell_sum_f32(const void* x, const void* start, void* out, int rows, int W,
                 int Wy, int kappa, void* stream) {
  return launch<float>(x, start, out, rows, W, Wy, kappa, stream);
}

}  // extern "C"
