// Exact Eq. 9 impacts of P independent windowed deltas: for candidate p,
// the delta window d[p, :W] applied at global positions starts[p] + j to a
// series of static valid length ny, whose context row is
// ctx[p, k] = y[starts[p] - L + k] (k < W + 2L, zero out of range); out[p]
// is the deviation (0 mae, 1 rmse, 2 cheb) of the hypothetical ACF row [L]
// from p0.
//
// Replaces the TPU kernel src/repro/kernels/acf_window_impact.py:
// acf_window_impact_pallas (body acf_window_impact_kernel), which blocked
// the candidates along a sequential grid with a [B, W + 2L] context tile in
// VMEM and looped the lags.  It serves the sequential mode's ReHeap
// (ops.window_impact_at: P = 2(h + 1), float64) and the chunks of
// ops.ranking_impact(rank="window") (P = impact_chunk).  Its plain version
// is ref.acf_window_impact_ref (ref._window_delta_acf followed by
// ref.measure_rows), whose index rules it follows: the head/tail masks
// test the global position starts[p] + j against ny, and d[j + l] is zero
// past the window.  The Pallas body multiplies by rsqrt; this kernel and
// its plain version divide by sqrt.
//
// Bound on the H100: the function needs per (candidate, lag) ~4 W + 22
// flops (the masks select a prefix and a suffix of the window, as
// window_rows.cu forms them) and 5 W per candidate, against (2W + 2L + 2)
// values read per candidate, so in float64 it is bound by bytes; at the
// ReHeap's P = 50, W = 64, L = 48 that is ~0.03 us, so the launch
// dominates (PERF.md has the card's numbers).  This kernel forms the masks
// as 0/1 products, ~15 W flops per (candidate, lag).
// Design (as window_rows.cu): one block per candidate stages its context,
// its deltas and e = d (2 y + d) in shared memory; one thread per lag forms
// the five masked sums over the window, first to last (rn::window_sums,
// shared with prefix_devs.cu), and the Eq. 2 entry;
// one thread reduces the row against p0, lags in order.  Every product and
// sum is rounded on its own (rn.cuh), so the output equals the plain
// version bit for bit.  Templated on float and double: the sequential mode
// ranks in the config's float64.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

template <typename T>
__global__ void acf_window_impact_kernel(const T* __restrict__ ctx_g,
                                         const T* __restrict__ d_g,
                                         const int* __restrict__ starts,
                                         const T* __restrict__ table,
                                         const T* __restrict__ p0,
                                         T* __restrict__ out, int W, int L,
                                         int ny, int measure) {
  extern __shared__ unsigned char sm_raw[];
  T* ctx = reinterpret_cast<T*>(sm_raw);   // [W + 2L]
  T* d = ctx + W + 2 * L;                  // [W]
  T* e = d + W;                            // [W]
  T* row = e + W;                          // [L]
  const int p = blockIdx.x;
  const int C = W + 2 * L;
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    ctx[i] = ctx_g[static_cast<size_t>(p) * C + i];
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    d[i] = d_g[static_cast<size_t>(p) * W + i];
  __syncthreads();
  for (int i = threadIdx.x; i < W; i += blockDim.x)
    e[i] = rn::mul(d[i], rn::add(static_cast<T>(2) * ctx[L + i], d[i]));
  __syncthreads();
  const int s = starts[p];
  for (int l = 1 + threadIdx.x; l <= L; l += blockDim.x) {
    T a[5];
    rn::window_sums(ctx + L, d, e, W, s, l, ny, a);
    row[l - 1] = rn::acf_rho(
        rn::add(table[l - 1], a[0]), rn::add(table[L + l - 1], a[1]),
        rn::add(table[2 * L + l - 1], a[2]),
        rn::add(table[3 * L + l - 1], a[3]),
        rn::add(table[4 * L + l - 1], a[4]), static_cast<T>(ny - l));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = 0;
    for (int l = 0; l < L; ++l)
      acc = rn::measure_step(measure, acc, rn::sub(row[l], p0[l]));
    out[p] = rn::measure_final(measure, acc, L);
  }
}

template <typename T>
int launch(const void* ctx, const void* dwins, const void* starts,
           const void* table, const void* p0, void* out, int P, int W, int L,
           int ny, int measure, void* stream) {
  int threads = ((L + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = (3 * W + 3 * L) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        acf_window_impact_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  acf_window_impact_kernel<T><<<P, threads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(dwins),
      static_cast<const int*>(starts), static_cast<const T*>(table),
      static_cast<const T*>(p0), static_cast<T*>(out), W, L, ny, measure);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out is [P] impacts against p0.
extern "C" int acf_window_impact_f32(const void* ctx, const void* dwins,
                                     const void* starts, const void* table,
                                     const void* p0, void* out, int P, int W,
                                     int L, int ny, int measure,
                                     void* stream) {
  return launch<float>(ctx, dwins, starts, table, p0, out, P, W, L, ny,
                       measure, stream);
}

extern "C" int acf_window_impact_f64(const void* ctx, const void* dwins,
                                     const void* starts, const void* table,
                                     const void* p0, void* out, int P, int W,
                                     int L, int ny, int measure,
                                     void* stream) {
  return launch<double>(ctx, dwins, starts, table, p0, out, P, W, L, ny,
                        measure, stream);
}
