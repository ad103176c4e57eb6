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
// ReHeap's P = 50, W = 64, L = 48 that is ~0.03 us, so a launch's latency
// dominates: one candidate's dependent chain (its staging round trip, a
// W-term sum, Eq. 2, an L-term reduction) sets the time (PERF.md has the
// card's numbers).
//
// Design (shared with window_rows.cu through window.cuh):
// - Packing.  One thread per lag, G threads per candidate: at L <= 32 a
//   warp holds floor(32 / L) candidates (aus_elec's L = 7: 4, 28 busy
//   lanes); at L > 32 a candidate takes ceil(L / 32) warps.  Small
//   launches take one SM per candidate, large ones fill blocks of up to
//   256 threads.
// - One staging pass.  Each lane issues its start, its lag's table column
//   and p0 entry up front, then copies its share of the context row; the
//   lane that copies c[i] inside the window also copies d[i] and forms
//   e[i] = d (2 c + d).  d is padded with L zeros, so d[j + l] needs no
//   test.  One barrier follows: __syncwarp at L <= 32, __syncthreads past.
// - Interior fast path.  Where s >= L and s + W - 1 <= ny - 1 - L every
//   head and tail mask of the window is 1 for every lag, and a product by
//   1 is exact: the masked sums equal the unmasked ones bit for bit.  The
//   lane forms sum d and sum e (lag-free: one warp instruction serves
//   every lag the warp holds) beside its lag's bilinear chain
//   sum_j d[j] ((c[j + l] + d[j + l]) + c[j - l]), each first to last from
//   +0, eight terms at a time, the next eight loaded while these are added
//   (win::interior_sums).
// - Boundary windows (any other) take the five masked sums, chained from
//   +0 over rn::window_term<true>: the real ReHeap meets them only near the
//   series' ends (PERF.md counts them over the main-path runs).
// - Order.  The plain version is the reference's one contraction
//   einsum("paw,pawl->pal") with the basis (y_fwd + d_fwd) head + y_bwd
//   tail; XLA sums a contraction over the window one product at a time
//   from +0, and the kernel does the same, with that association.
// - Reduction.  Each lane stores its lag's measure term; after one more
//   barrier the candidate's first lane reduces them: cheb their max, mae
//   and rmse by rn::row_sum, XLA's row-reduce order (win::reduce_lags).
// Every product and sum is rounded on its own (rn.cuh), so the output
// equals the plain version bit for bit.  Templated on float and double:
// the sequential mode ranks in the config's float64.
#include <cuda_runtime.h>

#include "rn.cuh"
#include "window.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(win::kBlock)
acf_window_impact_kernel(const T* __restrict__ ctx_g,
                         const T* __restrict__ d_g,
                         const int* __restrict__ starts,
                         const T* __restrict__ table,
                         const T* __restrict__ p0, T* __restrict__ out,
                         int P, int W, int L, int ny, int measure, int G,
                         int cpu, int cpb, int M) {
  extern __shared__ unsigned char sm_raw[];
  const win::Slot sl = win::slot(L, G, cpu, M);
  const int p = blockIdx.x * cpb + sl.cand;
  const bool live = sl.active && p < P;
  const int C = W + 2 * L;
  // per candidate: ctx [C], d [W + L] (zeros past W), e [W], row [L]
  T* ctx = reinterpret_cast<T*>(sm_raw) + sl.cand * (3 * W + 4 * L);
  T* d = ctx + C;
  T* e = d + W + L;
  T* row = e + W;
  const int l0 = sl.r + 1;

  int s = 0;
  T tab[5] = {0, 0, 0, 0, 0}, pz = 0;
  auto lag_loads = [&](int l) {
    for (int q = 0; q < 5; ++q) tab[q] = table[q * L + l - 1];
    pz = p0[l - 1];
  };
  if (live) {
    s = starts[p];
    if (l0 <= L) lag_loads(l0);
    const T* cg = ctx_g + static_cast<size_t>(p) * C;
    const T* dg = d_g + static_cast<size_t>(p) * W;
    win::stage(sl.r, G, C, L, W, ctx, d, e, [&](int i) { return cg[i]; },
               [&](int j) { return dg[j]; });
  }
  if (L <= 32) __syncwarp(); else __syncthreads();

  const bool interior = live && s >= L && s + W - 1 <= ny - 1 - L;
  const T* c = ctx + L;
  // The boundary sums and Eq. 2 stay lambdas: the same arithmetic written
  // inline in the loop compiled 11% slower on the card (PERF.md section 6).
  auto boundary = [&](int l, T a[5]) {
    rn::chain_n<T, 5>(
        [&](int j, T v[5]) {
          rn::window_term<true>(c, d, e, W, s, j, l, ny, v);
        },
        0, W, a);
  };
  auto finish = [&](int l, const T a[5]) {
    const T rho = rn::acf_rho(
        rn::add(tab[0], a[0]), rn::add(tab[1], a[1]), rn::add(tab[2], a[2]),
        rn::add(tab[3], a[3]), rn::add(tab[4], a[4]), static_cast<T>(ny - l));
    const T t = rn::measure_term(measure, rn::sub(rho, pz));
    row[l - 1] = t;
  };
  if (live) {
    for (int l = l0; l <= L; l += G) {
      if (l != l0) lag_loads(l);
      T a[5];
      if (interior) {
        win::interior_sums(c, d, e, W, l, a[0], a[2], a[4]);
        a[1] = a[0];
        a[3] = a[2];
      } else {
        boundary(l, a);
      }
      finish(l, a);
    }
  }
  win::lag_barrier(L);
  const T acc = win::reduce_lags(measure, L, sl.active && sl.r == 0,
                                   row);
  if (live && sl.r == 0) out[p] = rn::measure_final(measure, acc, L);
}

template <typename T>
int launch(const void* ctx, const void* dwins, const void* starts,
           const void* table, const void* p0, void* out, int P, int W, int L,
           int ny, int measure, void* stream) {
  win::Plan pl;
  cudaError_t err = win::plan(P, L, (3 * W + 4 * L) * sizeof(T), &pl);
  if (err == cudaSuccess)
    err = win::allow_smem(acf_window_impact_kernel<T>, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  acf_window_impact_kernel<T><<<pl.blocks, pl.threads, pl.smem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ctx), static_cast<const T*>(dwins),
      static_cast<const int*>(starts), static_cast<const T*>(table),
      static_cast<const T*>(p0), static_cast<T*>(out), P, W, L, ny, measure,
      pl.G, pl.cpu, pl.cpb, pl.M);
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
