// The prefix walk of one scan round: K rank-ordered candidate deltas
// d_k = dyws[k, :Wy] * ok[k] at s_k = clip(ystarts[k], 0, nyb - 1) on the
// zero-padded target series y (valid length ny, a device scalar), taken in
// order against the running reconstruction z and the running moment table.
// out[k] is candidate k's trial deviation from p0 (0 mae, 1 rmse, 2 cheb)
// on top of what was committed before it; then the candidate commits to z
// and to the table: always (greedy = 0, the prefix deviation curve) or only
// where ok[k] and out[k] <= eps (greedy = 1, the scan mode's selection).
//
// Replaces the TPU kernel src/repro/kernels/fused_round.py:
// prefix_devs_pallas (body _prefix_scan_kernel), one grid step holding z in
// VMEM scratch.  Its plain version is fused_round.prefix_devs_plain, whose
// index rules it follows: the head/tail masks test s_k + j against ny,
// z[i] = y[i - L] (zero outside [0, nyb)), d[j + l] is zero past the window.
//
// Bound on the H100: the function needs per (candidate, lag) ~4 Wy + 22
// flops and ~6 Wy per candidate with the commit of z, against ~(Wy + 2)
// values read per candidate (uk_elec K = 1,843, Wy = 64, L = 48: ~25 MFLOP,
// under a microsecond at the FP64 rate).  But the walk is sequential in
// k — each trial reads the z and table the previous commit wrote — so the
// kernel is bound by the latency of K dependent steps on one SM, not by
// the card's rate (PERF.md has the card's numbers).
// Design: one block walks the K candidates.  z (nyb + 2L + Wy values) sits
// in dynamic shared memory while it fits the block's 227 KB (the launcher
// raises the 48 KB default), else in a global scratch buffer on the same
// code path.  Per candidate: the block stages d and e = d (2 z + d); one
// thread per lag forms the five masked sums over the window, first to last
// (rn::window_sums, shared with acf_window_impact.cu), and its Eq. 2
// entry; one thread reduces the lags in order and decides the
// commit; the block adds gate * d into z and keeps the trial table where
// the candidate commits.  Every product and sum is rounded on its own
// (rn.cuh), so the output equals the plain version bit for bit.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

template <typename T>
__global__ void prefix_devs_kernel(const T* __restrict__ y,
                                   const T* __restrict__ dyws,
                                   const int* __restrict__ ystarts,
                                   const unsigned char* __restrict__ ok,
                                   const T* __restrict__ table,
                                   const T* __restrict__ p0,
                                   const int* __restrict__ ny_ptr,
                                   const T* __restrict__ eps_ptr,
                                   T* __restrict__ out, T* __restrict__ zg,
                                   int K, int Wy, int nyb, int L, int measure,
                                   int greedy, int use_smem) {
  extern __shared__ unsigned char sm_raw[];
  T* agg = reinterpret_cast<T*>(sm_raw);   // [5, L] committed table
  T* trial = agg + 5 * L;                  // [5, L]
  T* d = trial + 5 * L;                    // [Wy]
  T* e = d + Wy;                           // [Wy]
  T* diff = e + Wy;                        // [L] rho - p0
  T* z = use_smem ? diff + L : zg;         // [nyb + 2L + Wy]
  __shared__ int take_s;
  const int zlen = nyb + 2 * L + Wy;
  for (int i = threadIdx.x; i < zlen; i += blockDim.x)
    z[i] = (i >= L && i < L + nyb) ? y[i - L] : static_cast<T>(0);
  for (int i = threadIdx.x; i < 5 * L; i += blockDim.x) agg[i] = table[i];
  const int ny = *ny_ptr;
  const T eps = *eps_ptr;
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const int s = min(max(ystarts[k], 0), nyb - 1);
    const T okk = ok[k] ? static_cast<T>(1) : static_cast<T>(0);
    for (int i = threadIdx.x; i < Wy; i += blockDim.x) {
      const T dk = rn::mul(dyws[static_cast<size_t>(k) * Wy + i], okk);
      d[i] = dk;
      e[i] = rn::mul(dk, rn::add(static_cast<T>(2) * z[s + L + i], dk));
    }
    __syncthreads();
    for (int l = 1 + threadIdx.x; l <= L; l += blockDim.x) {
      T a[5];
      rn::window_sums(z + s + L, d, e, Wy, s, l, ny, a);
      const int c = l - 1;
      const T sx = rn::add(agg[c], a[0]), sxl = rn::add(agg[L + c], a[1]);
      const T sx2 = rn::add(agg[2 * L + c], a[2]);
      const T sxl2 = rn::add(agg[3 * L + c], a[3]);
      const T sxx = rn::add(agg[4 * L + c], a[4]);
      trial[c] = sx; trial[L + c] = sxl; trial[2 * L + c] = sx2;
      trial[3 * L + c] = sxl2; trial[4 * L + c] = sxx;
      diff[c] = rn::sub(rn::acf_rho(sx, sxl, sx2, sxl2, sxx,
                                    static_cast<T>(ny - l)), p0[c]);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      T acc = 0;
      for (int l = 0; l < L; ++l) acc = rn::measure_step(measure, acc, diff[l]);
      const T dev = rn::measure_final(measure, acc, L);
      out[k] = dev;
      take_s = greedy ? (ok[k] && dev <= eps) : 1;
    }
    __syncthreads();
    const T gate = take_s ? static_cast<T>(1) : static_cast<T>(0);
    for (int i = threadIdx.x; i < Wy; i += blockDim.x)
      z[s + L + i] = rn::add(z[s + L + i], rn::mul(gate, d[i]));
    if (take_s)
      for (int i = threadIdx.x; i < 5 * L; i += blockDim.x) agg[i] = trial[i];
    __syncthreads();
  }
}

template <typename T>
int launch(const void* y, const void* dyws, const void* ystarts,
           const void* ok, const void* table, const void* p0, const void* ny,
           const void* eps, void* out, void* scratch, int K, int Wy, int nyb,
           int L, int measure, int greedy, int use_smem, void* stream) {
  int threads = ((max(L, Wy) + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  size_t smem = (11 * L + 2 * Wy) * sizeof(T);
  if (use_smem) smem += (nyb + 2 * L + Wy) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        prefix_devs_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  prefix_devs_kernel<T><<<1, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(dyws),
      static_cast<const int*>(ystarts),
      static_cast<const unsigned char*>(ok), static_cast<const T*>(table),
      static_cast<const T*>(p0), static_cast<const int*>(ny),
      static_cast<const T*>(eps), static_cast<T*>(out),
      static_cast<T*>(scratch), K, Wy, nyb, L, measure, greedy, use_smem);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out is [K] trial deviations; scratch holds z when use_smem is 0.
extern "C" int prefix_devs_f32(const void* y, const void* dyws,
                               const void* ystarts, const void* ok,
                               const void* table, const void* p0,
                               const void* ny, const void* eps, void* out,
                               void* scratch, int K, int Wy, int nyb, int L,
                               int measure, int greedy, int use_smem,
                               void* stream) {
  return launch<float>(y, dyws, ystarts, ok, table, p0, ny, eps, out, scratch,
                       K, Wy, nyb, L, measure, greedy, use_smem, stream);
}

extern "C" int prefix_devs_f64(const void* y, const void* dyws,
                               const void* ystarts, const void* ok,
                               const void* table, const void* p0,
                               const void* ny, const void* eps, void* out,
                               void* scratch, int K, int Wy, int nyb, int L,
                               int measure, int greedy, int use_smem,
                               void* stream) {
  return launch<double>(y, dyws, ystarts, ok, table, p0, ny, eps, out,
                        scratch, K, Wy, nyb, L, measure, greedy, use_smem,
                        stream);
}
