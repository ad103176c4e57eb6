// Eq. 8 (Algorithm 2) single-delta impacts with the deviation measure
// reduced in-register: out[p] = D(ACF after adding dval[p] at y[p / kappa],
// p0), for every candidate p.
//
// Replaces the TPU kernel src/repro/kernels/acf_impact.py:acf_impact_pallas
// (body acf_impact_kernel), generalised to a runtime valid length ny (read
// from a device scalar, so the round loop needs no host sync) and to the
// x-to-y index map yi = p / kappa of Def. 2.  It serves the per-round
// single_impacts pass of the rounds mode in float (src/repro/core/
// cameo.py:336-344) and the sequential mode's init_impacts in double
// (cameo.py:828-834, the config's dtype), so it is one template for both.
//
// Bound on the H100: ~30 flops per (candidate, lag) against 12 bytes read
// and written per candidate, so the work is bound by operations (P = 18,432,
// L = 48: 27 MFLOP against 0.2 MB), and at this size by the launch
// (PERF.md has the card's numbers).  Design: one thread per candidate; the
// [5, L] moment table and p0
// sit in shared memory; the lag loop reads y[yi +- l] straight from global
// memory, where neighbouring threads read neighbouring addresses (kappa = 1)
// or the same one (kappa > 1).  The measure (0 mae, 1 rmse, 2 cheb) is
// reduced in a register and only [P] is written.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void acf_impact_kernel(const T* __restrict__ y,
                                  const T* __restrict__ dval,
                                  const T* __restrict__ table,
                                  const T* __restrict__ p0,
                                  const int* __restrict__ ny_ptr,
                                  T* __restrict__ out, int P, int nyb, int L,
                                  int kappa, int measure) {
  extern __shared__ unsigned char sm_raw[];
  T* sm = reinterpret_cast<T*>(sm_raw);  // table [5, L] then p0 [L]
  for (int i = threadIdx.x; i < 6 * L; i += blockDim.x)
    sm[i] = i < 5 * L ? table[i] : p0[i - 5 * L];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int ny = *ny_ptr;
  const int yi = p / kappa;
  const T d = dval[p];
  const T yat = y[yi];
  // Every product is rounded on its own (rn.cuh, never contracted into a
  // fused multiply-add) and every sum runs in the plain version's order,
  // so the impacts equal the plain PyTorch version's bit for bit.
  const T e = rn::mul(d, rn::add(static_cast<T>(2) * yat, d));
  T acc = 0;
  for (int l = 1; l <= L; ++l) {
    const T head = yi <= ny - 1 - l ? 1 : 0;
    const T tail = yi >= l ? 1 : 0;
    const T yf = yi + l < nyb ? y[yi + l] : 0;   // zero past the bucket
    const T yb = yi - l >= 0 ? y[yi - l] : 0;
    const T sx = rn::add(sm[l - 1], rn::mul(d, head));
    const T sxl = rn::add(sm[L + l - 1], rn::mul(d, tail));
    const T sx2 = rn::add(sm[2 * L + l - 1], rn::mul(e, head));
    const T sxl2 = rn::add(sm[3 * L + l - 1], rn::mul(e, tail));
    const T inner = rn::add(rn::mul(yf, head), rn::mul(yb, tail));
    const T sxx = rn::add(sm[4 * L + l - 1], rn::mul(d, inner));
    const T rho = rn::acf_rho(sx, sxl, sx2, sxl2, sxx,
                              static_cast<T>(ny - l));
    acc = rn::measure_step(measure, acc, rn::sub(rho, sm[5 * L + l - 1]));
  }
  out[p] = rn::measure_final(measure, acc, L);
}

template <typename T>
int launch(const void* y, const void* dval, const void* table, const void* p0,
           const void* ny, void* out, int P, int nyb, int L, int kappa,
           int measure, void* stream) {
  const int blocks = (P + THREADS - 1) / THREADS;
  const size_t smem = 6 * L * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        acf_impact_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  acf_impact_kernel<T><<<blocks, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(dval),
      static_cast<const T*>(table), static_cast<const T*>(p0),
      static_cast<const int*>(ny), static_cast<T*>(out), P, nyb, L, kappa,
      measure);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int acf_impact_f32(const void* y, const void* dval,
                              const void* table, const void* p0,
                              const void* ny, void* out, int P, int nyb,
                              int L, int kappa, int measure, void* stream) {
  return launch<float>(y, dval, table, p0, ny, out, P, nyb, L, kappa, measure,
                       stream);
}

extern "C" int acf_impact_f64(const void* y, const void* dval,
                              const void* table, const void* p0,
                              const void* ny, void* out, int P, int nyb,
                              int L, int kappa, int measure, void* stream) {
  return launch<double>(y, dval, table, p0, ny, out, P, nyb, L, kappa,
                        measure, stream);
}
