// Eq. 8 (Algorithm 2) single-delta impacts with the deviation measure
// reduced in-register: out[p] = D(ACF after adding dval[p] at y[p / kappa],
// p0), for every candidate p.
//
// Replaces the TPU kernel src/repro/kernels/acf_impact.py:acf_impact_pallas
// (body acf_impact_kernel), generalised to a runtime valid length ny (read
// from a device scalar, so the round loop needs no host sync) and to the
// x-to-y index map yi = p / kappa of Def. 2.  This is the per-round
// single_impacts pass of the rounds mode (src/repro/core/cameo.py:336-344).
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

namespace {

constexpr int THREADS = 256;

__global__ void acf_impact_kernel(const float* __restrict__ y,
                                  const float* __restrict__ dval,
                                  const float* __restrict__ table,
                                  const float* __restrict__ p0,
                                  const int* __restrict__ ny_ptr,
                                  float* __restrict__ out, int P, int nyb,
                                  int L, int kappa, int measure) {
  extern __shared__ float sm[];  // table [5, L] then p0 [L]
  for (int i = threadIdx.x; i < 6 * L; i += blockDim.x)
    sm[i] = i < 5 * L ? table[i] : p0[i - 5 * L];
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int ny = *ny_ptr;
  const int yi = p / kappa;
  const float d = dval[p];
  const float yat = y[yi];
  // Every product is rounded on its own (__fmul_rn, never contracted into
  // a fused multiply-add) and every sum runs in the plain version's order,
  // so the impacts equal the plain PyTorch version's bit for bit.
  const float e = __fmul_rn(d, 2.0f * yat + d);
  const float tiny = 1e-30f;
  float acc = 0.0f;
  for (int l = 1; l <= L; ++l) {
    const float head = yi <= ny - 1 - l ? 1.0f : 0.0f;
    const float tail = yi >= l ? 1.0f : 0.0f;
    const float yf = yi + l < nyb ? y[yi + l] : 0.0f;   // zero past the bucket
    const float yb = yi - l >= 0 ? y[yi - l] : 0.0f;
    const float sx = sm[l - 1] + __fmul_rn(d, head);
    const float sxl = sm[L + l - 1] + __fmul_rn(d, tail);
    const float sx2 = sm[2 * L + l - 1] + __fmul_rn(e, head);
    const float sxl2 = sm[3 * L + l - 1] + __fmul_rn(e, tail);
    const float inner = __fmul_rn(yf, head) + __fmul_rn(yb, tail);
    const float sxx = sm[4 * L + l - 1] + __fmul_rn(d, inner);
    const float m = static_cast<float>(ny - l);
    const float num = __fmul_rn(m, sxx) - __fmul_rn(sx, sxl);
    const float den2 = __fmul_rn(__fmul_rn(m, sx2) - __fmul_rn(sx, sx),
                                 __fmul_rn(m, sxl2) - __fmul_rn(sxl, sxl));
    const float rho = den2 > tiny ? num / sqrtf(fmaxf(den2, tiny)) : 0.0f;
    const float diff = rho - sm[5 * L + l - 1];
    if (measure == 0) {
      acc += fabsf(diff);
    } else if (measure == 1) {
      acc += __fmul_rn(diff, diff);
    } else {
      acc = fmaxf(acc, fabsf(diff));
    }
  }
  const float fl = static_cast<float>(L);
  out[p] = measure == 0 ? acc / fl : (measure == 1 ? sqrtf(acc / fl) : acc);
}

}  // namespace

extern "C" int acf_impact_f32(const void* y, const void* dval,
                              const void* table, const void* p0,
                              const void* ny, void* out, int P, int nyb,
                              int L, int kappa, int measure, void* stream) {
  const int blocks = (P + THREADS - 1) / THREADS;
  const size_t smem = 6 * L * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        acf_impact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  acf_impact_kernel<<<blocks, THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(dval),
      static_cast<const float*>(table), static_cast<const float*>(p0),
      static_cast<const int*>(ny), static_cast<float*>(out), P, nyb, L, kappa,
      measure);
  return static_cast<int>(cudaGetLastError());
}
