// Eq. 9 tier ranking: for each of K candidate delta windows d[k, :Wy]
// starting at ystarts[k] on the zero-padded target series y (valid length
// ny, a device scalar), the hypothetical ACF row [L] after that delta alone,
// reduced to its deviation from p0 (measure 0 mae, 1 rmse, 2 cheb): out[K].
//
// Replaces the TPU kernel src/repro/kernels/fused_round.py:window_rows_pallas
// (body _window_rows_kernel), which walked the K candidates in order on one
// core with the padded series in VMEM and wrote the rows; the rounds mode
// reduces them with ref.measure_rows, which this kernel does in place.  Its
// plain version is fused_round.window_acf_rows (mask-free, padded-bucket
// form) followed by ref.measure_rows, whose index rules this kernel follows:
// the context is gathered at the start clipped into [0, nyb)
// (fused_round.py:149-151), the head/tail cuts use the unclipped start, and
// the bilinear term needs no mask because y is zero outside [0, ny).
//
// Bound on the H100: per (candidate, lag) the function needs ~4 Wy + 24
// flops (the bilinear sum, then the five moments, Eq. 2 and the measure)
// against (Wy + 1) * 4 bytes per candidate, so it is bound by operations;
// at the main-path sizes (K = 768 x Wy 8, K = 384 x Wy 64, L = 48) that is
// a few MFLOP, well under a microsecond, so the launch dominates (PERF.md
// has the card's numbers).
// Design: one block per candidate stages its Wy + 2L context, its Wy deltas
// and e = d (2 z + d) in shared memory; one thread per lag forms the five
// masked sums and the Eq. 2 row with tiny = 1e-30 (fused_round.py:236);
// one thread then reduces the row against p0, lags in order.  Candidates
// are independent, so blocks share nothing.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

__global__ void window_rows_kernel(const float* __restrict__ dyws,
                                   const int* __restrict__ ystarts,
                                   const float* __restrict__ y,
                                   const float* __restrict__ table,
                                   const int* __restrict__ ny_ptr,
                                   const float* __restrict__ p0,
                                   float* __restrict__ out, int Wy, int nyb,
                                   int L, int measure) {
  extern __shared__ float sm[];
  float* ctx = sm;                 // [Wy + 2L]: ctx[i] = y[s - L + i]
  float* d = ctx + Wy + 2 * L;     // [Wy]
  float* e = d + Wy;               // [Wy]
  float* row = e + Wy;             // [L]
  const int k = blockIdx.x;
  const int ys = ystarts[k];
  const int s = min(max(ys, 0), nyb - 1);
  for (int i = threadIdx.x; i < Wy + 2 * L; i += blockDim.x) {
    const int g = s - L + i;
    ctx[i] = (g >= 0 && g < nyb) ? y[g] : 0.0f;
  }
  for (int i = threadIdx.x; i < Wy; i += blockDim.x)
    d[i] = dyws[static_cast<size_t>(k) * Wy + i];
  __syncthreads();
  for (int i = threadIdx.x; i < Wy; i += blockDim.x)
    e[i] = rn::mul(d[i], rn::add(2.0f * ctx[L + i], d[i]));
  __syncthreads();
  const int ny = *ny_ptr;
  // Products are rounded on their own (rn.cuh, no fused multiply-add) and
  // sums run first to last, as in the plain version, so the rows equal it
  // bit for bit.
  for (int l = 1 + threadIdx.x; l <= L; l += blockDim.x) {
    // head keeps ys + j <= ny-1-l  <=>  j < ny - l - ys  (a prefix);
    // tail keeps ys + j >= l       <=>  j >= l - ys      (a suffix), taken
    // as the total minus the prefix below l - ys.
    const int ch = min(max(ny - l - ys, 0), Wy);
    const int ct = min(max(l - ys, 0), Wy);
    float cd = 0.0f, ce = 0.0f;              // running prefix sums
    float dsx = 0.0f, dsx2 = 0.0f, cd_t = 0.0f, ce_t = 0.0f, dsxx = 0.0f;
    for (int j = 0; j < Wy; ++j) {
      if (j == ch) { dsx = cd; dsx2 = ce; }
      if (j == ct) { cd_t = cd; ce_t = ce; }
      cd = rn::add(cd, d[j]);
      ce = rn::add(ce, e[j]);
      const float df = j + l < Wy ? d[j + l] : 0.0f;
      dsxx = rn::add(dsxx, rn::mul(d[j], rn::add(
          rn::add(ctx[L + j + l], ctx[L + j - l]), df)));
    }
    if (ch == Wy) { dsx = cd; dsx2 = ce; }
    if (ct == Wy) { cd_t = cd; ce_t = ce; }
    row[l - 1] = rn::acf_rho(
        rn::add(table[l - 1], dsx), rn::add(table[L + l - 1], rn::sub(cd, cd_t)),
        rn::add(table[2 * L + l - 1], dsx2),
        rn::add(table[3 * L + l - 1], rn::sub(ce, ce_t)),
        rn::add(table[4 * L + l - 1], dsxx), static_cast<float>(ny - l));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float acc = 0.0f;
    for (int l = 0; l < L; ++l)
      acc = rn::measure_step(measure, acc, rn::sub(row[l], p0[l]));
    out[k] = rn::measure_final(measure, acc, L);
  }
}

}  // namespace

// out is [K] impacts against p0.
extern "C" int window_rows_f32(const void* dyws, const void* ystarts,
                               const void* y, const void* table,
                               const void* ny, const void* p0, void* out,
                               int K, int Wy, int nyb, int L, int measure,
                               void* stream) {
  int threads = ((L + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t smem = (3 * Wy + 3 * L) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  window_rows_kernel<<<K, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dyws), static_cast<const int*>(ystarts),
      static_cast<const float*>(y), static_cast<const float*>(table),
      static_cast<const int*>(ny), static_cast<const float*>(p0),
      static_cast<float*>(out), Wy, nyb, L, measure);
  return static_cast<int>(cudaGetLastError());
}
