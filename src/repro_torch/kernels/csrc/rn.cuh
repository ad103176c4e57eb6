// Arithmetic shared by the kernels whose outputs must equal their plain
// PyTorch versions bit for bit: every product, sum, quotient and root is
// rounded on its own (no fused multiply-add), in float or double, and the
// Eq. 2 entry and the deviation measures are formed op for op as
// kernels/ref.py forms them (acf_from_moments, measure_rows).
#pragma once
#include <cuda_runtime.h>

namespace rn {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double quot(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

template <typename T>
__device__ __forceinline__ T sub(T a, T b) { return add(a, -b); }

// Eq. 2 for one lag: num / sqrt(max(den2, tiny)) where den2 > tiny, else 0
// (ref.acf_from_moments; m = ny - l).
template <typename T>
__device__ __forceinline__ T acf_rho(T sx, T sxl, T sx2, T sxl2, T sxx, T m) {
  const T tiny = static_cast<T>(1e-30);
  const T num = sub(mul(m, sxx), mul(sx, sxl));
  const T den2 = mul(sub(mul(m, sx2), mul(sx, sx)),
                     sub(mul(m, sxl2), mul(sxl, sxl)));
  return den2 > tiny ? quot(num, root(den2 > tiny ? den2 : tiny))
                     : static_cast<T>(0);
}

// The five Eq. 9 masked window sums of one lag l (ref._window_delta_acf):
// the delta d[0, W) with e = d (2 c + d) lies at global positions s + j of
// a series of valid length ny, and c points at the window's first value in
// a context that reaches c[j - l] and c[j + l].  a[0..4] receive the
// deltas of sum x, sum x_lag, sum x^2, sum x_lag^2 and sum x x_lag; each
// sum runs first to last and starts from its first term, as sum_in_order
// does.
template <typename T>
__device__ __forceinline__ void window_sums(const T* c, const T* d,
                                            const T* e, int W, int s, int l,
                                            int ny, T a[5]) {
  for (int q = 0; q < 5; ++q) a[q] = 0;
  for (int j = 0; j < W; ++j) {
    const int t = s + j;
    const T h = t <= ny - 1 - l ? 1 : 0;
    const T tl = t >= l ? 1 : 0;
    const T dj = d[j];
    const T df = j + l < W ? d[j + l] : 0;
    const T inner = add(add(mul(c[j + l], h), mul(c[j - l], tl)),
                        mul(df, h));
    const T v[5] = {mul(dj, h), mul(dj, tl), mul(e[j], h), mul(e[j], tl),
                    mul(dj, inner)};
    for (int q = 0; q < 5; ++q) a[q] = j == 0 ? v[q] : add(a[q], v[q]);
  }
}

// Deviation measures over lags taken in order (ref.measure_rows):
// 0 mae, 1 rmse, 2 cheb.  acc starts at 0 and takes one lag at a time.
template <typename T>
__device__ __forceinline__ T measure_step(int measure, T acc, T diff) {
  if (measure == 1) return add(acc, mul(diff, diff));
  const T a = fabs(diff);
  if (measure == 0) return add(acc, a);
  return acc > a ? acc : a;
}

template <typename T>
__device__ __forceinline__ T measure_final(int measure, T acc, int L) {
  const T fl = static_cast<T>(L);
  if (measure == 0) return quot(acc, fl);
  if (measure == 1) return root(quot(acc, fl));
  return acc;
}

}  // namespace rn
