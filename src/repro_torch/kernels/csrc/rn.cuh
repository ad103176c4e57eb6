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

// Terms term(lo), ..., term(hi - 1) taken by step from 0, first to last.
// With kAhead the next kU terms are formed (loaded) while the current kU
// are stepped, so a row in shared memory is read kU loads at a time.
constexpr int kU = 8;

template <typename T, bool kAhead, typename Step, typename Term>
__device__ __forceinline__ T chain(Step step, Term term, int lo, int hi) {
  T acc = 0;
  if constexpr (!kAhead) {
    for (int c = lo; c < hi; ++c) acc = step(acc, term(c));
  } else {
    T v[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k)
      v[k] = lo + k < hi ? term(lo + k) : static_cast<T>(0);
    for (int q0 = lo; q0 < hi; q0 += kU) {
      T vn[kU];
#pragma unroll
      for (int k = 0; k < kU; ++k)
        vn[k] = q0 + kU + k < hi ? term(q0 + kU + k) : static_cast<T>(0);
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        if (q0 + k < hi) acc = step(acc, v[k]);
        v[k] = vn[k];
      }
    }
  }
  return acc;
}

// Size of block b of one level of XLA's row-reduce over n values
// (ref.xla_row_blocks): n itself up to 32; past that the row padded with
// zeros to a multiple of 32, the smaller half of the padding in front, so
// the first and last blocks share the rest.
__device__ __forceinline__ int row_block(int n, int b) {
  if (n <= 32) return n;
  const int pad = (32 - n % 32) % 32, lo = pad / 2, nw = (n + pad) / 32;
  return b == 0 ? 32 - lo : b == nw - 1 ? 32 - (pad - lo) : 32;
}

// A sum over L terms in XLA's CPU row-reduce order (ref.row_sum_xla, the
// order of the reference's jnp.mean over the lags), walking the block
// bounds: up to 32 terms one chain from +0 (the chain the kernels took
// before); past that each block chained from +0, the block sums chained
// within blocks of theirs, and those sums chained.  L = 48 is two blocks
// of 24 and one add; L = 365 is 23 + 32 x 10 + 22, then 12 block sums.
// Two levels of blocks take L up to 32,768; every kernel holds a row's L
// values in shared memory, which bounds L far below that.
template <typename T, bool kAhead, typename Term>
__device__ __forceinline__ T row_sum_blocks(int L, Term term) {
  const auto plus = [](T a, T t) { return add(a, t); };
  const int n1 = (L + 31) / 32;   // level-0 blocks
  T total = 0;
  for (int b1 = 0, b0 = 0, i = 0; b0 < n1; ++b1) {
    T s1 = 0;                     // a block of level-0 block sums
    for (int end = b0 + row_block(n1, b1); b0 < end; ++b0) {
      const int m = row_block(L, b0);
      s1 = add(s1, chain<T, kAhead>(plus, term, i, i + m));
      i += m;
    }
    total = add(total, s1);
  }
  return total;
}

template <typename T, bool kAhead, typename Term>
__device__ __forceinline__ T row_sum(int L, Term term) {
  if (L <= 32)
    return chain<T, kAhead>([](T a, T t) { return add(a, t); }, term, 0, L);
  return row_sum_blocks<T, kAhead>(L, term);
}

// Deviation measures over the lags (ref.measure_rows): 0 mae, 1 rmse,
// 2 cheb.  A lag's term is |diff| (mae, cheb) or diff^2 (rmse).
template <typename T>
__device__ __forceinline__ T measure_term(int measure, T diff) {
  return measure == 1 ? mul(diff, diff) : fabs(diff);
}

// The measure's reduction of the L terms term(0), ..., term(L - 1): cheb
// their max in lag order, mae and rmse their row_sum.
template <typename T, bool kAhead, typename Term>
__device__ __forceinline__ T reduce_terms(int measure, int L, Term term) {
  if (measure == 2)
    return chain<T, kAhead>([](T a, T t) { return a > t ? a : t; }, term,
                            0, L);
  return row_sum<T, kAhead>(L, term);
}

template <typename T>
__device__ __forceinline__ T measure_final(int measure, T acc, int L) {
  const T fl = static_cast<T>(L);
  if (measure == 0) return quot(acc, fl);
  if (measure == 1) return root(quot(acc, fl));
  return acc;
}

// N sums side by side over terms term(lo), ..., term(hi - 1), each a
// chain from +0 first to last; term(j, v) fills v[0, N).
template <typename T, int N, typename Term>
__device__ __forceinline__ void chain_n(Term term, int lo, int hi, T acc[N]) {
  for (int q = 0; q < N; ++q) acc[q] = 0;
  for (int j = lo; j < hi; ++j) {
    T v[N];
    term(j, v);
    for (int q = 0; q < N; ++q) acc[q] = add(acc[q], v[q]);
  }
}

// N sums side by side over n terms in XLA's CPU row-reduce order
// (ref.row_sum_xla, rn::row_sum's walk): up to 32 terms one chain from +0;
// past that each block chained from +0, the block sums chained within
// blocks of theirs, and those sums chained.  The order of the reference's
// jnp.sum over a window of the Eq. 9 sums (fused_round.py's roll form, the
// Pallas scan body).
template <typename T, int N, typename Term>
__device__ __forceinline__ void row_sums(int n, Term term, T out[N]) {
  if (n <= 32) {
    chain_n<T, N>(term, 0, n, out);
    return;
  }
  const int n1 = (n + 31) / 32;   // level-0 blocks
  for (int q = 0; q < N; ++q) out[q] = 0;
  for (int b1 = 0, b0 = 0, i = 0; b0 < n1; ++b1) {
    T s1[N];
    for (int q = 0; q < N; ++q) s1[q] = 0;
    for (int end = b0 + row_block(n1, b1); b0 < end; ++b0) {
      const int m = row_block(n, b0);
      T c[N];
      chain_n<T, N>(term, i, i + m, c);
      for (int q = 0; q < N; ++q) s1[q] = add(s1[q], c[q]);
      i += m;
    }
    for (int q = 0; q < N; ++q) out[q] = add(out[q], s1[q]);
  }
}

// One window position j of the Eq. 9 masked sums of lag l: the delta d[0,
// W) (d[j + l] read as 0 past W) with e = d (2 c + d) lies at global
// positions s + j of a series of valid length ny, and c points at the
// window's first value in a context that reaches c[j - l] and c[j + l].
// v[0..4] receive the terms of the deltas of sum x, sum x_lag, sum x^2,
// sum x_lag^2 and sum x x_lag, with the head and tail masks h, tl.  The
// bilinear term takes one of the reference's two associations:
// kEinsum, ref._window_delta_acf's basis (c[j + l] + d[j + l]) h + c[j - l]
// tl; else the Pallas scan body's (c[j + l] h + c[j - l] tl) + d[j + l] h.
template <bool kEinsum, typename T>
__device__ __forceinline__ void window_term(const T* c, const T* d,
                                            const T* e, int W, int s, int j,
                                            int l, int ny, T v[5]) {
  const int t = s + j;
  const T h = t <= ny - 1 - l ? 1 : 0;
  const T tl = t >= l ? 1 : 0;
  const T dj = d[j];
  const T df = j + l < W ? d[j + l] : static_cast<T>(0);
  const T inner = kEinsum ? add(mul(add(c[j + l], df), h), mul(c[j - l], tl))
                          : add(add(mul(c[j + l], h), mul(c[j - l], tl)),
                                mul(df, h));
  v[0] = mul(dj, h);
  v[1] = mul(dj, tl);
  v[2] = mul(e[j], h);
  v[3] = mul(e[j], tl);
  v[4] = mul(dj, inner);
}

}  // namespace rn
