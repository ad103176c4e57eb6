// The greedy segmentation scans of the PMC and Swing baselines, one series
// of float64 or float32 values a launch, every operation in the series'
// type (kernels/segment_scan.py has the plain version and the wrapper).
//
// Replaces no Pallas kernel: the JAX reference runs each as a jax.lax.scan
// (src/repro/baselines/functional.py:36, PMC, and :81, Swing), which XLA
// compiles into a loop on the device.  In PyTorch that loop would be a
// dozen launches a point (over 4 s a call at aus_elec's 230,688 points at
// the launch floor alone), so it is a kernel.
//
// PMC writes the break flags; Swing writes the scan's outputs at every
// step, (brk, t0, x0, u, l).  Every operation is rounded on its own
// (rn.cuh; nvcc would contract Swing's anchor x0 + 0.5 (u + l) (t - 1 - t0)
// into a fused multiply-add) and in the reference's association, so the
// outputs equal the plain version's bit for bit.
//
// Bound on the H100: the function reads n values and writes n flags (PMC)
// or n flags and 4 n values (Swing): ~0.6 / 2.6 us at aus_elec by bytes.
// What sets its time is the recurrence: a break resets the state, and the
// state after it (Swing's new anchor) depends on the one before.  But
// within a segment the state is a fold: PMC's (lo, hi) the min and max of
// the values since the segment began, Swing's cone [l, u] the max of the
// lower and the min of the upper slopes (x -/+ err - x0) / (t - t0) from
// the segment's fixed anchor (t0, x0).
//
// Design: one warp walks the series, 32 points a step, the state in
// registers.  Swing settles a segment a step: lane i takes point i0 + i
// (read from the staged tile) and forms its slopes from the segment's
// anchor at once; an inclusive prefix min and max across the warp
// (__shfl_up_sync), seeded with the carried cone, gives every lane the
// cone the walk would reach there; the first lane whose cone closes
// (__ballot_sync, __ffs) is the segment's end.  Lanes before it store
// their outputs (coalesced), the break lane's state is formed by every
// lane alike (the new anchor from the previous lane's cone, exactly as the
// walk forms it), and the next step starts at the point after the break.
// A segment longer than 32 points carries its cone into the next step.
// The prefix combine keeps the earlier operand unless the later is
// strictly smaller (larger), as the walk's s_hi < u ? s_hi : u does: that
// is associative and returns one of its operands, so every lane holds the
// walk's bits, signed zeros included (fmin / fmax may return either zero).
// The other warps stage the series in tiles of kTile values (and the 32
// after, where a step may reach) into shared memory, double-buffered.
// PMC's new segment depends on its first point alone (lo = hi = x), so all
// but the carried state is formed ahead (a scan a segment, and a lane
// folding its own segment in the walking warp, both lost to the walk at
// uk_elec's ~4 points a segment): warps 1.. prepare each tile of kPmcTile
// points while warp 0 walks the previous tile, and for each step of 32
// points form its prefix fold up to each point (the same prefix) and each
// point's own fold to the step's end with its first break (the segment a
// break there would begin; 32 broadcast reads and a predicate, no
// branch).  Warp 0's step then joins the carried (lo, hi) to the prefix,
// finds the carried segment's break by a ballot, follows the breaks by
// __shfl_sync, one shuffle a segment, and stores the step's flags at once.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPmcThreads = 512;    // the walking warp and 15 preparing
constexpr int kPmcTile = 1024;      // points a PMC tile: 32 steps

template <typename T>
__device__ __forceinline__ T inf() {
  return static_cast<T>(__longlong_as_double(0x7ff0000000000000LL));
}

// Warps 1.. of the block copy x[base, base + kTile + 32) into buf.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, int n,
                                      int base, T* buf) {
  const int t = threadIdx.x - 32;
  if (t < 0) return;
  const int m = min(kTile + 32, n - base);
  for (int i = t; i < m; i += kThreads - 32) buf[i] = x[base + i];
}

// Inclusive prefix of v over the warp by the walk's fold: the later value
// where it is strictly below (kMin) or above the earlier, else the
// earlier.
template <bool kMin, typename T>
__device__ __forceinline__ T prefix(T v, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const T o = __shfl_up_sync(kAll, v, s);
    if (lane >= s && !(kMin ? v < o : v > o)) v = o;
  }
  return v;
}

// A PMC tile, prepared by warps 1.. for the walking warp: its points and,
// for each point i of a step (32 points from a multiple of 32), the fold
// (lo, hi) of the step's points up to i (plo, phi), i's own fold from i to
// the step's end (flo, fhi: the segment a break at i would begin) and that
// fold's first break in the step (first; 32 where none).
template <typename T>
struct PmcTile {
  T x[kPmcTile];
  T plo[kPmcTile], phi[kPmcTile];
  T flo[kPmcTile], fhi[kPmcTile];
  unsigned char first[kPmcTile];
};

// Warps 1.. of the block: tile t of the series into b, then every step's
// folds, a warp a step.  The folds take the walk's comparisons; the own
// folds read the step's 32 points first (a broadcast each) and keep those
// outside the fold out by a predicate, with no branch.
template <typename T>
__device__ void pmc_prepare(const T* __restrict__ x, int n, int t,
                            PmcTile<T>& b, T err2) {
  constexpr int kHelpers = kPmcThreads / 32 - 1;
  const int base = t * kPmcTile, m = min(kPmcTile, n - base);
  for (int i = threadIdx.x - 32; i < m; i += kPmcThreads - 32)
    b.x[i] = x[base + i];
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPmcThreads - 32) : "memory");
  const int lane = threadIdx.x % 32;
  for (int w0 = (threadIdx.x / 32 - 1) * 32; w0 < m; w0 += kHelpers * 32) {
    const int nvalid = min(32, m - w0);
    const T xi = lane < nvalid ? b.x[w0 + lane] : static_cast<T>(0);
    b.plo[w0 + lane] = prefix<true>(xi, lane);
    b.phi[w0 + lane] = prefix<false>(xi, lane);
    T xs[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) xs[j] = b.x[w0 + j];
    T lo = xi, hi = xi;
    unsigned over = 0;
#pragma unroll
    for (int j = 1; j < 32; ++j) {
      const bool in = (j > lane) & (j < nvalid);
      lo = in & (xs[j] < lo) ? xs[j] : lo;
      hi = in & (xs[j] > hi) ? xs[j] : hi;
      over |= static_cast<unsigned>(in & (rn::sub(hi, lo) > err2)) << j;
    }
    b.flo[w0 + lane] = lo;
    b.fhi[w0 + lane] = hi;
    b.first[w0 + lane] = over ? __ffs(over) - 1 : 32;
  }
}

// PMC: warps 1.. prepare tile t + 1 while warp 0 walks tile t.  A step of
// the walking warp: lane i joins the carried (lo, hi) to the step's fold up
// to point i, the first lane whose range exceeds 2 err breaks the carried
// segment (__ballot_sync), and each break's segment ends at that point's
// first break, followed by __shfl_sync, one shuffle a segment.  The state
// the step leaves is the last segment's own fold, or the carried fold.
template <typename T>
__global__ void __launch_bounds__(kPmcThreads)
pmc_kernel(const T* __restrict__ x, unsigned char* brk, int n,
           double err_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PmcTile<T>* const tile = reinterpret_cast<PmcTile<T>*>(smem_raw);
  const T err = static_cast<T>(err_in);
  const T err2 = rn::mul(static_cast<T>(2), err);
  const int tiles = (n + kPmcTile - 1) / kPmcTile;
  if (threadIdx.x >= 32) pmc_prepare(x, n, 0, tile[0], err2);
  __syncthreads();
  const int lane = threadIdx.x;
  T lo = inf<T>(), hi = -inf<T>();
  for (int t = 0; t < tiles; ++t) {
    if (threadIdx.x >= 32) {
      if (t + 1 < tiles) pmc_prepare(x, n, t + 1, tile[(t + 1) & 1], err2);
    } else {
      const PmcTile<T>& b = tile[t & 1];
      const int base = t * kPmcTile, m = min(kPmcTile, n - base);
      for (int w0 = 0; w0 < m; w0 += 32) {
        const int nvalid = min(32, m - w0);
        const bool valid = lane < nvalid;
        const T plo = b.plo[w0 + lane], phi = b.phi[w0 + lane];
        const T clo = plo < lo ? plo : lo, chi = phi > hi ? phi : hi;
        const unsigned cb =
            __ballot_sync(kAll, valid & (rn::sub(chi, clo) > err2));
        const int own = b.first[w0 + lane];
        int at = cb ? __ffs(cb) - 1 : 32, last = -1;
        bool br = false;
        while (at < nvalid) {
          br = br || lane == at;
          last = at;
          at = __shfl_sync(kAll, own, at);
        }
        if (valid) brk[base + w0 + lane] = br;
        if (last < 0) {
          lo = __shfl_sync(kAll, clo, nvalid - 1);
          hi = __shfl_sync(kAll, chi, nvalid - 1);
        } else {
          lo = b.flo[w0 + last];
          hi = b.fhi[w0 + last];
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
struct SwingState {
  T t0, x0, u, l;
};

// Swing: warps 1.. stage tile k + 1 while warp 0 walks tile k.  err arrives
// as a double and is rounded to T once, as the plain version's T(err).
template <typename T>
__global__ void __launch_bounds__(kThreads)
swing_kernel(const T* __restrict__ x, unsigned char* brk, T* t0s, T* x0s,
             T* us, T* ls, int n, double err_in) {
  __shared__ T buf[2][kTile + 32];
  stage(x, n, 0, buf[0]);
  __syncthreads();
  const T one = 1, half = 0.5, err = static_cast<T>(err_in);
  const int lane = threadIdx.x;   // the walking warp's lanes
  SwingState<T> s{0, buf[0][0], inf<T>(), -inf<T>()};
  int i0 = 0;                     // the step's first point
  const int tiles = (n + kTile - 1) / kTile;
  for (int k = 0; k < tiles; ++k) {
    const int base = k * kTile;
    if (k + 1 < tiles) stage(x, n, base + kTile, buf[(k + 1) & 1]);
    if (threadIdx.x < 32) {
      const T* v = buf[k & 1];
      const int end = min(base + kTile, n);
      while (i0 < end) {
        const int i = i0 + lane;
        const bool valid = i < n;
        const int nvalid = min(32, n - i0);
        const T xi = valid ? v[i - base] : static_cast<T>(0);
        const T t = static_cast<T>(i);
        T dt = rn::sub(t, s.t0);
        dt = dt > one ? dt : one;
        const T s_hi = rn::quot(rn::sub(rn::add(xi, err), s.x0), dt);
        const T s_lo = rn::quot(rn::sub(rn::sub(xi, err), s.x0), dt);
        const T pu = prefix<true>(s_hi, lane), pl = prefix<false>(s_lo, lane);
        const T nu = pu < s.u ? pu : s.u;
        const T nl = pl > s.l ? pl : s.l;
        const bool b = valid && s.t0 != t && nl > nu;
        const unsigned mask = __ballot_sync(kAll, b);
        const int kb = mask ? __ffs(mask) - 1 : nvalid;
        if (lane < kb) {
          brk[i] = 0;
          t0s[i] = s.t0;
          x0s[i] = s.x0;
          us[i] = nu;
          ls[i] = nl;
        }
        if (!mask) {
          s.u = __shfl_sync(kAll, nu, nvalid - 1);
          s.l = __shfl_sync(kAll, nl, nvalid - 1);
          i0 += nvalid;
          continue;
        }
        // the cone before the break: the previous lane's, or the carry
        const T up = __shfl_sync(kAll, nu, kb > 0 ? kb - 1 : 0);
        const T lp = __shfl_sync(kAll, nl, kb > 0 ? kb - 1 : 0);
        const T u = kb > 0 ? up : s.u, l = kb > 0 ? lp : s.l;
        const T xk = __shfl_sync(kAll, xi, kb);
        const T tk = static_cast<T>(i0 + kb);
        s.x0 = rn::add(s.x0, rn::mul(rn::mul(half, rn::add(u, l)),
                                     rn::sub(rn::sub(tk, one), s.t0)));
        s.t0 = rn::sub(tk, one);
        T dt2 = rn::sub(tk, s.t0);
        dt2 = dt2 > one ? dt2 : one;
        // a quotient by 1 is its numerator, bit for bit
        const T a = rn::sub(rn::add(xk, err), s.x0);
        const T c = rn::sub(rn::sub(xk, err), s.x0);
        s.u = dt2 == one ? a : rn::quot(a, dt2);
        s.l = dt2 == one ? c : rn::quot(c, dt2);
        if (lane == kb) {
          brk[i] = 1;
          t0s[i] = s.t0;
          x0s[i] = s.x0;
          us[i] = s.u;
          ls[i] = s.l;
        }
        i0 += kb + 1;
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_pmc(const void* x, void* brk, int n, double err, void* stream) {
  const size_t smem = 2 * sizeof(PmcTile<T>);
  auto kernel = pmc_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<1, kPmcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<unsigned char*>(brk), n, err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_swing(const void* x, void* brk, void* t0, void* x0, void* u,
                 void* l, int n, double err, void* stream) {
  swing_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<unsigned char*>(brk),
      static_cast<T*>(t0), static_cast<T*>(x0), static_cast<T*>(u),
      static_cast<T*>(l), n, err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [n] float64/float32, brk [n] bytes (0/1), contiguous.
int pmc_scan_f64(const void* x, void* brk, int n, double err, void* stream) {
  return launch_pmc<double>(x, brk, n, err, stream);
}

int pmc_scan_f32(const void* x, void* brk, int n, double err, void* stream) {
  return launch_pmc<float>(x, brk, n, err, stream);
}

// x, t0, x0, u, l [n] float64/float32, brk [n] bytes (0/1), contiguous.
int swing_scan_f64(const void* x, void* brk, void* t0, void* x0, void* u,
                   void* l, int n, double err, void* stream) {
  return launch_swing<double>(x, brk, t0, x0, u, l, n, err, stream);
}

int swing_scan_f32(const void* x, void* brk, void* t0, void* x0, void* u,
                   void* l, int n, double err, void* stream) {
  return launch_swing<float>(x, brk, t0, x0, u, l, n, err, stream);
}

}  // extern "C"
