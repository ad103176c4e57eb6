// The greedy segmentation scans of the PMC and Swing baselines, one series
// of float64 or float32 values a launch, every operation in the series' type (kernels/segment_scan.py has the plain
// version and the wrapper).
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
// What sets its time is the recurrence: every step depends on the state
// the previous one left (a break resets it), so one thread walks the
// series, and a step costs its chain of dependent operations (PMC: a
// min, a max, a subtraction and a compare; Swing: two divisions by
// t - t0, whose anchor x0 may have changed at the step before, a min, a
// max and a compare).  The other warps of the block stage the series in
// tiles of kTile values into shared memory, double-buffered, while the
// walking thread consumes the previous tile, so the walk never waits on
// device memory; the walker stores its outputs straight to device memory
// (stores do not stall it).  Within a Swing segment the anchor is fixed, so
// the slopes could be formed many at a time and the cone closed by a
// prefix min and max across a warp; that is left for a later change.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int kTile = 2048;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T inf() {
  return static_cast<T>(__longlong_as_double(0x7ff0000000000000LL));
}

// Warps 1.. of the block copy x[base, base + kTile) into buf.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ x, int n,
                                      int base, T* buf) {
  const int t = threadIdx.x - 32;
  if (t < 0) return;
  const int m = min(kTile, n - base);
  for (int i = t; i < m; i += kThreads - 32) buf[i] = x[base + i];
}

template <typename T>
struct PmcState {
  T lo, hi;
};

template <typename T>
struct SwingState {
  T t0, x0, u, l;
};

// err arrives as a double and is rounded to T once, as the plain version's
// T(err)
template <typename T, bool kSwing>
__global__ void __launch_bounds__(kThreads)
segment_scan_kernel(const T* __restrict__ x, unsigned char* brk, T* t0s,
                    T* x0s, T* us, T* ls, int n, double err_in) {
  __shared__ T buf[2][kTile];
  stage(x, n, 0, buf[0]);
  __syncthreads();
  const T one = 1, half = 0.5, err = static_cast<T>(err_in);
  const T err2 = rn::mul(static_cast<T>(2), err);
  PmcState<T> p{inf<T>(), -inf<T>()};
  SwingState<T> s{0, buf[0][0], inf<T>(), -inf<T>()};
  const int tiles = (n + kTile - 1) / kTile;
  for (int k = 0; k < tiles; ++k) {
    const int base = k * kTile;
    if (k + 1 < tiles) stage(x, n, base + kTile, buf[(k + 1) & 1]);
    if (threadIdx.x == 0) {
      const T* v = buf[k & 1];
      const int m = min(kTile, n - base);
      for (int j = 0; j < m; ++j) {
        const int i = base + j;
        const T xi = v[j];
        if constexpr (!kSwing) {
          const T nlo = xi < p.lo ? xi : p.lo;
          const T nhi = xi > p.hi ? xi : p.hi;
          const bool b = rn::sub(nhi, nlo) > err2;
          p.lo = b ? xi : nlo;
          p.hi = b ? xi : nhi;
          brk[i] = b;
        } else {
          const T t = static_cast<T>(i);
          T dt = rn::sub(t, s.t0);
          dt = dt > one ? dt : one;
          const T s_hi = rn::quot(rn::sub(rn::add(xi, err), s.x0), dt);
          const T s_lo = rn::quot(rn::sub(rn::sub(xi, err), s.x0), dt);
          const T nu = s_hi < s.u ? s_hi : s.u;
          const T nl = s_lo > s.l ? s_lo : s.l;
          const bool b = s.t0 != t && nl > nu;
          if (b) {
            s.x0 = rn::add(s.x0, rn::mul(rn::mul(half, rn::add(s.u, s.l)),
                                         rn::sub(rn::sub(t, one), s.t0)));
            s.t0 = rn::sub(t, one);
            T dt2 = rn::sub(t, s.t0);
            dt2 = dt2 > one ? dt2 : one;
            s.u = rn::quot(rn::sub(rn::add(xi, err), s.x0), dt2);
            s.l = rn::quot(rn::sub(rn::sub(xi, err), s.x0), dt2);
          } else {
            s.u = nu;
            s.l = nl;
          }
          brk[i] = b;
          t0s[i] = s.t0;
          x0s[i] = s.x0;
          us[i] = s.u;
          ls[i] = s.l;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kSwing>
int launch(const void* x, void* brk, void* t0, void* x0, void* u, void* l,
           int n, double err, void* stream) {
  segment_scan_kernel<T, kSwing>
      <<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(x), static_cast<unsigned char*>(brk),
          static_cast<T*>(t0), static_cast<T*>(x0), static_cast<T*>(u),
          static_cast<T*>(l), n, err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x [n] float64/float32, brk [n] bytes (0/1), contiguous.
int pmc_scan_f64(const void* x, void* brk, int n, double err, void* stream) {
  return launch<double, false>(x, brk, nullptr, nullptr, nullptr, nullptr, n,
                               err, stream);
}

int pmc_scan_f32(const void* x, void* brk, int n, double err, void* stream) {
  return launch<float, false>(x, brk, nullptr, nullptr, nullptr, nullptr, n,
                              err, stream);
}

// x, t0, x0, u, l [n] float64/float32, brk [n] bytes (0/1), contiguous.
int swing_scan_f64(const void* x, void* brk, void* t0, void* x0, void* u,
                   void* l, int n, double err, void* stream) {
  return launch<double, true>(x, brk, t0, x0, u, l, n, err, stream);
}

int swing_scan_f32(const void* x, void* brk, void* t0, void* x0, void* u,
                   void* l, int n, double err, void* stream) {
  return launch<float, true>(x, brk, t0, x0, u, l, n, err, stream);
}

}  // extern "C"
