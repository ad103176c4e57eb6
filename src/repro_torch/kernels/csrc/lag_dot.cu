// Eq. 7 lagged products: out[l-1] = sum_{t<n} a[t] * b_ext[t+l], l = 1..L,
// where b_ext is b (default a) followed by halo[:L] (or by L zeros).
//
// Replaces the TPU kernel src/repro/kernels/lag_dot.py:lag_dot_pallas
// (body lag_dot_kernel), which streamed the series through VMEM and summed
// each block's [L] partials into one output block across a sequential grid.
//
// Order.  The plain version (kernels/lag_dot.py: lag_dot_plain) sums each
// lag's products a[t] b_ext[t + l] one add at a time from +0, t first to
// last: the order in which the JAX reference's a @ shifted sums, compiled
// op by op.  This kernel takes the same chain, so its output equals the
// plain version bit for bit: every step is __dadd_rn(acc, __dmul_rn(a, b))
// (rn.cuh), which nvcc cannot contract into a fused multiply-add.
//
// Bound on the H100: at the main-path shape (n = 18,432, L = 48, float64)
// the function moves ~0.3 MB and does 2nL = 1.8 MFLOP, so its bound is
// ~0.05 us of operations; but the chain is n dependent adds a lag, so the
// kernel is bound by the latency of one float64 add times n (~8.4 cycles
// each on this card: ~0.08 ms at n = 18,432), not by the card's rates.
// Design: one thread per (lane, lag), all of a lane's lags in one block
// (blocks of THREADS lags where L is larger), grid rows the lanes.  The
// block stages tiles of a[t0, t0 + TILE) and b_ext[t0 + 1, t0 + TILE + L)
// in shared memory, every thread of the block loading (the zero extension
// and the halo by index bounds), then each lag's thread chains the tile's
// products; thread l reads b_s[j + l - 1], consecutive across a warp's
// lags (no bank conflicts), and a_s[j], one broadcast.  Deterministic: no
// atomics, no scratch.  (The earlier form summed each time tile's products
// in a shuffle tree and the tiles' partials in block order: 0.006440 ms a
// uk_elec launch, but not the plain version's bits; PERF.md.)
// Lanes (a batch of B series, a [B, n] -> out [B, L]): the self form, the
// cross form with b [B, n] and the halo form with b (or a) and halo [B, L]
// (the partitioned mode's T partitions in one launch); each lane's output
// has the bits of its launch alone.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 128;
// the loads a thread makes to stage a tile
constexpr int kLoads = (2 * TILE + THREADS - 1) / THREADS + 1;
constexpr int kAhead = 8;   // products formed ahead of the chain

template <typename T>
__global__ void __launch_bounds__(THREADS)
lag_dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ halo, T* __restrict__ out, int n,
               int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);  // a[t0 + i], i < TILE
  T* b_s = a_s + TILE;  // b_ext[t0 + 1 + i], i < TILE + L - 1
  // this grid row's series
  const size_t series = blockIdx.y;
  a += series * n;
  b += series * n;
  if (halo != nullptr) halo += series * L;
  out += series * L;
  const int l = blockIdx.x * THREADS + threadIdx.x + 1;   // this lag
  const int S = 2 * TILE + L - 1;                          // staged values
  auto value = [&](int t0, int i) -> T {
    if (i < TILE) return t0 + i < n ? a[t0 + i] : T(0);
    const int g = t0 + 1 + i - TILE;
    return g < n ? b[g] : (halo != nullptr && g < n + L ? halo[g - n] : T(0));
  };
  T acc = 0;
  for (int t0 = 0; t0 < n; t0 += TILE) {
    // stage this tile: a thread's loads are in flight together
    for (int i0 = threadIdx.x; i0 < S; i0 += kLoads * THREADS) {
      T v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = i0 + k * THREADS;
        v[k] = i < S ? value(t0, i) : T(0);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = i0 + k * THREADS;
        if (i < S) a_s[i] = v[k];   // b_s follows a_s
      }
    }
    __syncthreads();
    if (l <= L) {
      const int cnt = min(TILE, n - t0);
      const T* bl = b_s + l - 1;
      // eight products formed ahead of their adds, which stay in order
      int j = 0;
      for (; j + kAhead <= cnt; j += kAhead) {
        T p[kAhead];
#pragma unroll
        for (int k = 0; k < kAhead; ++k) p[k] = rn::mul(a_s[j + k], bl[j + k]);
#pragma unroll
        for (int k = 0; k < kAhead; ++k) acc = rn::add(acc, p[k]);
      }
      for (; j < cnt; ++j) acc = rn::add(acc, rn::mul(a_s[j], bl[j]));
    }
    __syncthreads();
  }
  if (l <= L) out[l - 1] = acc;
}

template <typename T>
int launch(const void* a, const void* b, const void* halo, void* out, int n,
           int L, int B, void* stream) {
  if (n < 1 || L < 1 || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (2 * TILE + L) * sizeof(T);
  auto kernel = lag_dot_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3((L + THREADS - 1) / THREADS, B), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(halo), static_cast<T*>(out), n, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b [B, n] (b == a for the self form); halo [B, L] or null (L zeros
// past b); out [B, L].
int lag_dot_f64(const void* a, const void* b, const void* halo, void* out,
                int n, int L, int B, void* stream) {
  return launch<double>(a, b, halo, out, n, L, B, stream);
}

int lag_dot_f32(const void* a, const void* b, const void* halo, void* out,
                int n, int L, int B, void* stream) {
  return launch<float>(a, b, halo, out, n, L, B, stream);
}

}  // extern "C"
