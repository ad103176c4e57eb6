// The bilinear term of the dense Eq. 10/11 update (kernels/dense_sxx.py has
// the plain version and the wrapper): for every lane and lag l,
//   sum_t keep_t (d_t z_{t+l} + y_t d_{t+l}),  z = y + d,  keep_t = t <= ny-1-l,
// in the JAX reference's CPU order: one term a point rounded op by op, the
// row summed in XLA's row-reduce order (kernels/ref.py's row_sum_xla, the
// walk rn::row_block describes): blocks of 32 terms chained from +0 (the
// first and last blocks shorter where the row is padded to a multiple of
// 32, the smaller half of the padding in front), then the block sums
// reduced by the same rule, level by level, to one value.  A masked term is
// a signed zero, which leaves a sum begun at +0 as it is, so it is skipped.
//
// Replaces no Pallas kernel: the reference computes this term with jnp (the
// roll form on the CPU, src/repro/core/aggregates.py:93-104; a gathered
// shift basis elsewhere).  The port's card path summed it as two lag_dot
// chains, whose order is not the CPU path's, so the card's deviation parted
// from the CPU's in its last bits (ROADMAP C16); this kernel gives the
// CPU path's bits, and each lane the bits of its series alone.
//
// Bound on the H100: the function reads y and d (16 bytes a point in
// float64) and forms ~4 L operations a point (uk_elec's bucket: 0.3 MB,
// 3.5 MFLOP, ~0.1 us).  Its time is the chains: a block's 32 adds, then a
// warp's 32 block sums, then a few dozen sums a level.
//
// Design: a block a (lag, lane), a warp for each second-level block up to
// 32 warps (uk_elec's bucket of 18,432 values: 18 warps).  Warp w takes the
// second-level blocks j = w, w + warps, ...: lane i chains first-level block
// start(j) + i (its 32 terms, read through the cache), posts the sum in
// shared memory, and lane 0 chains the warp's posted sums in order into
// the second-level sum j.  Higher levels (a few hundred values at most at
// the main path's sizes) are reduced by one thread a block per level,
// alternating between two shared-memory rows, then thread 0 stores.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxLevel = 2048;   // second-level sums kept in shared memory

// Blocks of one level of XLA's row-reduce over k values.
__host__ __device__ __forceinline__ int n_blocks(int k) {
  return k <= 32 ? 1 : (k + (32 - k % 32) % 32) / 32;
}

// The first value of block b of that level.
__device__ __forceinline__ int block_start(int k, int b) {
  if (b == 0 || k <= 32) return 0;
  const int lo = ((32 - k % 32) % 32) / 2;
  return 32 - lo + (b - 1) * 32;
}

template <typename T>
__global__ void __launch_bounds__(32 * kMaxWarps)
dense_sxx_kernel(const T* __restrict__ y, const T* __restrict__ d,
                 const int* __restrict__ nys, T* __restrict__ out, int nyb,
                 int L) {
  __shared__ T level[2][kMaxLevel];
  __shared__ T posted[kMaxWarps][32];
  const int lag = blockIdx.x + 1, lane_b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  y += static_cast<size_t>(lane_b) * nyb;
  d += static_cast<size_t>(lane_b) * nyb;
  const int head = nys[lane_b] - 1 - lag;   // terms t <= head are kept
  const int n1 = n_blocks(nyb), n2 = n_blocks(n1);

  for (int j = warp; j < n2; j += warps) {
    const int size2 = rn::row_block(n1, j);
    T s = 0;
    if (lane < size2) {
      const int b = block_start(n1, j) + lane;
      const int t0 = block_start(nyb, b);
      const int t1 = min(t0 + rn::row_block(nyb, b), head + 1);
      for (int t = t0; t < t1; ++t) {
        const T ds = d[t + lag];
        const T zs = rn::add(y[t + lag], ds);
        s = rn::add(s, rn::add(rn::mul(d[t], zs), rn::mul(y[t], ds)));
      }
    }
    posted[warp][lane] = s;
    __syncwarp();
    if (lane == 0) {
      T acc = 0;
      for (int i = 0; i < size2; ++i) acc = rn::add(acc, posted[warp][i]);
      level[0][j] = acc;
    }
    __syncwarp();
  }
  __syncthreads();

  int cur = 0;
  for (int cnt = n2; cnt > 1;) {
    const int nb = n_blocks(cnt);
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      const int st = block_start(cnt, j), sz = rn::row_block(cnt, j);
      T acc = 0;
      for (int i = st; i < st + sz; ++i) acc = rn::add(acc, level[cur][i]);
      level[cur ^ 1][j] = acc;
    }
    __syncthreads();
    cur ^= 1;
    cnt = nb;
  }
  if (threadIdx.x == 0)
    out[static_cast<size_t>(lane_b) * L + blockIdx.x] = level[cur][0];
}

template <typename T>
int launch(const void* y, const void* d, const void* nys, void* out, int nyb,
           int L, int B, void* stream) {
  const int n2 = n_blocks(n_blocks(nyb));
  const int warps = n2 < kMaxWarps ? n2 : kMaxWarps;
  dense_sxx_kernel<T><<<dim3(L, B), 32 * warps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(d),
      static_cast<const int*>(nys), static_cast<T*>(out), nyb, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y, d [B, nyb], nys [B] int32, out [B, L]; contiguous; nyb <= 2048 * 1024.
int dense_sxx_f64(const void* y, const void* d, const void* nys, void* out,
                  int nyb, int L, int B, void* stream) {
  return launch<double>(y, d, nys, out, nyb, L, B, stream);
}

int dense_sxx_f32(const void* y, const void* d, const void* nys, void* out,
                  int nyb, int L, int B, void* stream) {
  return launch<float>(y, d, nys, out, nyb, L, B, stream);
}

}  // extern "C"
