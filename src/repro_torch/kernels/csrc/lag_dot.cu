// Eq. 7 lagged products: out[l-1] = sum_{t<n} a[t] * b_ext[t+l], l = 1..L.
//
// Replaces the TPU kernel src/repro/kernels/lag_dot.py:lag_dot_pallas
// (body lag_dot_kernel), which streamed the series through VMEM and summed
// each block's [L] partials into one output block across a sequential grid.
//
// Bound on the H100: at the main-path shape (n = 18,432, L = 48, float64)
// the function moves ~0.3 MB and does 2nL = 1.8 MFLOP, so it is bound by
// bytes, and at this size by the launch (PERF.md has the card's numbers).
// The design keeps it simple and deterministic rather than fast:
//   * pass 1, a grid over time tiles: each block stages a[t0, t0+TILE) and
//     b_ext[t0+1, t0+TILE+L) in shared memory; each warp owns lags
//     (warp, warp + nwarps, ...), its lanes stride over the tile, and a
//     shuffle tree sums the lanes.  Each block writes partials[block, L].
//   * pass 2 sums the partials over blocks in block order, one thread per
//     lag.  No float atomics: the GPU grid has no order, and atomics would
//     make sxx differ from run to run.
// b_ext (length n + L) carries the self, cross (b=) and halo (halo=) forms;
// the wrapper builds it.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 512;
constexpr int THREADS = 256;

template <typename T>
__global__ void lag_dot_partials(const T* __restrict__ a,
                                 const T* __restrict__ b_ext,
                                 T* __restrict__ partials, int n, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = a_s + TILE;  // b_s[i] = b_ext[t0 + 1 + i], i < TILE + L - 1
  const int t0 = blockIdx.x * TILE;
  const int cnt = min(TILE, n - t0);
  for (int i = threadIdx.x; i < TILE; i += blockDim.x)
    a_s[i] = i < cnt ? a[t0 + i] : T(0);
  for (int i = threadIdx.x; i < TILE + L - 1; i += blockDim.x) {
    const int g = t0 + 1 + i;
    b_s[i] = g < n + L ? b_ext[g] : T(0);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int l = 1 + warp; l <= L; l += nwarps) {
    T acc = T(0);
    for (int j = lane; j < cnt; j += 32) acc += a_s[j] * b_s[j + l - 1];
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) partials[blockIdx.x * L + (l - 1)] = acc;
  }
}

template <typename T>
__global__ void lag_dot_reduce(const T* __restrict__ partials,
                               T* __restrict__ out, int nblocks, int L) {
  for (int l = blockIdx.x * blockDim.x + threadIdx.x; l < L;
       l += gridDim.x * blockDim.x) {
    T acc = T(0);
    for (int b = 0; b < nblocks; ++b) acc += partials[b * L + l];
    out[l] = acc;
  }
}

template <typename T>
int launch(const void* a, const void* b_ext, void* partials, void* out, int n,
           int L, void* stream) {
  const int nblocks = (n + TILE - 1) / TILE;
  const size_t smem = (2 * TILE + L) * sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lag_dot_partials<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lag_dot_partials<T><<<nblocks, THREADS, smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b_ext),
      static_cast<T*>(partials), n, L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rthreads = 128;
  const int rblocks = (L + rthreads - 1) / rthreads;
  lag_dot_reduce<T><<<rblocks, rthreads, 0, s>>>(
      static_cast<const T*>(partials), static_cast<T*>(out), nblocks, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Time-tile length: the wrapper sizes partials as [ceil(n / TILE), L].
int lag_dot_tile(void) { return TILE; }

int lag_dot_f64(const void* a, const void* b_ext, void* partials, void* out,
                int n, int L, void* stream) {
  return launch<double>(a, b_ext, partials, out, n, L, stream);
}

int lag_dot_f32(const void* a, const void* b_ext, void* partials, void* out,
                int n, int L, void* stream) {
  return launch<float>(a, b_ext, partials, out, n, L, stream);
}

}  // extern "C"
