// Eq. 7 lagged products: out[l-1] = sum_{t<n} a[t] * b_ext[t+l], l = 1..L,
// where b_ext is b (default a) followed by halo[:L] (or by L zeros).
//
// Replaces the TPU kernel src/repro/kernels/lag_dot.py:lag_dot_pallas
// (body lag_dot_kernel), which streamed the series through VMEM and summed
// each block's [L] partials into one output block across a sequential grid.
//
// Bound on the H100: at the main-path shape (n = 18,432, L = 48, float64)
// the function moves ~0.3 MB and does 2nL = 1.8 MFLOP, so it is bound by
// operations (0.05 us), and at this size by the launch (PERF.md has the
// card's numbers).  The first form took three launches a call (the
// wrapper's zero pad of b, the partials, their sum); this one takes one.
// Design, deterministic (the same bits on every run, no float atomics):
//   * a grid over time tiles: each block stages a[t0, t0+TILE) and
//     b_ext[t0+1, t0+TILE+L) in shared memory, reading b and the halo
//     through their own pointers, with the zero extension done by index
//     bounds, a thread's loads in flight together; each warp owns lags
//     (warp, warp + nwarps, ...) and sums kLags of them side by side, its
//     lanes striding over the tile, and a shuffle tree sums the lanes.
//     Each block writes partials[block, L];
//   * the last block to finish sums the partials over blocks in block
//     order, one thread per lag: every block fences its partials and takes
//     a ticket from an atomic counter; the block that draws the last
//     ticket sums them and resets the counter to 0 for the next launch.  (A thread-block cluster reducing through distributed shared
//     memory would cap the grid at a cluster's 8 or 16 blocks: PERF.md.)
// The partials and the counter are scratch the wrapper allocates once per
// stream and size; launches on one stream run in order, so they never
// share it at the same time.
// Lanes (a batch of B series, a [B, n] -> out [B, L], the self form or the
// cross form with b [B, n]): grid row blockIdx.y is a lane, with its own partials row and ticket, and its
// last block sums its partials in block order, so each lane's output has
// the bits of its launch alone.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 512;
constexpr int THREADS = 256;
constexpr int kStage = 4;   // values a thread loads ahead when staging

template <typename T, int kLags>
__global__ void __launch_bounds__(THREADS)
lag_dot_kernel(const T* __restrict__ a, const T* __restrict__ b,
               const T* __restrict__ halo, T* __restrict__ partials,
               unsigned* __restrict__ ticket, T* __restrict__ out, int n,
               int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* a_s = reinterpret_cast<T*>(smem_raw);
  T* b_s = a_s + TILE;  // b_s[i] = b_ext[t0 + 1 + i], i < TILE + L - 1
  __shared__ bool last;
  // this grid row's series (a and b), partials row, ticket and output
  const size_t series = blockIdx.y;
  a += series * n;
  b += series * n;
  partials += series * gridDim.x * L;
  ticket += series;
  out += series * L;
  const int t0 = blockIdx.x * TILE;
  const int cnt = min(TILE, n - t0);
  // stage the tile: a thread makes its kStage loads before any store
  auto b_ext = [&](int g) -> T {
    return g < n ? b[g] : (halo != nullptr && g < n + L ? halo[g - n] : T(0));
  };
  for (int i0 = threadIdx.x; i0 < 2 * TILE + L - 1;
       i0 += kStage * THREADS) {
    T v[kStage];
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * THREADS;
      v[k] = i < TILE ? (i < cnt ? a[t0 + i] : T(0))
                      : (i < 2 * TILE + L - 1 ? b_ext(t0 + 1 + i - TILE)
                                               : T(0));
    }
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = i0 + k * THREADS;
      if (i < 2 * TILE + L - 1) a_s[i] = v[k];   // b_s follows a_s
    }
  }
  __syncthreads();
  // each warp owns lags warp + 1, warp + 1 + nwarps, ..., and sums kLags
  // of them side by side (each lag's sum keeps its own order)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int l0 = 1 + warp; l0 <= L; l0 += kLags * nwarps) {
    T acc[kLags];
    int off[kLags];
#pragma unroll
    for (int k = 0; k < kLags; ++k) {
      acc[k] = T(0);
      off[k] = min(l0 + k * nwarps, L) - 1;
    }
    for (int j = lane; j < cnt; j += 32) {
      const T aj = a_s[j];
#pragma unroll
      for (int k = 0; k < kLags; ++k) acc[k] += aj * b_s[j + off[k]];
    }
#pragma unroll
    for (int k = 0; k < kLags; ++k) {
      for (int o = 16; o > 0; o >>= 1)
        acc[k] += __shfl_down_sync(0xffffffffu, acc[k], o);
      const int l = l0 + k * nwarps;
      if (lane == 0 && l <= L) partials[blockIdx.x * L + (l - 1)] = acc[k];
    }
  }
  // publish this block's partials and draw a ticket: the barrier hands the
  // warps' writes to thread 0, whose fence orders them before its atomic
  // (and, in the last block, the atomic before the loads below)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    T acc = T(0);
    for (int k = 0; k < static_cast<int>(gridDim.x); ++k)
      acc += __ldcg(partials + k * L + l);
    out[l] = acc;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

template <typename T>
int launch(const void* a, const void* b, const void* halo, void* partials,
           void* ticket, void* out, int n, int L, int B, void* stream) {
  if (n < 1 || L < 1 || B < 1 || B > 65535 || (B > 1 && halo))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nblocks = (n + TILE - 1) / TILE;
  const size_t smem = (2 * TILE + L) * sizeof(T);
  // a warp sums 6 lags side by side where it owns more than one (L > 8:
  // uk_elec's 48 give each of the 8 warps 6), else one at a time
  auto kernel = L > THREADS / 32 ? lag_dot_kernel<T, 6> : lag_dot_kernel<T, 1>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<dim3(nblocks, B), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(halo), static_cast<T*>(partials),
      static_cast<unsigned*>(ticket), static_cast<T*>(out), n, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Time-tile length: the wrapper sizes partials as [B, ceil(n / TILE), L].
int lag_dot_tile(void) { return TILE; }

// halo may be null (L zeros past b); ticket is one unsigned a lane, 0
// between launches.  B > 1 lanes take no halo (b == a, or b [B, n]).
int lag_dot_f64(const void* a, const void* b, const void* halo,
                void* partials, void* ticket, void* out, int n, int L, int B,
                void* stream) {
  return launch<double>(a, b, halo, partials, ticket, out, n, L, B, stream);
}

int lag_dot_f32(const void* a, const void* b, const void* halo,
                void* partials, void* ticket, void* out, int n, int L, int B,
                void* stream) {
  return launch<float>(a, b, halo, partials, ticket, out, n, L, B, stream);
}

}  // extern "C"
