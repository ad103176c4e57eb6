// Inclusive prefix sums of each row of x [B, n], left to right, one add at a
// time: out[b, i] = (((x[b, 0]) + x[b, 1]) + ...) + x[b, i], accumulated in
// float64 (a float32 row's sums are rounded to float32 on the way out).  That
// is the order of torch.cumsum on the CPU, so the card's sums equal the CPU's
// bit for bit, and a row's sums do not depend on the rows beside it.
//
// Replaces the XLA cumulative sums of the dense Eq. 10/11 update and of the
// Eq. 7 moments (jnp.cumsum at src/repro/core/aggregates.py:71,73 and
// src/repro/core/acf.py:52-53,77-78); the TPU path has no Pallas kernel for
// them.  The port needs its own because torch.cumsum on the card scans
// one row with CUB's device scan (a decoupled look-back, whose association
// depends on timing) and several rows with a block scan whose shape depends
// on the row count, so a lane of a batch would get other bits than the same
// series alone.
//
// Bound on the H100: the function reads and writes 8n bytes a row (0.3 MB at
// uk_elec's n = 18,432), but its n adds form one dependent chain, so it is
// bound by the float64 add's latency, not by the memory rate (PERF.md has the
// card's numbers).
// Design: one block a row.  The block stages the row CHUNK values at a time
// in shared memory (coalesced loads by warps 1..), thread 0 chains the adds
// through the staged chunk in order and writes the sums back in place, and
// the block stores them (coalesced).  Two buffers: while thread 0 chains
// chunk k, warps 1.. load chunk k + 1.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 2048;

template <typename T>
__device__ __forceinline__ void load_chunk(const T* __restrict__ x, T* buf,
                                           int c0, int n, int tid,
                                           int nthreads) {
  const int cnt = min(CHUNK, n - c0);
  for (int i = tid; i < cnt; i += nthreads) buf[i] = x[c0 + i];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
prefix_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int n) {
  __shared__ T buf[2][CHUNK];
  const size_t row = blockIdx.x;
  x += row * n;
  out += row * n;
  const int nchunks = (n + CHUNK - 1) / CHUNK;
  load_chunk(x, buf[0], 0, n, threadIdx.x, THREADS);
  __syncthreads();
  double acc = 0.0;
  for (int k = 0; k < nchunks; ++k) {
    T* cur = buf[k & 1];
    const int c0 = k * CHUNK;
    const int cnt = min(CHUNK, n - c0);
    if (threadIdx.x == 0) {
      // the chain: each sum waits for the one before it; the loads ahead
      // of it are independent, so the unrolled loop issues them early
#pragma unroll 8
      for (int i = 0; i < cnt; ++i) {
        acc = __dadd_rn(acc, static_cast<double>(cur[i]));
        cur[i] = static_cast<T>(acc);
      }
    } else if (threadIdx.x >= 32 && k + 1 < nchunks) {
      load_chunk(x, buf[(k + 1) & 1], c0 + CHUNK, n, threadIdx.x - 32,
                 THREADS - 32);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < cnt; i += THREADS) out[c0 + i] = cur[i];
    // the next chunk's loads write over this buffer
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int B, void* stream) {
  if (n < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  prefix_sum_kernel<T><<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and out are [B, n], contiguous; B rows, one block each.
int prefix_sum_f64(const void* x, void* out, int n, int B, void* stream) {
  return launch<double>(x, out, n, B, stream);
}

int prefix_sum_f32(const void* x, void* out, int n, int B, void* stream) {
  return launch<float>(x, out, n, B, stream);
}

}  // extern "C"
