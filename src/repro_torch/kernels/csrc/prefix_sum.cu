// Inclusive prefix sums of each row of x [B, n] in XLA's cumsum order: a
// blocked scan of base 16, recursive.  Level 0 cuts the row into groups of
// 16 values (the last one padded with zeros) and sums each group one add at
// a time from +0 (its in-group partials, whose last entry is the group's
// total); level 1 scans the groups' totals the same way, and so on up to a
// level of at most 16 values, which is one chain.  Then, top down, every
// partial at level k gets one add: the inclusive sum at level k + 1 of the
// groups before its own (none for group 0).  That is the order
// jax.numpy.cumsum takes (XLA lowers it to a reduce_window, which its CPU
// backend rewrites into this scan), so the sums equal the JAX reference's
// bit for bit, and a row's sums do not depend on the rows beside it.  A
// float32 row adds in float32, as XLA does.  prefix_sum.py's plain version
// computes the same order with PyTorch ops level by level.
//
// Replaces the XLA cumulative sums of the dense Eq. 10/11 update and of the
// Eq. 7 moments (jnp.cumsum at src/repro/core/aggregates.py:71,73 and
// src/repro/core/acf.py:52-53,77-78); the TPU path has no Pallas kernel for
// them.  torch.cumsum is no substitute: on the card it scans one row with
// CUB's device scan and several rows with a block scan shaped by the row
// count, in neither case XLA's order, and so a lane of a batch would not
// keep the bits of the same series alone.
//
// Bound on the H100: the function reads and writes n values a row (0.3 MB
// at uk_elec's n = 18,432 in float64) and adds ~1.07 n times, so it is
// bound by bytes (~0.09 us a row).  At the main path's sizes the launch,
// the dependent adds (16 a level on the way up, one a level on the way
// down: ~56 at n = 18,432) and the exchange between blocks set its time
// (PERF.md has the card's numbers).
//
// Design: a tile of 4,096 = 16^3 aligned values is a whole subtree of
// levels 0-2, so its partials need nothing outside it.  A thread-block
// cluster of C <= 8 blocks takes a row; block r owns the row's tiles r,
// r + C, ... (its "rounds"), each staged into a shared-memory slot with
// cp.async.  For each tile: 256 threads each chain one 16-value group
// (its partials stay in the thread's registers), 16 threads chain the
// level-1 totals and one thread the level-2 totals; the block publishes the
// tile's total, its level-2 partial 14 and its level-1 partial 255.  Then
// every block stores each of its tiles' three values into every block of
// the cluster with st.async, counted on the receiver's mbarrier (no memory
// fence: a release at cluster scope compiles to a GPU-wide MEMBAR),
// scans all tile totals itself in XLA's order (levels 3 and up: the same
// adds in every block, so the same bits), and forms its tiles' carries:
// the inclusive sums before the tile at levels 3, 2 and 1.  Then each tile
// takes the three-add downsweep and is stored coalesced.  A group sits 17
// values from the next in shared memory, so a warp reading one value of
// each of its threads' groups, or storing 16 consecutive values, hits
// distinct banks, at offsets fixed at compile time.  A block keeps as many
// tiles as its shared memory holds (every main-path row fits); where it
// owns more, the first rounds are read and scanned again after the
// exchange, with the same bits.  Rows up to 4,096 tiles (n <= 16,777,216).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "cluster.cuh"
#include "rn.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;             // one 16-value group a thread
constexpr int TILE = 16 * THREADS;       // 4,096 values: levels 0-2
constexpr int STRIDE = 17;               // a 16-value group and a pad
// a slot: the tile's 256 groups, its 16 level-1 groups and the level-2 row
constexpr int L1_AT = THREADS * STRIDE;
constexpr int L2_AT = L1_AT + 16 * STRIDE;
constexpr int SLOT = L2_AT + 16;
constexpr int MAX_CLUSTER = 8;           // the portable cluster size
constexpr int MAX_TILES = 4096;          // levels 3-5 in the top scan
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr size_t BAR_BYTES = 16;         // the exchange's mbarrier

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Where value i * THREADS + threadIdx.x of a tile sits in its slot, less
// i * 16 * STRIDE: group i * 16 + threadIdx.x / 16, value threadIdx.x % 16.
__device__ __forceinline__ int spread_at() {
  return STRIDE * (threadIdx.x >> 4) + (threadIdx.x & 15);
}

// Tile t of the row into slot s (zeros past n), without waiting.  A
// half-warp writes one group's 16 values: 16 banks apart from the next.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x, T* s,
                                          int t, int n) {
  const int lim = n - t * TILE - static_cast<int>(threadIdx.x);
  x += t * TILE + threadIdx.x;
  s += spread_at();
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i * THREADS < lim) {
      cl::cp_async(s + i * 16 * STRIDE, x + i * THREADS);
    } else {
      s[i * 16 * STRIDE] = T(0);
    }
  }
}

// Levels 0-2 of the tile in slot s: v receives this thread's group's
// partials (written back to the slot too where `spill`); the slot's
// level-1 and level-2 rows become theirs.  Starts and ends at a block
// barrier.  Thread g's group sits at s + STRIDE g, so the 16 (float64) or
// 32 (float32) threads reading value k of their groups hit distinct banks.
template <typename T>
__device__ __forceinline__ void upsweep(T* s, T (&v)[16], bool spill) {
  const int g = threadIdx.x;
  T* grp = s + STRIDE * g;
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = grp[k];
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = acc = rn::add(acc, v[k]);
  if (spill) {
#pragma unroll
    for (int k = 0; k < 16; ++k) grp[k] = v[k];
  }
  T* l1 = s + L1_AT;
  T* l2 = s + L2_AT;
  l1[STRIDE * (g >> 4) + (g & 15)] = acc;
  __syncthreads();
  if (g < 16) {
    T w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = l1[STRIDE * g + k];
    acc = T(0);
#pragma unroll
    for (int k = 0; k < 16; ++k) l1[STRIDE * g + k] = acc = rn::add(acc, w[k]);
    l2[g] = acc;
  }
  __syncwarp();
  if (g == 0) {
    T w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = l2[k];
    acc = T(0);
#pragma unroll
    for (int k = 0; k < 16; ++k) l2[k] = acc = rn::add(acc, w[k]);
  }
  __syncthreads();
}

// The downsweep of the tile in slot s, whose values' partials are in v
// (this thread's group), with its carries c = (level 1, 2, 3): level-2
// partials + c[2], level-1 partials + (c[1] or the level-2 sum before
// their group), values + (c[0] or the level-1 sum before their group);
// then the tile is stored, coalesced.  Starts after a block barrier.
template <typename T>
__device__ __forceinline__ void downsweep(T* s, T (&v)[16], const T* c,
                                          T* __restrict__ out, int t, int n) {
  const int g = threadIdx.x;
  T* l1 = s + L1_AT;
  T* l2 = s + L2_AT;
  if (g < 16) l2[g] = rn::add(l2[g], c[2]);
  __syncwarp();
  if (g < 16) {
    const T p = g == 0 ? c[1] : l2[g - 1];
    T w[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = l1[STRIDE * g + k];
#pragma unroll
    for (int k = 0; k < 16; ++k) l1[STRIDE * g + k] = rn::add(w[k], p);
  }
  __syncthreads();
  const int h = max(g - 1, 0);
  const T p = g == 0 ? c[0] : l1[STRIDE * (h >> 4) + (h & 15)];
  T* grp = s + STRIDE * g;
#pragma unroll
  for (int k = 0; k < 16; ++k) grp[k] = rn::add(v[k], p);
  __syncthreads();
  const T* src = s + spread_at();
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = src[i * 16 * STRIDE];
  const int lim = n - t * TILE - g;
  out += t * TILE + g;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i * THREADS < lim) out[i * THREADS] = v[i];
  }
}

// One group a[0, cnt) chained from +0 in place (cnt <= 16); returns its
// total.  Values past cnt count as +0: x + 0 is x for every sum here (none
// is -0, each chain starting from +0).
template <typename T>
__device__ __forceinline__ T chain16(T* a, int cnt) {
  T w[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) w[j] = j < cnt ? a[j] : T(0);
  T acc = T(0);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    acc = rn::add(acc, w[j]);
    if (j < cnt) a[j] = acc;
  }
  return acc;
}

// Level k of XLA's cumsum of a[0, m) by the block: the in-group partials
// of every 16-value group of a, in place, their totals into up.  Ends at a
// block barrier.
template <typename T>
__device__ __forceinline__ void scan_up(T* a, int m, T* up) {
  for (int i = threadIdx.x; 16 * i < m; i += THREADS)
    up[i] = chain16(a + 16 * i, min(16, m - 16 * i));
  __syncthreads();
}

// a[i] += the inclusive sum before i's group (up, the level above, already
// scanned), for i past the first group.  Ends at a block barrier.
template <typename T>
__device__ __forceinline__ void scan_down(T* a, int m, const T* up) {
  for (int i = threadIdx.x + 16; i < m; i += THREADS)
    a[i] = rn::add(a[i], up[(i >> 4) - 1]);
  __syncthreads();
}

// XLA's cumsum of a[0, m) in place, m <= 4,096 (three levels at most),
// with s1 and s2 for the levels above.  Starts and ends at a block barrier.
template <typename T>
__device__ void block_scan(T* a, int m, T* s1, T* s2) {
  if (m <= 16) {
    if (threadIdx.x == 0) chain16(a, m);
    __syncthreads();
    return;
  }
  const int m1 = cdiv(m, 16);
  scan_up(a, m, s1);
  if (m1 <= 16) {
    if (threadIdx.x == 0) chain16(s1, m1);
    __syncthreads();
  } else {
    scan_up(s1, m1, s2);
    if (threadIdx.x == 0) chain16(s2, cdiv(m1, 16));
    __syncthreads();
    scan_down(s1, m1, s2);
  }
  scan_down(a, m, s1);
}

// Grid (C, B), cluster (C, 1, 1): grid row b is row b of x.  Shared memory:
// the exchange's mbarrier, `slots` tile slots, the published values (tile
// total, level-2 partial 14, level-1 partial 255) and the carries of the
// block's rounds, three each, then four rows over the row's tiles (their
// totals to scan, the totals, the two partials) and the top scan's two
// levels.
template <typename T>
__global__ void __launch_bounds__(THREADS)
prefix_sum_kernel(const T* __restrict__ x, T* __restrict__ out, int n,
                  int slots) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int r = static_cast<int>(cluster.block_rank());
  const int ntiles = cdiv(n, TILE);
  const int max_rounds = cdiv(ntiles, C);
  const int rounds = r < ntiles ? cdiv(ntiles - r, C) : 0;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem_raw);
  T* slot = reinterpret_cast<T*>(smem_raw + BAR_BYTES);
  T* pub = slot + static_cast<size_t>(slots) * SLOT;
  T* car = pub + 3 * max_rounds;
  T* tt = car + 3 * max_rounds;
  T* t3 = tt + ntiles;
  T* t2 = t3 + ntiles;
  T* t1 = t2 + ntiles;
  T* s1 = t1 + ntiles;
  T* s2 = s1 + cdiv(ntiles, 16);
  const size_t row = blockIdx.y;
  x += row * n;
  out += row * n;
  if (threadIdx.x == 0)
    cl::bar_init(bar, static_cast<unsigned>(4 * ntiles * sizeof(T)));
  cl::cluster_arrive_relaxed();

  // pass 1: every round's upsweep; the last round's partials stay in v,
  // the last `slots` rounds in their slots (round k in slot k % slots)
  T v[16];
  const int first = min(rounds, slots);
  for (int k = 0; k < first; ++k)
    load_tile(x, slot + k * SLOT, r + C * k, n);
  for (int k = 0; k < rounds; ++k) {
    T* s = slot + (k % slots) * SLOT;
    cl::cp_wait();
    __syncthreads();
    upsweep(s, v, k + 1 < rounds);
    if (threadIdx.x == 0) {
      pub[3 * k] = s[L2_AT + 15];
      pub[3 * k + 1] = s[L2_AT + 14];
      pub[3 * k + 2] = s[L1_AT + 15 * STRIDE + 15];
    }
    if (k + slots < rounds) load_tile(x, s, r + C * (k + slots), n);
  }
  __syncthreads();

  // the exchange: every block gets each tile's three published values,
  // once every block's mbarrier is set up
  cl::cluster_wait();
  for (int i = threadIdx.x; i < C * rounds; i += THREADS) {
    const int q = i % C, k = i / C, t = r + C * k;
    cl::push(tt + t, pub[3 * k], bar, q);
    cl::push(t3 + t, pub[3 * k], bar, q);
    cl::push(t2 + t, pub[3 * k + 1], bar, q);
    cl::push(t1 + t, pub[3 * k + 2], bar, q);
  }
  cl::bar_wait(bar);

  // levels 3 and up: every block scans all tile totals itself
  block_scan(tt, ntiles, s1, s2);
  // the carries of tile t: the inclusive sums before it at level 3
  // (P3[t-1]), level 2 (total[t-1] + P3[t-2]) and level 1 (l1[t-1] +
  // (l2[t-1] + P3[t-2])), from tile t - 1's published values; +0 for t = 0
  for (int k = threadIdx.x; k < rounds; k += THREADS) {
    const int t = r + C * k;
    T c1 = T(0), c2 = T(0), c3 = T(0);
    if (t >= 1) {
      const T q = t >= 2 ? tt[t - 2] : T(0);
      c3 = tt[t - 1];
      c2 = rn::add(t3[t - 1], q);
      c1 = rn::add(t1[t - 1], rn::add(t2[t - 1], q));
    }
    car[3 * k] = c1;
    car[3 * k + 1] = c2;
    car[3 * k + 2] = c3;
  }
  __syncthreads();

  // pass 2: the last round (its partials in v), the others still in their
  // slots, then the rest, read and scanned again
  for (int j = 0; j < rounds; ++j) {
    const int k = j == 0 ? rounds - 1
                  : j < first ? rounds - first + j - 1 : j - first;
    const int t = r + C * k;
    T* s = slot + (k % slots) * SLOT;
    if (j >= first) {
      s = slot;
      __syncthreads();
      load_tile(x, s, t, n);
      cl::cp_wait();
      __syncthreads();
      upsweep(s, v, false);
    } else if (j > 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = s[STRIDE * threadIdx.x + i];
    }
    downsweep(s, v, car + 3 * k, out, t, n);
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int B, int C, void* stream) {
  if (n < 1 || B < 1 || B > 65535 || C < 1 || C > MAX_CLUSTER ||
      cdiv(n, TILE) > MAX_TILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = cdiv(n, TILE);
  const int max_rounds = cdiv(ntiles, C);
  const size_t fixed = BAR_BYTES + static_cast<size_t>(
      6 * max_rounds + 4 * ntiles + cdiv(ntiles, 16) + cdiv(ntiles, 256)) *
      sizeof(T);
  const size_t slot_bytes = static_cast<size_t>(SLOT) * sizeof(T);
  if (fixed + slot_bytes > SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = std::min(max_rounds, static_cast<int>(
      (SMEM_MAX - fixed) / slot_bytes));
  const size_t smem = fixed + static_cast<size_t>(slots) * slot_bytes;
  auto kernel = prefix_sum_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                                       static_cast<T*>(out), n, slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and out are [B, n], contiguous; B rows, a cluster of C blocks each
// (1 <= C <= 8; prefix_sum.py chooses it from n).
int prefix_sum_f64(const void* x, void* out, int n, int B, int C,
                   void* stream) {
  return launch<double>(x, out, n, B, C, stream);
}

int prefix_sum_f32(const void* x, void* out, int n, int B, int C,
                   void* stream) {
  return launch<float>(x, out, n, B, C, stream);
}

}  // extern "C"
