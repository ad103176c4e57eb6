// The bilinear term of the dense Eq. 10/11 update (kernels/dense_sxx.py has
// the plain version and the wrapper): for every lane and lag l,
//   sum_t keep_t (d_t z_{t+l} + y_t d_{t+l}),  z = y + d,  keep_t = t <= ny-1-l,
// in the JAX reference's CPU order: one term a point rounded op by op, the
// row summed in XLA's row-reduce order (kernels/ref.py's row_sum_xla):
// first-level blocks of <= 32 terms chained from +0 (the first and last
// blocks shorter where the row is padded to a multiple of 32, the smaller
// half of the padding in front), then the block sums reduced by the same
// rule, level by level, to one value.  A masked term is a signed zero,
// which leaves a sum begun at +0 as it is, so it is skipped.
//
// Replaces no Pallas kernel: the reference computes this term with jnp (the
// roll form on the CPU, src/repro/core/aggregates.py:93-104; a gathered
// shift basis elsewhere).  The port's card path summed it as two lag_dot
// chains, whose order is not the CPU path's (ROADMAP C16); this kernel
// gives the CPU path's bits, and each lane the bits of its series alone.
//
// Bound on the H100: the function reads y and d (16 bytes a point in
// float64) and forms ~4 L operations a point (uk_elec's bucket: 0.3 MB,
// 3.5 MFLOP, ~0.1 us), below the launch floor.  What it pays is the
// shared-memory traffic of its terms (a term reads y_{t+l} and d_{t+l},
// 16 bytes a lane, against 128 bytes a cycle an SM), the 32-add chains,
// and filling the card.
//
// Design: one staged tile serves every lag of a group.  A block owns one
// lane's tile (one or more second-level blocks, <= 1,024 terms each) for a
// group of G <= 32 lags.  It stages y and d over the tile plus the group's
// largest lag into shared memory once (cp.async, coalesced, every copy in
// flight at once), and no lag reads the row from device memory again.
// Lanes are lags: lane j of a warp takes lag l0 + j of one first-level
// block and chains that block's 32 terms in order, so the t reads are one
// broadcast and the t + l reads consecutive.  Where G < 32, P = 32 / G
// first-level blocks share a warp (lanes p G + j): the tile is cut into P
// segments of consecutive blocks, each stored at an offset of p G banks
// (slot()), so the packs' reads never meet in one bank.  Each lane
// interleaves kU chains (blocks kWarps apart), their terms formed kK at a
// time with every load in flight before the adds, and no branch: a chain's
// kept terms are added by a select.  One thread then chains the <= 32
// first-level sums of each (lag, second-level block) from shared memory.
// The levels above: the tiles of one (lane, group) are a thread-block
// cluster of C <= 8 blocks.  Each tile's sums of the level its tiles own
// (second-level blocks while there are at most 32 of them, else
// third-level blocks, each chained by one thread) go into block 0's shared
// memory by st.async, counted on block 0's mbarrier (no cluster-wide
// fence); the other tiles exit, and one warp of block 0 awaits them and
// reduces the sums by XLA's rule (rn::row_sum) into the group's L values:
// one launch, no second pass, no counter.  The lag group shrinks (32, 16,
// 8, 4) until the grid has kMinBlocks blocks, the packs' halos would
// outgrow the chunk, or the shared memory would not fit, so one series
// spreads over the card as a batch does.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "rn.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 2;              // chains a lane interleaves
constexpr int kK = 8;              // a chain's terms formed at once
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxChunk = 4;       // second-level blocks staged at once
constexpr int kMinBlocks = 512;    // the grid a lag group is shrunk for
constexpr int kMinLags = 4;        // the smallest lag group
constexpr int kMaxN = 2048 * 1024;
constexpr int kMaxL = 4096;
constexpr size_t kSmemMax = 227 * 1024;
constexpr size_t kBarBytes = 16;   // block 0's mbarrier

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Blocks of one level of XLA's row-reduce over k values.
__host__ __device__ __forceinline__ int n_blocks(int k) {
  return k <= 32 ? 1 : cdiv(k, 32);
}

// The zeros XLA pads a level of k values with in front: block b covers
// [32 b, 32 b + 32) of the padded level.
__host__ __device__ __forceinline__ int lead(int k) {
  return k <= 32 ? 0 : ((32 - k % 32) % 32) / 2;
}

// First value and end of block b of a level of k values.
__host__ __device__ __forceinline__ int blk_lo(int k, int b) {
  const int v = 32 * b - lead(k);
  return v > 0 ? v : 0;
}

__host__ __device__ __forceinline__ int blk_hi(int k, int b) {
  const int v = 32 * b + 32 - lead(k);
  return v < k ? v : k;
}

// The launch's schedule (make_plan; tests/test_torch_dense_sxx.py models
// it).  Units are the blocks of the level the tiles own: second-level
// blocks (n2 <= 32) or third-level blocks.
struct Plan {
  int nyb, L;
  int n1, n2;        // first- and second-level blocks of the row
  int unit3;         // the tiles own third-level blocks
  int nu;            // units of the row: what block 0 reduces
  int C, upt;        // tiles (the cluster) and units a tile
  int G, P;          // lags a block, first-level blocks side by side
  int kc;            // second-level blocks staged at once
  int segcap;        // values a segment's slot holds
  int s2cap;         // second-level sums a tile holds
};

template <typename T>
size_t smem_bytes(const Plan& p) {
  return kBarBytes +
         sizeof(T) * (2 * static_cast<size_t>(p.P) * p.segcap +
                      static_cast<size_t>(32 * p.kc + p.s2cap + p.nu) * p.G);
}

template <typename T>
bool make_plan(int nyb, int L, int B, Plan* out) {
  Plan p = {};
  p.nyb = nyb;
  p.L = L;
  p.n1 = n_blocks(nyb);
  p.n2 = n_blocks(p.n1);
  p.unit3 = p.n2 > 32;
  p.nu = p.unit3 ? n_blocks(p.n2) : p.n2;
  p.upt = cdiv(p.nu, kMaxCluster);
  p.C = cdiv(p.nu, p.upt);
  p.s2cap = p.unit3 ? 32 * p.upt : p.upt;
  const int kc0 = p.s2cap < kMaxChunk ? p.s2cap : kMaxChunk;
  bool found = false;
  for (int g = L < 32 ? L : 32;;) {
    Plan q = p;
    q.G = g;
    q.P = 32 / g;
    for (q.kc = kc0; q.kc >= 1; --q.kc) {
      // a segment: its blocks, the group's largest lag, and room for its
      // bank offset p G < 32
      q.segcap = 32 * cdiv(32 * cdiv(32 * q.kc, q.P) + L, 32) + 32;
      if (smem_bytes<T>(q) <= kSmemMax) break;
    }
    if (q.kc >= 1) {
      *out = q;
      found = true;
      if (static_cast<long long>(B) * cdiv(L, g) * p.C >= kMinBlocks) break;
    }
    // a smaller group packs more segments, each staging the largest lag:
    // at most as many halo values as the chunk holds
    const int next = cdiv(g, 2) > kMinLags ? cdiv(g, 2) : kMinLags;
    if (g <= kMinLags || (32 / next) * L > 1024 * kc0) break;
    g = next;
  }
  return found;
}

// A chain from +0 over v[0], ..., v[n - 1] (n <= 32) in shared memory,
// every value loaded before the adds.
template <typename T>
__device__ __forceinline__ T chain32(const T* v, int stride, int n) {
  T r[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) r[i] = i < n ? v[i * stride] : T(0);
  T acc = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (i < n) acc = rn::add(acc, r[i]);
  return acc;
}

// Where segment q's slot begins: q G banks on from a multiple of 32
// values, so lane q G + j reads the bank after lane q G + j - 1's; a
// float64 value spans two banks, so a half-warp's 16 lanes fill the 32, and
// the packs of the second half-warp move one value more, which keeps their
// broadcast reads off the first half's banks.
template <typename T>
__device__ __forceinline__ int slot(int q, int segcap, int G) {
  return q * (segcap + G) + (sizeof(T) == 8 ? q * G / 16 : 0);
}

// Grid (C, lag groups, lanes), cluster (C, 1, 1): block r is tile r of
// lane blockIdx.z's row for lags blockIdx.y G + 1, ...  Shared memory: block
// 0's mbarrier, y's and d's P segment slots, the chunk's first-level sums
// [32 kc][G], the tile's second-level sums [s2cap][G] and, read in block 0,
// the row's unit sums [nu][G].
template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_sxx_kernel(const T* __restrict__ y, const T* __restrict__ d,
                 const int* __restrict__ nys, T* __restrict__ out,
                 const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* const bar =
      reinterpret_cast<unsigned long long*>(smem_raw);
  T* const ys = reinterpret_cast<T*>(smem_raw + kBarBytes);
  T* const dsm = ys + p.P * p.segcap;
  T* const s1 = dsm + p.P * p.segcap;
  T* const s2 = s1 + 32 * p.kc * p.G;
  T* const top = s2 + p.s2cap * p.G;
  const int r = blockIdx.x, lane_b = blockIdx.z;
  const int G = p.G, P = p.P;
  const int l0 = blockIdx.y * G;
  const int nl = min(G, p.L - l0);   // lags of this group
  const int hal = l0 + nl;           // its largest lag
  y += static_cast<size_t>(lane_b) * p.nyb;
  d += static_cast<size_t>(lane_b) * p.nyb;
  const int ny = nys[lane_b];
  const int lo1 = lead(p.nyb);
  // this tile's units and their second-level blocks [j0, j1)
  const int u0 = r * p.upt, u1 = min(u0 + p.upt, p.nu);
  if (p.C > 1) {
    // block 0 awaits the other tiles' unit sums
    if (r == 0 && threadIdx.x == 0)
      cl::bar_init(bar,
                   static_cast<unsigned>((p.nu - u1) * nl * sizeof(T)));
    cl::cluster_arrive_relaxed();
  }
  const int j0 = p.unit3 ? blk_lo(p.n2, u0) : u0;
  const int j1 = p.unit3 ? blk_hi(p.n2, u1 - 1) : u1;

  // lane = pack pk, lag l0 + jl + 1; idle lanes read pack 0's first lag
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool active = lane / G < P && lane % G < nl;
  const int pk = active ? lane / G : 0;
  const int jl = active ? lane % G : 0;
  const int lag = l0 + jl + 1;
  const int head = ny - 1 - lag;     // terms t <= head are kept
  const T* const yq = ys + slot<T>(pk, p.segcap, G);
  const T* const dq = dsm + slot<T>(pk, p.segcap, G);

  for (int c0 = j0; c0 < j1; c0 += p.kc) {
    const int c1 = min(c0 + p.kc, j1);
    const int bs = blk_lo(p.n1, c0), be = blk_hi(p.n1, c1 - 1);
    const int sp = cdiv(be - bs, P);   // first-level blocks a segment

    // stage segment q: its blocks' values and `hal` more, zeros off the
    // row; every copy in flight before the one wait
    for (int q = 0; q < P; ++q) {
      const int pb0 = bs + q * sp, pb1 = min(pb0 + sp, be);
      if (pb0 >= pb1) break;
      const int v0 = 32 * pb0 - lo1, len = 32 * (pb1 - pb0) + hal;
      T* const yd = ys + slot<T>(q, p.segcap, G);
      T* const dd = dsm + slot<T>(q, p.segcap, G);
      for (int i = threadIdx.x; i < len; i += kThreads) {
        const int t = v0 + i;
        if (t >= 0 && t < p.nyb) {
          cl::cp_async(yd + i, y + t);
          cl::cp_async(dd + i, d + t);
        } else {
          yd[i] = dd[i] = static_cast<T>(0);
        }
      }
    }
    cl::cp_wait();
    __syncthreads();

    // first level: warp w chains blocks w, w + kWarps, ... of every pack
    // (no branch in the chains: a block past the pack's is read at its
    // last block and not added)
    const int pb0 = bs + pk * sp;
    const int pnb = max(0, min(sp, be - pb0));
    for (int m0 = warp; m0 < sp; m0 += kWarps * kU) {
      T s[kU];
      int at[kU], t0[kU];
      bool live[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int m = m0 + u * kWarps, mc = min(m, sp - 1);
        at[u] = 32 * mc;
        t0[u] = 32 * (pb0 + mc) - lo1;
        live[u] = active & (m < pnb);
        s[u] = 0;
      }
      for (int k0 = 0; k0 < 32; k0 += kK) {
        T term[kU][kK];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
#pragma unroll
          for (int k = 0; k < kK; ++k) {
            const int i = at[u] + k0 + k;
            const T yl = yq[i + lag], dl = dq[i + lag];
            term[u][k] = rn::add(rn::mul(dq[i], rn::add(yl, dl)),
                                 rn::mul(yq[i], dl));
          }
        }
#pragma unroll
        for (int k = 0; k < kK; ++k) {
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int t = t0[u] + k0 + k;
            const bool keep = live[u] & (t >= 0) & (t <= head);
            s[u] = keep ? rn::add(s[u], term[u][k]) : s[u];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (live[u]) s1[(pb0 - bs + m0 + u * kWarps) * G + jl] = s[u];
    }
    __syncthreads();

    // second level: one thread a (lag, second-level block), in order
    for (int task = threadIdx.x; task < (c1 - c0) * G; task += kThreads) {
      const int jj = task % G, c = c0 + task / G;
      if (jj >= nl) continue;
      const int m0 = blk_lo(p.n1, c);
      s2[(c - j0) * G + jj] =
          chain32(s1 + (m0 - bs) * G + jj, G, blk_hi(p.n1, c) - m0);
    }
    __syncthreads();
  }

  // the tile's unit sums into block 0's `top` (st.async from the other
  // tiles, once block 0's mbarrier is set up)
  if (p.C > 1) cl::cluster_wait();
  for (int task = threadIdx.x; task < (u1 - u0) * G; task += kThreads) {
    const int jj = task % G, uu = u0 + task / G;
    if (jj >= nl) continue;
    T v;
    if (p.unit3) {
      const int c0 = blk_lo(p.n2, uu);
      v = chain32(s2 + (c0 - j0) * G + jj, G, blk_hi(p.n2, uu) - c0);
    } else {
      v = s2[(uu - j0) * G + jj];
    }
    if (r == 0)
      top[uu * G + jj] = v;
    else
      cl::push(top + uu * G + jj, v, bar, 0);
  }
  if (r != 0) return;
  // block 0: its own sums stored, one warp awaits the others and reduces
  __syncthreads();
  if (threadIdx.x >= 32) return;
  if (p.C > 1) cl::bar_wait(bar);
  for (int jj = threadIdx.x; jj < nl; jj += 32)
    out[static_cast<size_t>(lane_b) * p.L + l0 + jj] = rn::row_sum<T, true>(
        p.nu, [&](int i) { return top[i * G + jj]; });
}

template <typename T>
int launch(const void* y, const void* d, const void* nys, void* out, int nyb,
           int L, int B, void* stream) {
  Plan p;
  if (nyb < 1 || nyb > kMaxN || L < 1 || L > kMaxL || B < 1 || B > 65535 ||
      !make_plan<T>(nyb, L, B, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(p);
  auto kernel = dense_sxx_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C, cdiv(L, p.G), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(y), static_cast<const T*>(d),
      static_cast<const int*>(nys), static_cast<T*>(out), p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y, d [B, nyb], nys [B] int32, out [B, L]; contiguous; nyb <= 2048 * 1024,
// L <= 4,096.
int dense_sxx_f64(const void* y, const void* d, const void* nys, void* out,
                  int nyb, int L, int B, void* stream) {
  return launch<double>(y, d, nys, out, nyb, L, B, stream);
}

int dense_sxx_f32(const void* y, const void* d, const void* nys, void* out,
                  int nyb, int L, int B, void* stream) {
  return launch<float>(y, d, nys, out, nyb, L, B, stream);
}

}  // extern "C"
