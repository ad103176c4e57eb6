// The prefix walk of one scan round: K rank-ordered candidate deltas
// d_k = dyws[k, :Wy] * ok[k] at s_k = clip(ystarts[k], 0, nyb - 1) on the
// zero-padded target series y (valid length ny, a device scalar), taken in
// order against the running reconstruction z and the running moment table.
// out[k] is candidate k's trial deviation from p0 (0 mae, 1 rmse, 2 cheb)
// on top of what was committed before it; then the candidate commits to z
// and to the table: always (greedy = 0, the prefix deviation curve) or only
// where ok[k] and out[k] <= eps (greedy = 1, the scan mode's selection).
//
// Replaces the TPU kernel src/repro/kernels/fused_round.py:
// prefix_devs_pallas (body _prefix_scan_kernel), one grid step holding z in
// VMEM scratch.  Its plain version is fused_round.prefix_devs_plain, whose
// index rules it follows: the head/tail masks test s_k + j against ny,
// z[i] = y[i - L] (zero outside [0, nyb)), d[j + l] is zero past the window.
//
// Bound on the H100: the function needs per ok candidate and lag ~4 Wy + 22
// flops and ~6 Wy per ok candidate with the commit of z; a rank that is
// not ok adds a zero delta, so its output is the committed deviation and
// it needs no window work, only its store.  But the walk is sequential in
// the ok ranks — each trial reads the z and table the previous commit
// wrote — so the kernel is bound by the latency of its dependent steps on
// one SM, not by the card's rate (PERF.md has the card's numbers).
//
// Design: one block walks the K ranks in chunks of kChunk, one thread per
// lag (ceil(L / 32) warps; lane c of the block owns lag c + 1) up to
// kMaxThreads; past that thread c also takes lags c + 1 + NT, c + 1 + 2 NT,
// ... (NT = kMaxThreads threads).
// - Skip.  A block-wide prefix count of ok over the chunk lists its ok
//   ranks in shared memory; only those are walked.  dev_c, the deviation
//   of the committed table (formed at the start with the same rounded
//   operations as a trial with zero sums), becomes an ok rank's trial
//   deviation where it commits.  One parallel pass at the end of the chunk
//   gives every other rank the dev_c recorded after the last ok rank
//   before it.  A zero delta would leave z and the table equal up to the
//   sign of a zero, which no output can see (every measure takes |.| or a
//   square of each lag's term), so skipping it changes no bit.
// - Prefetch.  The next ok rank's start and delta row are copied into the
//   other half of a double buffer in shared memory with cp.async while the
//   current rank is walked, so a step reads its d from shared memory.
// - Interior fast path (L <= s and s + Wy + L <= ny: every head and tail
//   mask is 1, and multiplying by 1 is exact).  The sums of d and of
//   e = d (2 z + d) are the same for every lag: they run once in each
//   warp's instruction stream.  Each thread forms its lag's Wy products
//   d_j ((z[j + l] + z[j - l]) + d[j + l]) in registers and sums them
//   beside the sums of d and e.  Boundary candidates stage e in shared
//   memory and take the five masked sums of rn::window_term<false> (the
//   Pallas body's association) for each lag.  Every window sum runs in
//   XLA's row-reduce order (rn::row_sums: up to 32 terms a chain from +0,
//   past that blocks of 32), the order of the Pallas body's jnp.sum and of
//   the plain version.  (Forming all L x Wy products across the block into
//   shared memory, then one chain per lag from there, took longer on the
//   card: PERF.md.)
// - Decision.  Each thread keeps its first lag's committed moments in
//   registers, forms the trial moments and the Eq. 2 entry, and posts its
//   lag's term of the measure in shared memory.  The moments of the lags
//   past NT (L > kMaxThreads only) sit in a global scratch buffer,
//   committed and trial side by side, and a commit swaps the two halves;
//   shared memory stays for z, so no lag count outgrows it.  After one
//   barrier every thread reduces the terms (cheb as a max, exact; NaN wins,
//   as torch.amax; mae and rmse by rn::row_sum, XLA's row-reduce order,
//   the plain version's), so all hold the deviation and the decision.  A
//   step costs two barriers,
//   __syncwarp in the one-warp block of L <= 32 (aus_elec's L = 7).
// z (nyb + 2L + Wy values) sits in dynamic shared memory while it fits the
// block's 227 KB (the launcher raises the 48 KB default), else in a global
// scratch buffer (a second instantiation).  Every product and sum is
// rounded on its own (rn.cuh) and runs in the plain version's order, so the
// output equals the plain version bit for bit.
// Lanes: a batch of B series (y [B, nyb], dyws [B, K, Wy], ystarts and ok
// [B, K], table [B, 5, L], p0 [B, L], ny and eps [B] -> out [B, K]) is one
// launch of B blocks, block b walking series b with its own zstride values
// of scratch; each series gets the bits of its launch alone.
#include <cuda_runtime.h>

#include "rn.cuh"

namespace {

constexpr int kChunk = 1024;   // ranks compacted at a time (fused_round.py)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 512;  // one thread per lag up to here, <= 128
                                  // registers each

template <bool kWarp>
__device__ __forceinline__ void block_sync() {
  if constexpr (kWarp) __syncwarp(); else __syncthreads();
}

// max that keeps a NaN, as torch.amax does
template <typename T>
__device__ __forceinline__ T max_nan(T m, T a) {
  return (a != a || a > m) ? a : m;
}

// One value from device memory into shared memory, without waiting:
// cp_wait() before a barrier makes it visible.
template <typename V>
__device__ __forceinline__ void cp_async(V* smem, const V* gmem) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8, "4 or 8 bytes");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(sizeof(V)));
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// kWarp: one warp (L <= 32); else blockDim.x = 32 ceil(L / 32) threads, at
// most kMaxThreads.  kMulti (L > kMaxThreads): the lags past the block's
// first NT keep their moments in the global scratch after z.
template <typename T, bool kWarp, bool ZS, bool kMulti>
__global__ void __launch_bounds__(kWarp ? 32 : kMaxThreads)
prefix_devs_kernel(const T* __restrict__ y, const T* __restrict__ dyws,
                   const int* __restrict__ ystarts,
                   const unsigned char* __restrict__ ok,
                   const T* __restrict__ table, const T* __restrict__ p0,
                   const int* __restrict__ ny_ptr,
                   const T* __restrict__ eps_ptr, T* __restrict__ out, T* zg,
                   size_t zstride, int K, int Wy, int nyb, int L, int measure,
                   int greedy) {
  // this block's series
  const size_t series = blockIdx.x;
  y += series * nyb;
  dyws += series * K * Wy;
  ystarts += series * K;
  ok += series * K;
  table += series * 5 * L;
  p0 += series * L;
  ny_ptr += series;
  eps_ptr += series;
  out += series * K;
  zg += series * zstride;
  const int NT = kWarp ? 32 : blockDim.x;
  const int NW = NT / 32;
  const int PT = (kChunk + NT - 1) / NT;   // ranks a thread compacts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int zlen = nyb + 2 * L + Wy;

  extern __shared__ __align__(16) unsigned char sm_raw[];
  T* vals = reinterpret_cast<T*>(sm_raw);  // [L] the lags' terms
  T* dst = vals + L;                       // [2, Wy] staged deltas
  T* e = dst + 2 * Wy;                     // [Wy] (boundary candidates)
  T* devc_after = e + Wy;                  // [kChunk] dev_c after ok rank i
  T* zs = devc_after + kChunk;             // [zlen] where ZS
  unsigned short* list =                   // [kChunk] the chunk's ok ranks
      reinterpret_cast<unsigned short*>(zs + (ZS ? zlen : 0));
  unsigned short* cnt = list + kChunk;     // [kChunk] ok ranks before each
  T* z = ZS ? zs : zg;
  // kMulti: lag l > NT's moment q, committed in half cur and trial in half
  // cur ^ 1, at mom[(half * 5 + q) * E + l - 1 - NT]
  const int E = L - NT;
  T* mom = zg + (ZS ? 0 : zlen);
  int cur = 0;
  __shared__ int s_stage[2];               // staged starts, unclipped
  __shared__ int wtot[32];
  __shared__ T devc_start;

  for (int i = tid; i < zlen; i += NT)
    z[i] = (i >= L && i < L + nyb) ? y[i - L] : static_cast<T>(0);
  const int ny = *ny_ptr;
  const T eps = *eps_ptr;
  // this thread's lag (threads past L shadow the last one) and its
  // committed moments
  const bool mine = tid < L;
  const int lw = min(tid, L - 1) + 1;
  T ag[5];
  for (int q = 0; q < 5; ++q) ag[q] = table[q * L + lw - 1];
  const T p0w = p0[lw - 1];
  if constexpr (kMulti)
    for (int x = tid; x < E; x += NT)
      for (int q = 0; q < 5; ++q) mom[q * E + x] = table[q * L + NT + x];
  block_sync<kWarp>();

  // a lag l > NT of this thread: its trial moments from its window sums a
  // (into the other half of mom) and its term of the measure
  auto post_extra = [&](int l, const T* a) {
    const int x = l - 1 - NT;
    T t[5];
    for (int q = 0; q < 5; ++q) {
      t[q] = rn::add(mom[(cur * 5 + q) * E + x], a[q]);
      mom[((cur ^ 1) * 5 + q) * E + x] = t[q];
    }
    const T df = rn::sub(rn::acf_rho(t[0], t[1], t[2], t[3], t[4],
                                     static_cast<T>(ny - l)),
                         p0[l - 1]);
    vals[l - 1] = measure == 1 ? rn::mul(df, df) : fabs(df);
  };

  // the trial moments t of this thread's lag from its window sums a, and
  // the deviation, which every thread reduces over the lags' terms
  auto deviation = [&](const T* a, T* t) -> T {
    for (int q = 0; q < 5; ++q) t[q] = rn::add(ag[q], a[q]);
    const T df = rn::sub(rn::acf_rho(t[0], t[1], t[2], t[3], t[4],
                                     static_cast<T>(ny - lw)),
                         p0w);
    const T v = measure == 1 ? rn::mul(df, df) : fabs(df);
    if (mine) vals[tid] = v;
    block_sync<kWarp>();
    const auto val = [=](int c) { return vals[c]; };
    const T acc =
        measure == 2
            ? rn::chain<T, true>([](T m, T a) { return max_nan(m, a); }, val,
                                 0, L)
            : rn::row_sum<T, true>(L, val);
    return rn::measure_final(measure, acc, L);
  };

  // stage ok rank k's start and delta row into slot b (asynchronous)
  auto stage = [&](int k, int b) {
    if (tid == 0) cp_async(s_stage + b, ystarts + k);
    for (int j = tid; j < Wy; j += NT)
      cp_async(dst + b * Wy + j, dyws + static_cast<size_t>(k) * Wy + j);
  };

  T dev_c;   // the committed table's deviation
  {
    const T a[5] = {0, 0, 0, 0, 0};
    if constexpr (kMulti)
      for (int l = lw + NT; l <= L; l += NT) post_extra(l, a);
    T t[5];
    dev_c = deviation(a, t);
  }

  for (int base = 0; base < K; base += kChunk) {
    const int n = min(kChunk, K - base);
    // the previous chunk's fill is done with devc_start, cnt and devc_after
    block_sync<kWarp>();
    if (tid == 0) devc_start = dev_c;
    // list the chunk's ok ranks: per-thread counts, a warp scan, warp totals
    unsigned bits = 0;
    int c = 0;
    for (int r = 0; r < PT; ++r) {
      const int p = tid * PT + r;
      const unsigned v = p < n ? ok[base + p] : 0;
      bits |= (v != 0) << r;
      c += v != 0;
    }
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += v;
    }
    if (lane == 31) wtot[warp] = x;
    block_sync<kWarp>();
    int run = x - c, n_ok = 0;
    for (int w = 0; w < NW; ++w) {
      if (w < warp) run += wtot[w];
      n_ok += wtot[w];
    }
    for (int r = 0; r < PT; ++r) {
      const int p = tid * PT + r;
      if (p < n) {
        cnt[p] = static_cast<unsigned short>(run);
        if (bits >> r & 1u) list[run++] = static_cast<unsigned short>(p);
      }
    }
    block_sync<kWarp>();
    if (n_ok > 0) {
      stage(base + list[0], 0);
      cp_wait();
    }
    block_sync<kWarp>();

    for (int i = 0; i < n_ok; ++i) {
      const int b = i & 1;
      const int s = min(max(s_stage[b], 0), nyb - 1);
      const T* d = dst + b * Wy;
      // the next ok rank, copied while this one is walked
      if (i + 1 < n_ok) stage(base + list[i + 1], b ^ 1);
      T* zc = z + s + L;
      T a[5];
      if (s >= L && s + Wy + L <= ny) {
        // interior: this lag's products, summed over the window with the
        // sums of d and e, in XLA's row-reduce order
        T s3[3];
        rn::row_sums<T, 3>(
            Wy,
            [&](int j, T v[3]) {
              const T dj = d[j];
              const T df = j + lw < Wy ? d[j + lw] : static_cast<T>(0);
              v[0] = dj;
              v[1] = rn::mul(dj, rn::add(static_cast<T>(2) * zc[j], dj));
              v[2] = rn::mul(dj, rn::add(rn::add(zc[j + lw], zc[j - lw]),
                                         df));
            },
            s3);
        a[0] = a[1] = s3[0];
        a[2] = a[3] = s3[1];
        a[4] = s3[2];
        if constexpr (kMulti)
          for (int l = lw + NT; l <= L; l += NT) {
            // lag l's products, summed as this lag's are
            T ax[5] = {s3[0], s3[0], s3[1], s3[1], 0};
            rn::row_sums<T, 1>(
                Wy,
                [&](int j, T v[1]) {
                  const T df = j + l < Wy ? d[j + l] : static_cast<T>(0);
                  v[0] = rn::mul(d[j], rn::add(rn::add(zc[j + l], zc[j - l]),
                                               df));
                },
                ax + 4);
            post_extra(l, ax);
          }
      } else {
        for (int j = tid; j < Wy; j += NT)
          e[j] = rn::mul(d[j], rn::add(static_cast<T>(2) * zc[j], d[j]));
        block_sync<kWarp>();
        auto sums = [&](int l, T out5[5]) {
          rn::row_sums<T, 5>(
              Wy,
              [&](int j, T v[5]) {
                rn::window_term<false>(zc, d, e, Wy, s, j, l, ny, v);
              },
              out5);
        };
        sums(lw, a);
        if constexpr (kMulti)
          for (int l = lw + NT; l <= L; l += NT) {
            T ax[5];
            sums(l, ax);
            post_extra(l, ax);
          }
      }
      T t[5];
      const T dev = deviation(a, t);
      const bool take = !greedy || dev <= eps;
      if (take) {
        dev_c = dev;
        for (int q = 0; q < 5; ++q) ag[q] = t[q];
        if constexpr (kMulti) cur ^= 1;
      }
      if (tid == 0) {
        out[base + list[i]] = dev;
        devc_after[i] = dev_c;
      }
      if (take)
        for (int j = tid; j < Wy; j += NT) zc[j] = rn::add(zc[j], d[j]);
      cp_wait();
      block_sync<kWarp>();
    }

    // every rank that is not ok: the committed deviation at its position
    for (int p = tid; p < n; p += NT) {
      const int cp = cnt[p];
      const int cn = p + 1 < n ? cnt[p + 1] : n_ok;
      if (cn == cp) out[base + p] = cp == 0 ? devc_start : devc_after[cp - 1];
    }
  }
}

template <typename T, bool kWarp, bool ZS, bool kMulti>
int launch_block(const void* y, const void* dyws, const void* ystarts,
                 const void* ok, const void* table, const void* p0,
                 const void* ny, const void* eps, void* out, void* scratch,
                 size_t zstride, int K, int Wy, int nyb, int L, int measure,
                 int greedy, int B, int threads, size_t smem, void* stream) {
  auto kernel = prefix_devs_kernel<T, kWarp, ZS, kMulti>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(dyws),
      static_cast<const int*>(ystarts),
      static_cast<const unsigned char*>(ok), static_cast<const T*>(table),
      static_cast<const T*>(p0), static_cast<const int*>(ny),
      static_cast<const T*>(eps), static_cast<T*>(out),
      static_cast<T*>(scratch), zstride, K, Wy, nyb, L, measure, greedy);
  return static_cast<int>(cudaGetLastError());
}

// The wrapper (fused_round.prefix_devs_cuda) decides use_smem from the same
// layout and sizes scratch, for each of the B series: z where use_smem is
// 0, then 10 (L - kMaxThreads) moments where L > kMaxThreads.
template <typename T>
int launch(const void* y, const void* dyws, const void* ystarts,
           const void* ok, const void* table, const void* p0, const void* ny,
           const void* eps, void* out, void* scratch, int K, int Wy, int nyb,
           int L, int measure, int greedy, int use_smem, int B,
           void* stream) {
  if (L < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(32 * ((L + 31) / 32), kMaxThreads);
  const size_t zstride =
      (use_smem ? 0 : static_cast<size_t>(nyb) + 2 * L + Wy) +
      (L > kMaxThreads ? 10 * static_cast<size_t>(L - kMaxThreads) : 0);
  size_t smem = (L + 3 * Wy + kChunk) * sizeof(T) +
                2 * kChunk * sizeof(unsigned short);
  if (use_smem) smem += (nyb + 2 * L + Wy) * sizeof(T);
#define PREFIX_DEVS_LAUNCH(W, Z, X)                                          \
  launch_block<T, W, Z, X>(y, dyws, ystarts, ok, table, p0, ny, eps, out,   \
                           scratch, zstride, K, Wy, nyb, L, measure, greedy, \
                           B, threads, smem, stream)
  if (threads == 32)
    return use_smem ? PREFIX_DEVS_LAUNCH(true, true, false)
                    : PREFIX_DEVS_LAUNCH(true, false, false);
  if (L > kMaxThreads)
    return use_smem ? PREFIX_DEVS_LAUNCH(false, true, true)
                    : PREFIX_DEVS_LAUNCH(false, false, true);
  return use_smem ? PREFIX_DEVS_LAUNCH(false, true, false)
                  : PREFIX_DEVS_LAUNCH(false, false, false);
#undef PREFIX_DEVS_LAUNCH
}

}  // namespace

// out is [B, K] trial deviations; scratch holds, for each series, z when
// use_smem is 0, then the moments of the lags past kMaxThreads.
extern "C" int prefix_devs_f32(const void* y, const void* dyws,
                               const void* ystarts, const void* ok,
                               const void* table, const void* p0,
                               const void* ny, const void* eps, void* out,
                               void* scratch, int K, int Wy, int nyb, int L,
                               int measure, int greedy, int use_smem, int B,
                               void* stream) {
  return launch<float>(y, dyws, ystarts, ok, table, p0, ny, eps, out, scratch,
                       K, Wy, nyb, L, measure, greedy, use_smem, B, stream);
}

extern "C" int prefix_devs_f64(const void* y, const void* dyws,
                               const void* ystarts, const void* ok,
                               const void* table, const void* p0,
                               const void* ny, const void* eps, void* out,
                               void* scratch, int K, int Wy, int nyb, int L,
                               int measure, int greedy, int use_smem, int B,
                               void* stream) {
  return launch<double>(y, dyws, ystarts, ok, table, p0, ny, eps, out,
                        scratch, K, Wy, nyb, L, measure, greedy, use_smem, B,
                        stream);
}
