// Eq. 8 (Algorithm 2) single-delta impacts with the deviation measure
// reduced in the kernel: out[p] = D(ACF after adding dval[p] at
// y[p / kappa], p0), for every candidate p.
//
// Replaces the TPU kernel src/repro/kernels/acf_impact.py:acf_impact_pallas
// (body acf_impact_kernel), generalised to a runtime valid length ny (read
// from a device scalar, so the round loop needs no host sync) and to the
// x-to-y index map yi = p / kappa of Def. 2.  It serves the per-round
// single_impacts pass of the rounds mode in float (src/repro/core/
// cameo.py:336-344) and the sequential mode's init_impacts in double
// (cameo.py:828-834, the config's dtype), so it is one template for both.
// Its plain version is ref.acf_after_single_delta followed by
// ref.measure_rows, whose arithmetic it repeats operation for operation.
//
// Bound on the H100: ~22 operations per (candidate, lag) against 12 bytes
// read and written per candidate, so the work is bound by operations
// (P = 18,432, L = 48: 20 MFLOP against 0.2 MB), and at this size by the
// launch (PERF.md has the card's numbers).  Each lag ends in a correctly
// rounded root and divide: ~60 instructions in float.  The first form, one
// thread per candidate chaining its L lags, ran uk_elec's 18,432
// candidates as 72 blocks on 72 SMs, 8 warps each, bound by that chain's
// latency, while aus_elec's 245,760 filled every SM with 56-64 warps and
// were bound by instruction throughput (tools/acf_impact_phases.py and
// PERF.md, on an NVIDIA H100 80GB HBM3 at 700 W).
//
// Design:
// - Lanes.  A candidate's lags are spread over lanes only as far as the
//   card needs filling, since spreading adds instructions (placement,
//   staging, a reduction) to a fixed count of lag work.  A launch takes one
//   lane a lag where its threads still fit the card at once (the occupancy
//   API's blocks an SM, times the SMs), else the most lanes a candidate, a
//   power of two with at least two lags a lane, that fit: uk_elec's 18,432
//   float candidates (L = 48) get 8 lanes, its 4,096 double ones 16,
//   aus_elec's 4,800 (L = 7) one lane a lag and its 245,760 one lane.
//   Candidates are placed as the Eq. 9 window kernels place theirs
//   (window.cuh: win::plan, win::slot, with the lanes a candidate for its
//   lag count): at up to 32 lanes floor(32 / lanes) candidates share a
//   warp, past that a candidate takes whole warps (at most 256 threads).
//   Lane r takes lags r + 1, r + 1 + G, ... (G lanes a candidate).
// - Staging.  A block first copies what its lanes read into shared memory:
//   the table and p0 transposed (a lag's six values side by side) and the y
//   values its candidates reach, y[yi - L, yi + L] (zero outside [0, nyb),
//   which is the plain version's padding), so a lag reads six adjacent
//   table values and two y values from shared memory, with no bounds test.
//   Consecutive candidates share a block, so at kappa > 1 those with one yi
//   read the same y values.
// - Reduction.  With one lane a candidate (kSolo) the thread reduces its
//   lags' measure terms as it forms them (rn::reduce_terms: cheb their max,
//   mae and rmse in XLA's row-reduce order).  Otherwise each lane stores
//   its lags' terms in shared memory (rows of odd stride, so the reducers'
//   loads do not collide) and, after one more barrier, thread c of the
//   block reduces candidate c's terms the same way (win::reduce_lags).
// - Lanes.  A batch of B series (y [B, nyb], dval [B, P], table [B, 5, L],
//   p0 [B, L], ny [B] -> out [B, P]) is one launch: grid row blockIdx.y is
//   a series, and the lanes a candidate are chosen for all B P candidates.
//   No output depends on that choice (every form reduces in one order), so
//   each series gets the bits of its launch alone.
// yi = p / kappa is a multiply and a shift by a constant formed on the
// host.  Every product and sum is rounded on its own (rn.cuh, no fused
// multiply-add) and every sum runs in the plain version's order, so the
// output equals the plain version bit for bit.  The "// --" markers in the
// kernel are the phase anchors tools/acf_impact_phases.py instruments.
#include <cuda_runtime.h>

#include "rn.cuh"
#include "window.cuh"

namespace {

__device__ __forceinline__ int y_index(int p, unsigned long long kmul,
                                       int kshift) {
  return static_cast<int>((static_cast<unsigned long long>(p) * kmul) >>
                          kshift);
}

template <typename T, bool kSolo>
__global__ void __launch_bounds__(win::kBlock)
acf_impact_kernel(const T* __restrict__ y, const T* __restrict__ dval,
                  const T* __restrict__ table, const T* __restrict__ p0,
                  const int* __restrict__ ny_ptr, T* __restrict__ out, int P,
                  int nyb, int L, unsigned long long kmul, int kshift,
                  int measure, int lanes, int G, int cpu, int cpb, int M,
                  int S) {
  extern __shared__ unsigned char sm_raw[];
  // tab [L, 6]: lag l's table column and p0 at tab[6 (l - 1) ..]; ys: the
  // block's y values, ys[i] = y[y0 + i]; rows [cpb, S]: the lags' terms
  T* tab = reinterpret_cast<T*>(sm_raw);
  T* ys = tab + 6 * L;
  T* rows = ys + cpb + 2 * L + 2;
  // this grid row's series
  const size_t series = blockIdx.y;
  y += series * nyb;
  dval += series * P;
  table += series * 5 * L;
  p0 += series * L;
  ny_ptr += series;
  out += series * P;
  const win::Slot sl = win::slot(lanes, G, cpu, M);
  const int first = blockIdx.x * cpb;
  const int y0 = y_index(first, kmul, kshift) - L;
  const int nys = y_index(min(first + cpb, P) - 1, kmul, kshift) + L + 1 - y0;
  // -- staging
  for (int i = threadIdx.x; i < 6 * L; i += blockDim.x) {
    const int q = i / L, l = i - q * L;
    tab[6 * l + q] = q < 5 ? table[i] : p0[l];
  }
  for (int i = threadIdx.x; i < nys; i += blockDim.x) {
    const int g = y0 + i;
    ys[i] = g >= 0 && g < nyb ? y[g] : static_cast<T>(0);
  }
  const int ny = *ny_ptr;
  const int p = first + sl.cand;
  const bool live = sl.active && p < P;
  const T d = live ? dval[p] : static_cast<T>(0);
  // -- barrier
  __syncthreads();
  T acc = 0;   // kSolo: this thread's candidate's deviation
  if (live) {
    // -- lag terms
    const T* yc = ys + (y_index(p, kmul, kshift) - y0);  // yc[j] = y[yi + j]
    const int yi = y0 + static_cast<int>(yc - ys);
    const T e = rn::mul(d, rn::add(static_cast<T>(2) * yc[0], d));
    // the measure's term of lag l
    const auto term = [=](int l) {
      const T* tl = tab + 6 * (l - 1);
      const T head = yi <= ny - 1 - l ? 1 : 0;
      const T tail = yi >= l ? 1 : 0;
      const T sx = rn::add(tl[0], rn::mul(d, head));
      const T sxl = rn::add(tl[1], rn::mul(d, tail));
      const T sx2 = rn::add(tl[2], rn::mul(e, head));
      const T sxl2 = rn::add(tl[3], rn::mul(e, tail));
      const T inner = rn::add(rn::mul(yc[l], head), rn::mul(yc[-l], tail));
      const T sxx = rn::add(tl[4], rn::mul(d, inner));
      const T rho = rn::acf_rho(sx, sxl, sx2, sxl2, sxx,
                                static_cast<T>(ny - l));
      return rn::measure_term(measure, rn::sub(rho, tl[5]));
    };
    if constexpr (kSolo) {
      acc = rn::reduce_terms<T, false>(measure, L,
                                       [=](int c) { return term(c + 1); });
    } else {
      T* row = rows + sl.cand * S;
      for (int l = sl.r + 1; l <= L; l += G) row[l - 1] = term(l);
    }
  }
  // -- reduce
  const int pc = kSolo ? p : first + static_cast<int>(threadIdx.x);
  const bool me =
      kSolo ? live : static_cast<int>(threadIdx.x) < cpb && pc < P;
  if constexpr (!kSolo) {
    __syncthreads();
    acc = win::reduce_lags(measure, L, me, rows + threadIdx.x * S);
  }
  // -- store
  if (me) out[pc] = rn::measure_final(measure, acc, L);
  // -- end
}

template <typename T, bool kSolo>
int launch_plan(const void* y, const void* dval, const void* table,
                const void* p0, const void* ny, void* out, int P, int nyb,
                int L, int kappa, int measure, int lanes, int B,
                void* stream) {
  // shared memory: the table [6 L] and y's reach (at most cpb + 2 L + 2
  // values) fixed, one y value and (unless kSolo) a row of S terms a
  // candidate
  const int S = L | 1;
  win::Plan pl;
  cudaError_t err = win::plan(P, lanes, ((kSolo ? 0 : S) + 1) * sizeof(T),
                              &pl, (8 * L + 2) * sizeof(T), B);
  auto kernel = acf_impact_kernel<T, kSolo>;
  if (err == cudaSuccess) err = win::allow_smem(kernel, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // p / kappa for 0 <= p < 2^31 as (p * kmul) >> kshift: kshift = 31 +
  // ceil(log2 kappa), kmul = floor(2^kshift / kappa) + 1 (exact; Hacker's
  // Delight, 10-9)
  int lg = 0;
  while ((1ll << lg) < kappa) ++lg;
  const int kshift = 31 + lg;
  const unsigned long long kmul = (1ull << kshift) / kappa + 1;
  kernel<<<dim3(pl.blocks, B), pl.threads, pl.smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(dval),
      static_cast<const T*>(table), static_cast<const T*>(p0),
      static_cast<const int*>(ny), static_cast<T*>(out), P, nyb, L, kmul,
      kshift, measure, lanes, pl.G, pl.cpu, pl.cpb, pl.M, S);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* y, const void* dval, const void* table, const void* p0,
           const void* ny, void* out, int P, int nyb, int L, int kappa,
           int measure, int B, void* stream) {
  if (P < 1 || L < 1 || kappa < 1 || B < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // the threads the card holds at once: its SMs times the blocks of
  // win::kBlock an SM keeps resident
  int n_sm = 0, resident = 0;
  cudaError_t err = win::sm_count(&n_sm);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, acf_impact_kernel<T, false>, win::kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fill = static_cast<long long>(resident) * win::kBlock * n_sm;
  // one lane a lag takes 32 / floor(32 / L) threads a candidate at L <= 32,
  // whole warps past that
  const int warps = (L + 31) / 32 < win::kBlock / 32 ? (L + 31) / 32
                                                      : win::kBlock / 32;
  const long long per_lag = L <= 32 ? 32 / (32 / L) : 32 * warps;
  const long long all = static_cast<long long>(B) * P;  // every series'
  int lanes = L;
  if (all * per_lag > fill) {
    lanes = 1;
    while (4 * lanes <= L && all * lanes * 2 <= fill) lanes *= 2;
  }
  if (lanes == 1)
    return launch_plan<T, true>(y, dval, table, p0, ny, out, P, nyb, L, kappa,
                                measure, lanes, B, stream);
  return launch_plan<T, false>(y, dval, table, p0, ny, out, P, nyb, L, kappa,
                               measure, lanes, B, stream);
}

}  // namespace

// B series, each [nyb] / [P] / [5, L] / [L] / one ny, back to back.
extern "C" int acf_impact_f32(const void* y, const void* dval,
                              const void* table, const void* p0,
                              const void* ny, void* out, int P, int nyb,
                              int L, int kappa, int measure, int B,
                              void* stream) {
  return launch<float>(y, dval, table, p0, ny, out, P, nyb, L, kappa, measure,
                       B, stream);
}

extern "C" int acf_impact_f64(const void* y, const void* dval,
                              const void* table, const void* p0,
                              const void* ny, void* out, int P, int nyb,
                              int L, int kappa, int measure, int B,
                              void* stream) {
  return launch<double>(y, dval, table, p0, ny, out, P, nyb, L, kappa,
                        measure, B, stream);
}
