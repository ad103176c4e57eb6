// Eq. 9 tier ranking: for each of K candidate delta windows d[k, :Wy]
// starting at ystarts[k] on the zero-padded target series y (valid length
// ny, a device scalar), the hypothetical ACF row [L] after that delta alone,
// reduced to its deviation from p0 (measure 0 mae, 1 rmse, 2 cheb): out[K].
//
// Replaces the TPU kernel src/repro/kernels/fused_round.py:window_rows_pallas
// (body _window_rows_kernel), which walked the K candidates in order on one
// core with the padded series in VMEM and wrote the rows; the rounds mode
// reduces them with ref.measure_rows, which this kernel does in place.  Its
// plain version is fused_round.window_acf_rows (mask-free, padded-bucket
// form) followed by ref.measure_rows, whose index rules this kernel follows:
// the context is gathered at the start clipped into [0, nyb)
// (fused_round.py:149-151), the head/tail cuts use the unclipped start, and
// the bilinear term needs no mask because y is zero outside [0, ny).
//
// Bound on the H100: per (candidate, lag) the function needs ~4 Wy + 24
// flops (the bilinear sum, then the five moments, Eq. 2 and the measure)
// against (Wy + 1) * 4 bytes per candidate, so it is bound by operations;
// at the main-path sizes (K = 768 x Wy 8, K = 384 x Wy 64, L = 48) that is
// a few MFLOP, well under a microsecond, so a launch's latency and one
// candidate's dependent chain dominate (PERF.md has the card's numbers).
//
// Design (as acf_window_impact.cu, through window.cuh): one thread per lag,
// floor(32 / L) candidates a warp at L <= 32 (aus_elec's L = 7: 4 a warp,
// so its tier of 10,240 fits one wave of 256-thread blocks), ceil(L / 32)
// warps a candidate past that.  One staging pass: each lane issues its
// start, ny, its lag's table column and p0 entry up front, then gathers
// its share of the context; the lane that gathers z[i] inside the window
// also copies d[i] and forms e[i] = d (2 z + d); d is padded with L zeros.
// One barrier (__syncwarp at L <= 32).  Each lane then walks the window
// once for its lag: the prefix sums of d and e in XLA's cumsum order
// (groups of 16 chained from +0, each partial plus the totals of the
// groups before its own: the reference's jnp.cumsum over the window axis),
// read at its head and tail cuts ch and ct, and its bilinear terms
// d[j] ((z[j + l] + z[j - l]) + d[j + l]) in XLA's row-reduce order
// (blocks of rn::row_block chained from +0, the block sums chained: the
// reference's jnp.sum over the window); it stores its lag's measure term,
// and the candidate's first lane reduces the terms (win::reduce_lags,
// XLA's row-reduce order) after one more barrier.  Tiny = 1e-30 in Eq. 2
// (fused_round.py:236).  Products are rounded on their own (rn.cuh, no
// fused multiply-add) and every sum runs in the plain version's order, so
// the output equals it bit for bit.  An interior candidate (every head and
// tail mask 1) walks the same sums without the cuts, a group of 16 at a
// time.  Windows of up to 256 values (the cumsum's two levels).  (A first
// form had two lanes write the prefix sums to shared memory behind one more
// barrier: 1.2-1.8x the time of the chained form before it, against
// 0.98-1.47x for this walk; PERF.md.)
// Lanes: a batch of B series (dyws [B, K, Wy], ystarts [B, K], y [B, nyb],
// table [B, 5, L], ny [B], p0 [B, L] -> out [B, K]) is one launch, grid
// row blockIdx.y a series, the packing planned for all B K candidates;
// each series gets the bits of its launch alone.
#include <cuda_runtime.h>

#include "rn.cuh"
#include "window.cuh"

namespace {

__global__ void __launch_bounds__(win::kBlock)
window_rows_kernel(const float* __restrict__ dyws,
                   const int* __restrict__ ystarts,
                   const float* __restrict__ y,
                   const float* __restrict__ table,
                   const int* __restrict__ ny_ptr,
                   const float* __restrict__ p0, float* __restrict__ out,
                   int K, int Wy, int nyb, int L, int measure, int G,
                   int cpu, int cpb, int M) {
  extern __shared__ float sm[];
  // this grid row's series
  const size_t series = blockIdx.y;
  dyws += series * K * Wy;
  ystarts += series * K;
  y += series * nyb;
  table += series * 5 * L;
  ny_ptr += series;
  p0 += series * L;
  out += series * K;
  const win::Slot sl = win::slot(L, G, cpu, M);
  const int k = blockIdx.x * cpb + sl.cand;
  const bool live = sl.active && k < K;
  const int C = Wy + 2 * L;
  // per candidate: ctx [C] (ctx[i] = y[s - L + i]), d [Wy + L] (zeros past
  // Wy), e [Wy], row [L]
  float* ctx = sm + sl.cand * (3 * Wy + 4 * L);
  float* d = ctx + C;
  float* e = d + Wy + L;
  float* row = e + Wy;
  const int l0 = sl.r + 1;

  int ys = 0, ny = 0;
  float tab[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, pz = 0.0f;
  auto lag_loads = [&](int l) {
    for (int q = 0; q < 5; ++q) tab[q] = table[q * L + l - 1];
    pz = p0[l - 1];
  };
  if (live) {
    ys = ystarts[k];
    ny = *ny_ptr;
    if (l0 <= L) lag_loads(l0);
    const int s = min(max(ys, 0), nyb - 1);
    const float* dg = dyws + static_cast<size_t>(k) * Wy;
    win::stage(
        sl.r, G, C, L, Wy, ctx, d, e,
        [&](int i) {
          const int g = s - L + i;
          return g >= 0 && g < nyb ? y[g] : 0.0f;
        },
        [&](int j) { return dg[j]; });
  }
  if (L <= 32) __syncwarp(); else __syncthreads();

  if (live) {
    // interior: every head and tail mask 1 (ch = Wy, ct = 0), so the walk
    // needs no cuts, only the scan's groups and the reduce's blocks
    const bool interior = ys >= L && ys + Wy <= ny - L;
    const float* c = ctx + L;
    for (int l = l0; l <= L; l += G) {
      if (l != l0) lag_loads(l);
      // One walk over the window: the prefix sums of d and e in XLA's
      // cumsum order (groups of 16 chained from +0, a partial plus the
      // totals of the groups before its own), read at the cuts, and the
      // bilinear terms in XLA's row-reduce order (blocks of
      // rn::row_block, each chained from +0, the block sums chained).
      float gd = 0.0f, ge = 0.0f, bd = 0.0f, be = 0.0f;
      float blk = 0.0f, dsxx = 0.0f;
      float dsx, dsx2, cd_t = 0.0f, ce_t = 0.0f;
      int bend = rn::row_block(Wy, 0), b = 0;
      if (interior) {
        for (int g0 = 0; g0 < Wy; g0 += 16) {
          const int g1 = min(g0 + 16, Wy);
          if (g0 > 0) {
            bd = rn::add(bd, gd);
            be = rn::add(be, ge);
            gd = ge = 0.0f;
          }
#pragma unroll 4
          for (int j = g0; j < g1; ++j) {
            gd = rn::add(gd, d[j]);
            ge = rn::add(ge, e[j]);
            blk = rn::add(blk, win::bilinear(c, d, j, l));
            if (j + 1 == bend) {
              dsxx = rn::add(dsxx, blk);
              blk = 0.0f;
              bend += rn::row_block(Wy, ++b);
            }
          }
        }
        dsx = rn::add(gd, bd);
        dsx2 = rn::add(ge, be);
      } else {
        // head keeps ys + j <= ny-1-l  <=>  j < ny - l - ys  (a prefix);
        // tail keeps ys + j >= l       <=>  j >= l - ys      (a suffix),
        // taken as the total minus the prefix below l - ys.
        const int ch = min(max(ny - l - ys, 0), Wy);
        const int ct = min(max(l - ys, 0), Wy);
        dsx = dsx2 = 0.0f;
        for (int j = 0; j < Wy; ++j) {
          gd = rn::add(gd, d[j]);
          ge = rn::add(ge, e[j]);
          if (j + 1 == ch) { dsx = rn::add(gd, bd); dsx2 = rn::add(ge, be); }
          if (j + 1 == ct) { cd_t = rn::add(gd, bd); ce_t = rn::add(ge, be); }
          if ((j & 15) == 15 && j + 1 < Wy) {
            bd = rn::add(bd, gd);
            be = rn::add(be, ge);
            gd = ge = 0.0f;
          }
          blk = rn::add(blk, win::bilinear(c, d, j, l));
          if (j + 1 == bend) {
            dsxx = rn::add(dsxx, blk);
            blk = 0.0f;
            bend += rn::row_block(Wy, ++b);
          }
        }
      }
      const float cd = rn::add(gd, bd), ce = rn::add(ge, be);
      const float rho = rn::acf_rho(
          rn::add(tab[0], dsx), rn::add(tab[1], rn::sub(cd, cd_t)),
          rn::add(tab[2], dsx2), rn::add(tab[3], rn::sub(ce, ce_t)),
          rn::add(tab[4], dsxx), static_cast<float>(ny - l));
      const float t = rn::measure_term(measure, rn::sub(rho, pz));
      row[l - 1] = t;
    }
  }
  win::lag_barrier(L);
  const float acc = win::reduce_lags(measure, L, sl.active && sl.r == 0,
                                       row);
  if (live && sl.r == 0) out[k] = rn::measure_final(measure, acc, L);
}

}  // namespace

// out is [B, K] impacts against p0, B series back to back.
extern "C" int window_rows_f32(const void* dyws, const void* ystarts,
                               const void* y, const void* table,
                               const void* ny, const void* p0, void* out,
                               int K, int Wy, int nyb, int L, int measure,
                               int B, void* stream) {
  if (B < 1 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  win::Plan pl;
  if (Wy < 1 || Wy > 256) return static_cast<int>(cudaErrorInvalidValue);
  const size_t cand = (3 * Wy + 4 * L) * sizeof(float);
  cudaError_t err = win::plan(K, L, cand, &pl, 0, B);
  if (err == cudaSuccess) err = win::allow_smem(window_rows_kernel, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_rows_kernel<<<dim3(pl.blocks, B), pl.threads, pl.smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dyws), static_cast<const int*>(ystarts),
      static_cast<const float*>(y), static_cast<const float*>(table),
      static_cast<const int*>(ny), static_cast<const float*>(p0),
      static_cast<float*>(out), K, Wy, nyb, L, measure, pl.G, pl.cpu, pl.cpb,
      pl.M);
  return static_cast<int>(cudaGetLastError());
}
