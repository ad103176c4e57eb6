// What the two Eq. 9 window kernels (acf_window_impact.cu, window_rows.cu)
// share: candidate packing, the staging pass, the bilinear terms and the
// lag reduction (rn::reduce_terms); acf_impact.cu (Eq. 8) packs its
// candidates and reduces their lags the same way.
//
// A candidate's lags run one to a thread, G consecutive threads per
// candidate (lane r takes lag r + 1, and r + 1 + G, ... when G < L):
// - L <= 32: G = L and one warp holds floor(32 / L) candidates (fewer where
//   shared memory is short), so a candidate never straddles a warp and the
//   block needs only __syncwarp;
// - L > 32: G = 32 ceil(L / 32) threads (at most kBlock), whole warps, and
//   a block holds one or more such candidates.
// A "unit" is the warp (L <= 32) or the candidate's warps (L > 32); a block
// holds up to kBlock threads of units.  plan() spreads the candidates over
// the SMs first and fills blocks only where there are more candidates than
// SMs, so a small launch (the ReHeap's P = 50) still takes one SM per
// candidate and a large one (a rounds tier of 10,240) fits one wave; it
// also hands the kernel what slot() needs to place a thread without an
// integer division.
#pragma once
#include <cuda_runtime.h>

#include "rn.cuh"

namespace win {

constexpr int kBlock = 256;            // most threads a block
constexpr int kSmemLimit = 232448;     // dynamic shared memory of a block

struct Slot {
  int cand;     // candidate within the block
  int r;        // lane within the candidate
  bool active;  // false for the spare lanes of a packed warp
};

// M = ceil(65536 / D) divides exactly by D without a division: D = G
// lanes a candidate at L <= 32 (dividing a lane, < 32), G / 32 warps a
// candidate past that (dividing a warp index, < kBlock / 32).
__device__ __forceinline__ Slot slot(int L, int G, int cpu, int M) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (L <= 32) {
    const int q = (lane * M) >> 16;
    return Slot{w * cpu + q, lane - q * G, q < cpu};
  }
  const int q = (w * M) >> 16;
  return Slot{q, static_cast<int>(threadIdx.x) - q * G, true};
}

using rn::kU;

// window_rows' bilinear term of window position j, lag l: the reference's
// roll form, d[j] ((c[j + l] + c[j - l]) + d[j + l]), with d padded with
// zeros past the window and c at the window's first value.
template <typename T>
__device__ __forceinline__ T bilinear(const T* c, const T* d, int j, int l) {
  return rn::mul(d[j], rn::add(rn::add(c[j + l], c[j - l]), d[j + l]));
}

// acf_window_impact's: ref._window_delta_acf's basis where every mask is 1,
// d[j] ((c[j + l] + d[j + l]) + c[j - l]).
template <typename T>
__device__ __forceinline__ T bilinear_einsum(const T* c, const T* d, int j,
                                             int l) {
  return rn::mul(d[j], rn::add(rn::add(c[j + l], d[j + l]), c[j - l]));
}

// Where every mask is 1 (an interior window): sum d, sum e and the
// bilinear sum (bilinear_einsum), which serve all five moments, each a
// chain first to last from +0, as XLA sums the reference's contraction
// over the window.  Software-pipelined: the next kU terms are loaded and
// formed while this group's are chained.
template <typename T>
__device__ __forceinline__ void interior_sums(const T* c, const T* d,
                                              const T* e, int W, int l,
                                              T& sd, T& se, T& sx) {
  sd = se = sx = 0;
  int j = 0;
  if (j + kU <= W) {
    T dv[kU], ev[kU], pv[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      dv[k] = d[j + k];
      ev[k] = e[j + k];
      pv[k] = bilinear_einsum(c, d, j + k, l);
    }
    for (j += kU; j + kU <= W; j += kU) {
      T dn[kU], en[kU], pn[kU];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        dn[k] = d[j + k];
        en[k] = e[j + k];
        pn[k] = bilinear_einsum(c, d, j + k, l);
      }
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        sd = rn::add(sd, dv[k]);
        se = rn::add(se, ev[k]);
        sx = rn::add(sx, pv[k]);
        dv[k] = dn[k];
        ev[k] = en[k];
        pv[k] = pn[k];
      }
    }
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      sd = rn::add(sd, dv[k]);
      se = rn::add(se, ev[k]);
      sx = rn::add(sx, pv[k]);
    }
  }
  for (; j < W; ++j) {
    sd = rn::add(sd, d[j]);
    se = rn::add(se, e[j]);
    sx = rn::add(sx, bilinear_einsum(c, d, j, l));
  }
}

// One staging pass for a candidate: lane r copies ctx[i] = load_c(i) for
// i = r, r + G, ... < C (the context, ctx[L + j] at window position j)
// and, where j = i - L lies in the window, d[j] = load_d(j) and
// e[j] = d (2 c + d), so the lane that holds c and d forms e; d is padded
// with L zeros past W.  kBatch values of each are loaded before any is
// stored, so a lane's loads are in flight together.
constexpr int kBatch = 4;

template <typename T, typename LoadC, typename LoadD>
__device__ __forceinline__ void stage(int r, int G, int C, int L, int W,
                                      T* ctx, T* d, T* e, LoadC load_c,
                                      LoadD load_d) {
  for (int i0 = r; i0 < C; i0 += kBatch * G) {
    T cv[kBatch], dv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * G, j = i - L;
      cv[k] = i < C ? load_c(i) : static_cast<T>(0);
      dv[k] = j >= 0 && j < W ? load_d(j) : static_cast<T>(0);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = i0 + k * G, j = i - L;
      if (i < C) ctx[i] = cv[k];
      if (j >= 0 && j < W) {
        d[j] = dv[k];
        e[j] = rn::mul(dv[k], rn::add(static_cast<T>(2) * cv[k], dv[k]));
      }
    }
  }
#pragma unroll 1
  for (int j = W + r; j < W + L; j += G) d[j] = static_cast<T>(0);
}

// A candidate's lag terms reduced as rn::reduce_terms does (cheb their max
// in lag order, mae and rmse in XLA's row-reduce order): lag l's term is
// in row[l - 1], after the caller's barrier.  The reducing thread (me)
// holds the result; every other thread returns 0.  Its loads are not
// issued ahead: with the blocked walk in the kernel, the smaller code is
// the faster one (PERF.md §6).
template <typename T>
__device__ __forceinline__ T reduce_lags(int measure, int L, bool me,
                                         const T* row) {
  if (!me) return 0;
  return rn::reduce_terms<T, false>(measure, L,
                                    [=](int c) { return row[c]; });
}

// The barrier before a candidate's first lane reduces its own terms.
__device__ __forceinline__ void lag_barrier(int L) {
  if (L <= 32) __syncwarp(); else __syncthreads();
}

// Launch shape for P candidates of cand_bytes shared memory each.
struct Plan {
  int G, cpu, cpb, M, blocks, threads;  // cpb candidates a block
  size_t smem;
};

// The current device's SM count, asked at every launch (a host lookup).
inline cudaError_t sm_count(int* n_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// L is the lanes a candidate takes (its lag count in the window kernels);
// a block's shared memory is fixed_bytes plus cand_bytes a candidate.  B
// series (a batch, grid row blockIdx.y each) of P candidates: the SMs are
// shared among all B P, and p->blocks is the blocks of one series.
inline cudaError_t plan(int P, int L, size_t cand_bytes, Plan* p,
                        size_t fixed_bytes = 0, int B = 1) {
  int n_sm = 0;
  cudaError_t err = sm_count(&n_sm);
  if (err != cudaSuccess) return err;
  if (fixed_bytes >= kSmemLimit) return cudaErrorInvalidValue;
  const int fit = static_cast<int>((kSmemLimit - fixed_bytes) / cand_bytes);
  if (fit < 1) return cudaErrorInvalidValue;
  int U, most;
  if (L <= 32) {
    p->G = L;
    p->cpu = 32 / L < fit ? 32 / L : fit;
    U = 32;
    most = fit / p->cpu < kBlock / 32 ? fit / p->cpu : kBlock / 32;
  } else {
    const int nw = (L + 31) / 32 < kBlock / 32 ? (L + 31) / 32 : kBlock / 32;
    p->G = 32 * nw;
    p->cpu = 1;
    U = p->G;
    most = fit < kBlock / U ? fit : kBlock / U;
  }
  const long long per_sm = static_cast<long long>(p->cpu) * n_sm;
  const long long want = (static_cast<long long>(B) * P + per_sm - 1) / per_sm;
  const int units =
      want < 1 ? 1 : (want > most ? most : static_cast<int>(want));
  const int cpb = units * p->cpu;
  const int D = L <= 32 ? p->G : p->G / 32;
  p->cpb = cpb;
  p->M = (65536 + D - 1) / D;
  p->blocks = (P + cpb - 1) / cpb;
  p->threads = units * U;
  p->smem = fixed_bytes + static_cast<size_t>(cpb) * cand_bytes;
  return cudaSuccess;
}

// Raise a kernel's dynamic shared memory limit where the plan needs more
// than the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace win
