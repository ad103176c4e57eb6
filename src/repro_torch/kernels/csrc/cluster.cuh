// Asynchronous copies and the exchange between the blocks of a
// thread-block cluster, shared by the kernels that use them (prefix_sum.cu,
// dense_sxx.cu): cp.async into shared memory, the cluster barrier, and
// st.async stores into another block's shared memory counted on that
// block's mbarrier (no memory fence: a release at cluster scope compiles
// to a GPU-wide MEMBAR).
#pragma once
#include <cuda_runtime.h>

namespace cl {

// One value from device to shared memory, not waited for.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4 or 8 bytes");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The exchange's mbarrier: one arrival (this block's own, made here with
// the bytes the cluster will store into this block) and then those bytes.
__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned bytes) {
  const unsigned a = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(a)
               : "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(a), "r"(bytes) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// v into the shared-memory word at `dst` of block `rank`, counted on that
// block's mbarrier: an asynchronous store, no fence.
template <typename T>
__device__ __forceinline__ void push(T* dst, T v, unsigned long long* bar,
                                     int rank) {
  unsigned ra, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(ra) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb) : "r"(smem_addr(bar)), "r"(rank));
  if (sizeof(T) == 8) {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], "
        "%1, [%2];\n" ::"r"(ra), "l"(__double_as_longlong(v)), "r"(rb)
        : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], "
        "%1, [%2];\n" ::"r"(ra), "r"(__float_as_uint(v)), "r"(rb)
        : "memory");
  }
}

// Waits for the exchange's bytes; a fault (a trap) rather than a hang if
// they never come.
__device__ __forceinline__ void bar_wait(unsigned long long* bar) {
  const unsigned a = smem_addr(bar);
  const long long t0 = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(0u) : "memory");
    if (done) break;
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

}  // namespace cl
