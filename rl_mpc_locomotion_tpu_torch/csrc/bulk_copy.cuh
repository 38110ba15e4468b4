// Hopper's bulk copy from device memory into shared memory, tracked on an
// mbarrier, behind small helpers (PTX for sm_90). The host emulation of the
// sources (tests/host_emulation/shim.h) supplies plain versions of the same
// names.
//
//   mbar_init(bar, count)            barrier expecting `count` arrivals a phase
//   mbar_fence_init()                make the initialised barriers visible
//   mbar_arrive_expect_tx(bar, n)    one arrival, and n bytes still to land
//   bulk_copy_g2s(dst, src, n, bar)  n bytes (a multiple of 16, both addresses
//                                    16-byte aligned) in; the bytes landing
//                                    complete the barrier's transaction count
//   mbar_wait(bar, parity)           until the phase of that parity completed
#pragma once

#ifndef RLMPC_HOST_EMULATION
namespace rlmpc {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes,
                                              unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

}  // namespace rlmpc
#endif
