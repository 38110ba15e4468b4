// Host build of the CUDA sources for checking their arithmetic and their
// barriers without a card: one std::thread a CUDA thread, a std::barrier for
// __syncthreads() and one a warp for the shuffles, which exchange through
// memory; a bulk copy is a memcpy that completes its mbarrier's phase. Not a
// performance model. Included before the .cu source with RLMPC_HOST_EMULATION
// defined.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>

#define __global__
#define __device__
#define __forceinline__ inline
#define __host__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct EmuDim3 {
  int x;
};
struct float4 {
  float x, y, z, w;
};
static inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

static thread_local EmuDim3 threadIdx, blockIdx, blockDim, gridDim;
static thread_local std::barrier<>* emu_barrier;
static thread_local std::barrier<>* emu_warp_barrier;  // this thread's warp
static thread_local float* emu_shared;    // the block's dynamic shared memory
static thread_local float* emu_exchange;  // one float a thread, for shuffles

static inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
static inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
static inline float __frcp_rn(float v) { return 1.0f / v; }

// Every lane of the warp takes part, as the device's full-mask shuffles need.
static inline float emu_shuffle(float v, int src_lane) {
  emu_exchange[threadIdx.x] = v;
  emu_warp_barrier->arrive_and_wait();
  const float r = emu_exchange[(threadIdx.x & ~31) + src_lane];
  emu_warp_barrier->arrive_and_wait();
  return r;
}
static inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  return emu_shuffle(v, (threadIdx.x & 31) ^ lane_mask);
}
static inline float __shfl_sync(unsigned, float v, int src_lane) {
  return emu_shuffle(v, src_lane & 31);
}
static inline unsigned __ballot_sync(unsigned, bool pred) {
  emu_exchange[threadIdx.x] = pred ? 1.0f : 0.0f;
  emu_warp_barrier->arrive_and_wait();
  unsigned bits = 0;
  for (int l = 0; l < 32; ++l)
    if (emu_exchange[(threadIdx.x & ~31) + l] != 0.0f) bits |= 1u << l;
  emu_warp_barrier->arrive_and_wait();
  return bits;
}
static inline int __popc(unsigned v) { return __builtin_popcount(v); }
static inline unsigned long long atomicAdd(unsigned long long* p,
                                           unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

// The helpers of bulk_copy.cuh for a barrier that expects one arrival and one
// copy: the word counts the completed phases; the copy is done when issued.
static inline void mbar_init(unsigned long long* bar, unsigned) {
  __atomic_store_n(bar, 0ull, __ATOMIC_SEQ_CST);
}
static inline void mbar_fence_init() {}
static inline void mbar_arrive_expect_tx(unsigned long long*, unsigned) {}
static inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                                 unsigned long long* bar) {
  std::memcpy(dst, src, bytes);
  __atomic_add_fetch(bar, 1ull, __ATOMIC_SEQ_CST);
}
static inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  while ((__atomic_load_n(bar, __ATOMIC_SEQ_CST) & 1ull) == parity)
    std::this_thread::yield();
}
