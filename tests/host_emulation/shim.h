// Host build of the CUDA sources for checking their arithmetic and their
// barriers without a card: one std::thread a CUDA thread, a std::barrier for
// __syncthreads(), shuffles exchanged through memory. Not a performance
// model. Included before the .cu source with RLMPC_HOST_EMULATION defined.
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>

#define __global__
#define __device__
#define __forceinline__ inline
#define __host__
#define __launch_bounds__(...)

struct EmuDim3 {
  int x;
};
static thread_local EmuDim3 threadIdx, blockIdx, blockDim;
static thread_local std::barrier<>* emu_barrier;
static thread_local float* emu_shared;    // the block's dynamic shared memory
static thread_local float* emu_exchange;  // one float a thread, for shuffles

static inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
static inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
static inline float __frcp_rn(float v) { return 1.0f / v; }
static inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  emu_exchange[threadIdx.x] = v;
  emu_barrier->arrive_and_wait();
  const float r = emu_exchange[threadIdx.x ^ lane_mask];
  emu_barrier->arrive_and_wait();
  return r;
}
