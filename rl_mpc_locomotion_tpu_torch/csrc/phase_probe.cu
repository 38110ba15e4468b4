// Phase timers of the QP solve: the Hopper counterparts of the two kernels in
// scripts/profile.py.
//
//   stripped_solve_kernel  _stripped_kernel_runner: the prebuilt-P solve of
//                          fused_qp.cu cut after a stage, so that the time of
//                          each stage is a difference of two launches. Built
//                          from the same qp_phases.cuh phases, as a kernel of
//                          its own so that the solve entries' register
//                          allocation does not see its branches.
//   bm_dma_kernel          make_bm_dma: each robot's padded (n, np) tile of
//                          P brought into shared memory whole (61 440 B at
//                          120 x 128), then column 0 (or row 0) plus q
//                          written out. Bound by the bytes of the tiles
//                          (252 MB at batch 4096): a persistent grid, one
//                          block an SM walking over robots, with a ring of
//                          up to three tile buffers; one thread issues a
//                          Hopper bulk copy a tile (bulk_copy.cuh), tracked
//                          on the slot's mbarrier, so two tiles are in flight
//                          while the block reads the third.
//
// Stages of stripped_solve_kernel (stage, what `out` holds after it):
//   0 dma   q + row 0 of P
//   1 mask  q + row 0 of P after the swing mask (all ones: P unchanged)
//   2 ruiz  q_s + row 0 of the scaled P after `ruiz_iters` Ruiz passes
//   3 kgj   q_s + row 0 of K^-1, K = P_s + sigma I + C_s^T rho C_s
//   4 admm  x (scaled) after `admm_iters` ADMM steps from a cold start,
//           bounds +-bound in the scaled problem
// The settings of the TPU runner: rho 0.1, sigma 1e-6, relax 1.6, bounds +-1,
// 3 Ruiz passes, passed in by the wrapper.
//
// Plain C interface for ctypes, as fused_qp.cu.
#ifndef RLMPC_HOST_EMULATION
#include <cuda_runtime.h>
#endif

#include "bulk_copy.cuh"
#include "qp_phases.cuh"

namespace rlmpc {

enum StrippedStage { kStageDma = 0, kStageMask, kStageRuiz, kStageKgj, kStageAdmm };

struct StrippedArgs {
  const float* p_mat;     // (B, n, n)
  const float* q;         // (B, n)
  const float* c_blocks;  // (B, nb, 5, 3)
  float* out;             // (B, n)
  QpDims dm;
  int stage, ruiz_iters, admm_iters;
  float rho, sigma, relax, bound;
};

__global__ void __launch_bounds__(kThreads, 2)
stripped_solve_kernel(const StrippedArgs a) {
#ifdef RLMPC_HOST_EMULATION
  float* smem = emu_shared;
#else
  extern __shared__ __align__(16) float smem[];
#endif
  const QpDims dm = a.dm;
  const QpThread t = qp_thread();
  const QpShared s = qp_carve(smem, dm, t.nt);
  const int rb = blockIdx.x;
  const int n = dm.n, m = dm.m;
  float* out = a.out + (size_t)rb * n;

  KTile kt;
  load_tile(dm, t, a.p_mat + (size_t)rb * n * n, n, kt);
  for (int j = t.tid; j < n; j += t.nt) {
    s.q[j] = a.q[(size_t)rb * n + j];
    s.xt[j] = 1.0f;   // the swing mask: every variable active
    s.d[j] = 1.0f;
    s.x[j] = 0.0f;
  }
  for (int r = t.tid; r < m; r += t.nt) {
    s.e[r] = 1.0f;
    s.l[r] = -a.bound;
    s.u[r] = a.bound;
    s.z[r] = 0.0f;
    s.y[r] = 0.0f;
  }
  const float* c = a.c_blocks + (size_t)rb * dm.nb * 15;
  for (int i = t.tid; i < dm.nb * 15; i += t.nt) s.cs[i] = c[i];
  __syncthreads();
  // each stage's output: row 0 of the tile from its owners' registers, plus
  // q, whose entries their owners updated (hence the barriers)
  if (a.stage == kStageDma) {
    write_row0(dm, t, kt, s.q, out);
    return;
  }

  mask(dm, s, t, kt);
  if (a.stage == kStageMask) {
    __syncthreads();
    write_row0(dm, t, kt, s.q, out);
    return;
  }

  const float c_cost = ruiz(dm, s, t, kt, a.ruiz_iters);
  if (a.stage == kStageRuiz) {
    __syncthreads();
    write_row0(dm, t, kt, s.q, out);
    return;
  }

  // every row gets rho (no equality rows: the bounds are +-bound)
  assemble_k(dm, s, t, kt, a.sigma, a.rho, 1.0f, c_cost);
  // assemble_k moved the bounds into the scaled problem; the stage keeps
  // +-bound there, as the TPU runner does
  for (int r = t.tid; r < m; r += t.nt) {
    s.l[r] = -a.bound;
    s.u[r] = a.bound;
  }
  spd_invert(s, t, kt, dm.n);   // its first barrier orders the bounds above
  const QpShared sa = qp_carve(s.inv, launder(dm), t.nt);
  float* out_a = a.out + (size_t)launder(rb) * n;
  if (a.stage == kStageKgj) {
    write_row0(dm, t, kt, sa.q, out_a);
    return;
  }

  admm(dm, sa, t, kt, a.admm_iters, a.sigma, a.relax);
  for (int j = t.tid; j < n; j += t.nt) out_a[j] = sa.x[j];
}

struct BmDmaArgs {
  const float* p_pad;  // (B, n, np), np >= n, n * np a multiple of 4
  const float* q;      // (B, n)
  float* out;          // (B, n)
  int batch, n, np, transpose, slots;
};

constexpr int kDmaSlots = 3;   // tile buffers of the ring, at most

// Tile buffers a block of bm_dma_kernel gets at these sizes (0: none fits).
__host__ __device__ inline int bm_dma_slots(int n, int np) {
  const long long tile = 4ll * n * np;
  long long k = (kMaxSharedBytes - 8 * kDmaSlots) / tile;
  return (int)(k < kDmaSlots ? k : kDmaSlots);
}

__global__ void __launch_bounds__(kThreads, 1)
bm_dma_kernel(const BmDmaArgs a) {
#ifdef RLMPC_HOST_EMULATION
  float* smem = emu_shared;
#else
  extern __shared__ __align__(16) float smem[];
#endif
  const int tid = threadIdx.x, nt = blockDim.x;
  const int size = a.n * a.np;
  const unsigned bytes = 4u * (unsigned)size;
  unsigned long long* bar =
      reinterpret_cast<unsigned long long*>(smem + a.slots * size);
  // this block's robots: blockIdx.x + k gridDim.x, k < count
  const int grid = (int)gridDim.x;
  const int count = (a.batch - (int)blockIdx.x + grid - 1) / grid;
  auto issue = [&](int k) {
    const int slot = k % a.slots;
    const size_t rb = blockIdx.x + (size_t)k * gridDim.x;
    mbar_arrive_expect_tx(bar + slot, bytes);
    bulk_copy_g2s(smem + slot * size, a.p_pad + rb * size, bytes, bar + slot);
  };
  if (tid == 0) {
    for (int i = 0; i < a.slots; ++i) mbar_init(bar + i, 1);
    mbar_fence_init();
    for (int k = 0; k < a.slots && k < count; ++k) issue(k);
  }
  __syncthreads();
  for (int k = 0; k < count; ++k) {
    const int slot = k % a.slots;
    mbar_wait(bar + slot, (unsigned)((k / a.slots) & 1));
    const float* tile = smem + slot * size;
    const size_t rb = blockIdx.x + (size_t)k * gridDim.x;
    const float* q = a.q + rb * a.n;
    float* out = a.out + rb * a.n;
    for (int j = tid; j < a.n; j += nt)
      out[j] = q[j] + (a.transpose ? tile[j] : tile[j * a.np]);
    __syncthreads();   // every thread is done with the slot
    if (tid == 0 && k + a.slots < count) issue(k + a.slots);
  }
}

}  // namespace rlmpc

extern "C" {

// Bytes of dynamic shared memory bm_dma_kernel needs (its ring of tiles and
// their mbarriers), or -1 when a tile is not a whole number of 16-byte bulk
// copies or no tile fits.
int rlmpc_bm_dma_shared_bytes(int n, int np) {
  if (n <= 0 || np < n || (n * np) % 4 != 0) return -1;
  const int slots = rlmpc::bm_dma_slots(n, np);
  if (slots < 1) return -1;
  return (int)sizeof(float) * slots * n * np + 8 * rlmpc::kDmaSlots;
}

#ifndef RLMPC_HOST_EMULATION
// Blocks of stripped_solve_kernel resident on one SM at these sizes, or
// minus a cudaError_t.
int rlmpc_stripped_solve_blocks_per_sm(int n, int m, int nb) {
  return rlmpc::qp_blocks_per_sm(rlmpc::stripped_solve_kernel,
                                 rlmpc::qp_dense_shared_bytes(n, m, nb));
}

int rlmpc_stripped_solve(const float* p_mat, const float* q,
                         const float* c_blocks, float* out, int batch, int n,
                         int m, int nb, int stage, int ruiz_iters,
                         int admm_iters, float rho, float sigma, float relax,
                         float bound, void* stream) {
  const int bytes = rlmpc::qp_dense_shared_bytes(n, m, nb);
  if (bytes < 0 || bytes > rlmpc::kMaxSharedBytes || batch <= 0 ||
      stage < rlmpc::kStageDma || stage > rlmpc::kStageAdmm)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rlmpc::stripped_solve_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  rlmpc::StrippedArgs a;
  a.p_mat = p_mat; a.q = q; a.c_blocks = c_blocks; a.out = out;
  a.dm = rlmpc::qp_dense_dims(n, m, nb);
  a.stage = stage; a.ruiz_iters = ruiz_iters; a.admm_iters = admm_iters;
  a.rho = rho; a.sigma = sigma; a.relax = relax; a.bound = bound;
  rlmpc::stripped_solve_kernel<<<batch, rlmpc::kThreads, bytes,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// p_pad must be 16-byte aligned (the wrapper checks it); one block an SM.
int rlmpc_bm_dma(const float* p_pad, const float* q, float* out, int batch,
                 int n, int np, int transpose, void* stream) {
  const int bytes = rlmpc_bm_dma_shared_bytes(n, np);
  if (bytes < 0 || bytes > rlmpc::kMaxSharedBytes || batch <= 0 ||
      reinterpret_cast<size_t>(p_pad) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rlmpc::bm_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  rlmpc::BmDmaArgs a;
  a.p_pad = p_pad; a.q = q; a.out = out;
  a.batch = batch; a.n = n; a.np = np; a.transpose = transpose;
  a.slots = rlmpc::bm_dma_slots(n, np);
  rlmpc::bm_dma_kernel<<<batch < sms ? batch : sms, rlmpc::kThreads, bytes,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
