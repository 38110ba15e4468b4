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
//                          written out. Plain coalesced loads; bound by the
//                          bytes of the tile (252 MB at batch 4096).
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

// out = v + row 0 of K, from shared memory.
__device__ inline void write_row0(const QpDims& dm, const QpShared& s,
                                  const QpThread& t, const float* v, float* out) {
  for (int j = t.tid; j < dm.n; j += t.nt) out[j] = v[j] + s.K[j];
}

__global__ void __launch_bounds__(kThreads, 2)
stripped_solve_kernel(const StrippedArgs a) {
#ifdef RLMPC_HOST_EMULATION
  float* smem = emu_shared;
#else
  extern __shared__ float smem[];
#endif
  const QpDims dm = a.dm;
  const QpThread t = qp_thread(dm);
  const QpShared s = qp_carve(smem, dm, t.nt);
  const int rb = blockIdx.x;
  const int n = dm.n, m = dm.m;
  float* out = a.out + (size_t)rb * n;

  load_matrix(dm, s, t, a.p_mat + (size_t)rb * n * n);
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
  if (a.stage == kStageDma) {
    write_row0(dm, s, t, s.q, out);
    return;
  }

  mask(dm, s, t);
  if (a.stage == kStageMask) {
    write_row0(dm, s, t, s.q, out);
    return;
  }

  const float c_cost = ruiz(dm, s, t, a.ruiz_iters);
  if (a.stage == kStageRuiz) {
    write_row0(dm, s, t, s.q, out);
    return;
  }

  // every row gets rho (no equality rows: the bounds are +-bound)
  assemble_k(dm, s, t, a.sigma, a.rho, 1.0f, c_cost);
  // assemble_k moved the bounds into the scaled problem; the stage keeps
  // +-bound there, as the TPU runner does
  for (int r = t.tid; r < m; r += t.nt) {
    s.l[r] = -a.bound;
    s.u[r] = a.bound;
  }
  KTile kt;
  spd_invert(dm, s, t, kt);   // its first barrier orders the bounds above
  if (a.stage == kStageKgj) {
    // row 0 of K^-1 lies in the registers of the threads with ty == 0
    if (t.tid < kGrid) {
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const int j = t.tid + kGrid * b;
        if (j < n) out[j] = s.q[j] + kt.v[0][b];
      }
    }
    return;
  }

  admm(dm, s, t, kt, a.admm_iters, a.sigma, a.relax);
  for (int j = t.tid; j < n; j += t.nt) out[j] = s.x[j];
}

struct BmDmaArgs {
  const float* p_pad;  // (B, n, np), np >= n
  const float* q;      // (B, n)
  float* out;          // (B, n)
  int n, np, transpose;
};

__global__ void __launch_bounds__(kThreads)
bm_dma_kernel(const BmDmaArgs a) {
#ifdef RLMPC_HOST_EMULATION
  float* tile = emu_shared;
#else
  extern __shared__ float tile[];
#endif
  const int rb = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int size = a.n * a.np;
  const float* g = a.p_pad + (size_t)rb * size;
  for (int i = tid; i < size; i += nt) tile[i] = g[i];
  __syncthreads();
  const float* q = a.q + (size_t)rb * a.n;
  float* out = a.out + (size_t)rb * a.n;
  for (int j = tid; j < a.n; j += nt)
    out[j] = q[j] + (a.transpose ? tile[j] : tile[j * a.np]);
}

}  // namespace rlmpc

extern "C" {

// Bytes of dynamic shared memory bm_dma_kernel needs, or -1.
int rlmpc_bm_dma_shared_bytes(int n, int np) {
  if (n <= 0 || np < n) return -1;
  return (int)sizeof(float) * n * np;
}

#ifndef RLMPC_HOST_EMULATION
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
  a.dm = rlmpc::QpDims{n, m, nb, 1, 0, n, rlmpc::qp_ld(n)};
  a.stage = stage; a.ruiz_iters = ruiz_iters; a.admm_iters = admm_iters;
  a.rho = rho; a.sigma = sigma; a.relax = relax; a.bound = bound;
  rlmpc::stripped_solve_kernel<<<batch, rlmpc::kThreads, bytes,
                                 (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int rlmpc_bm_dma(const float* p_pad, const float* q, float* out, int batch,
                 int n, int np, int transpose, void* stream) {
  const int bytes = rlmpc_bm_dma_shared_bytes(n, np);
  if (bytes < 0 || bytes > rlmpc::kMaxSharedBytes || batch <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rlmpc::bm_dma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  rlmpc::BmDmaArgs a;
  a.p_pad = p_pad; a.q = q; a.out = out;
  a.n = n; a.np = np; a.transpose = transpose;
  rlmpc::bm_dma_kernel<<<batch, rlmpc::kThreads, bytes,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
