// Inverse of an already scaled, assembled SPD KKT matrix K followed by a
// fixed count of OSQP ADMM steps, one launch for a batch: the Hopper
// counterpart of solve_scaled_batch (_gj_admm_kernel) in
// rl_mpc_locomotion_tpu/ops/pallas/admm_kernel.py. The plain pipeline
// (ops/qp.py) does the Ruiz scaling, the K assembly, the residuals, the rho
// restart, the polish and the unscaling around it.
//
// One thread block a robot, batch-major inputs and outputs, no padding of
// the batch. K (57.6 KB a robot at n = 120) comes from device memory
// straight into the register tile of qp_phases.cuh (load_tile), is inverted
// there by spd_invert and stays there for the ADMM steps (admm).
// What bounds it on an H100: reading K is 236 MB at batch 4096 (0.07 ms at
// 3.35 TB/s); the arithmetic, a factor (n^3/3 as a Cholesky, n^3 as the
// Gauss-Jordan inverse done here) and 2 n^2 a step, is the larger bound.
// With iters = 0 the kernel returns x, z, y as it read them (and still
// inverts K), which is what the profiler's iter0 mode times.
//
// Plain C interface for ctypes, as fused_qp.cu: device pointers to contiguous
// float32, the launch function returns the cudaError_t of the launch.
#ifndef RLMPC_HOST_EMULATION
#include <cuda_runtime.h>
#endif

#include "qp_phases.cuh"

namespace rlmpc {

struct ScaledSolveArgs {
  const float* k_mat;  // (B, n, n) scaled SPD K = P + sigma I + C^T rho C
  const float* q_s;    // (B, n)
  const float* c_s;    // (B, nb, 5, 3) scaled cone blocks
  const float* l_s;    // (B, m)
  const float* u_s;    // (B, m)
  const float* rho;    // (B, m) per-row penalty
  const float* x0;     // (B, n)
  const float* z0;     // (B, m)
  const float* y0;     // (B, m)
  float* x_out;        // (B, n)
  float* z_out;        // (B, m)
  float* y_out;        // (B, m)
  QpDims dm;
  int iters;
  float sigma, relax;
};

__global__ void __launch_bounds__(kThreads, 2)
scaled_solve_kernel(const ScaledSolveArgs a) {
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

  KTile kt;
  load_tile(dm, t, a.k_mat + (size_t)rb * n * n, n, kt);
  for (int j = t.tid; j < n; j += t.nt) {
    s.q[j] = a.q_s[(size_t)rb * n + j];
    s.x[j] = a.x0[(size_t)rb * n + j];
  }
  for (int r = t.tid; r < m; r += t.nt) {
    const size_t g = (size_t)rb * m + r;
    s.l[r] = a.l_s[g];
    s.u[r] = a.u_s[g];
    s.rho[r] = a.rho[g];
    s.z[r] = a.z0[g];
    s.y[r] = a.y0[g];
  }
  const float* c = a.c_s + (size_t)rb * dm.nb * 15;
  for (int i = t.tid; i < dm.nb * 15; i += t.nt) s.cs[i] = c[i];
  __syncthreads();

  spd_invert(s, t, kt, dm.n);
  const QpDims da = launder(dm);
  const QpShared sa = qp_carve(s.inv, da, t.nt);
  admm(da, sa, t, kt, a.iters, a.sigma, a.relax);

  const size_t ra = (size_t)launder(rb);
  float* x_out = a.x_out + ra * da.n;
  float* z_out = a.z_out + ra * da.m;
  float* y_out = a.y_out + ra * da.m;
  for (int j = t.tid; j < da.n; j += t.nt) x_out[j] = sa.x[j];
  for (int r = t.tid; r < da.m; r += t.nt) {
    z_out[r] = sa.z[r];
    y_out[r] = sa.y[r];
  }
}

}  // namespace rlmpc

#ifndef RLMPC_HOST_EMULATION
// Blocks of scaled_solve_kernel resident on one SM at these sizes, or minus
// a cudaError_t.
extern "C" int rlmpc_scaled_solve_blocks_per_sm(int n, int m, int nb) {
  return rlmpc::qp_blocks_per_sm(rlmpc::scaled_solve_kernel,
                                 rlmpc::qp_dense_shared_bytes(n, m, nb));
}

extern "C" int rlmpc_scaled_solve(
    const float* k_mat, const float* q_s, const float* c_s, const float* l_s,
    const float* u_s, const float* rho, const float* x0, const float* z0,
    const float* y0, float* x_out, float* z_out, float* y_out, int batch,
    int n, int m, int nb, int iters, float sigma, float relax, void* stream) {
  const int bytes = rlmpc::qp_dense_shared_bytes(n, m, nb);
  if (bytes < 0 || bytes > rlmpc::kMaxSharedBytes || batch <= 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rlmpc::scaled_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  rlmpc::ScaledSolveArgs a;
  a.k_mat = k_mat; a.q_s = q_s; a.c_s = c_s; a.l_s = l_s; a.u_s = u_s;
  a.rho = rho; a.x0 = x0; a.z0 = z0; a.y0 = y0;
  a.x_out = x_out; a.z_out = z_out; a.y_out = y_out;
  a.dm = rlmpc::qp_dense_dims(n, m, nb);
  a.iters = iters; a.sigma = sigma; a.relax = relax;
  rlmpc::scaled_solve_kernel<<<batch, rlmpc::kThreads, bytes,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
