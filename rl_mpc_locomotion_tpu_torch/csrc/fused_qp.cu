// Whole GRF-QP solve, one launch for a batch, in two entries that differ only
// in where the Hessian P comes from:
//   fused_solve_chain_kernel  P built on chip from the condensation chain:
//                             fused_solve_chain_batch in
//                             rl_mpc_locomotion_tpu/ops/pallas/fused_qp.py
//   fused_solve_kernel        a prebuilt raw P (B, n, n) read from device
//                             memory: fused_solve_batch in the same file
// and then, from the register tile on, run the same phases 2-8
// (solve_from_tile). One thread block a robot, batch-major inputs and
// outputs, no padding of the batch. The phases and the notes on what bounds
// the kernels are in qp_phases.cuh; the prebuilt-P entry also reads 57.6 KB
// of P a robot (236 MB at batch 4096) straight into the tile, which is its
// bound by bytes, still well under its arithmetic.
//
// Plain C interface for ctypes: every pointer is a device pointer to
// contiguous float32, `stream` is a cudaStream_t. The launch functions
// return the cudaError_t of the launch (0 = launched); they never
// synchronise and allocate nothing.
//
// With RLMPC_HOST_EMULATION defined the file also compiles as plain C++
// behind tests/host_emulation/shim.h, which the CPU tests use to check the
// kernel's arithmetic and barriers where there is no card.
#ifndef RLMPC_HOST_EMULATION
#include <cuda_runtime.h>
#endif

#include "qp_phases.cuh"

namespace rlmpc {

// The inputs and outputs both entries share, batch-major.
struct SolveIO {
  const float* q;         // (B, n)
  const float* c_blocks;  // (B, nb, 5, 3)
  const float* lb;        // (B, m)
  const float* ub;        // (B, m)
  const float* mask;      // (B, n)
  const float* x0;        // (B, n)
  const float* z0;        // (B, m)
  const float* y0;        // (B, m)
  const float* rho_mult;  // (B,)
  float* x_out;           // (B, n)
  float* z_out;           // (B, m)
  float* y_out;           // (B, m)
  float* rm_out;          // (B,)
  float* viol_out;        // (B,)
  float* res_out;         // (B, 2)
  QpDims dm;
  int iters, ruiz_iters, deferred_rho;
  float sigma, relax, rho_base, rho_eq_scale;
};

struct ChainSolveArgs {
  SolveIO io;
  const float* s_chain;   // (B, h, sd, ad)
  const float* weights;   // (B, sd)
  float alpha;
};

struct PSolveArgs {
  SolveIO io;
  const float* p_mat;     // (B, n, n), raw (unmasked, unscaled)
};

// Phases 2-8 for robot rb with its raw P in the tile: load the robot's
// vectors, mask, Ruiz, K, inverse, ADMM, residuals and rho, unscale, write out.
__device__ __forceinline__ void solve_from_tile(const SolveIO& a, const QpShared& s,
                                                const QpThread& t, int rb,
                                                KTile& kt) {
  const QpDims dm = a.dm;
  const int n = dm.n, m = dm.m;
  const float* c0 = a.c_blocks + (size_t)rb * dm.nb * 15;
  const float* lb = a.lb + (size_t)rb * m;
  const float* ub = a.ub + (size_t)rb * m;
  for (int j = t.tid; j < n; j += t.nt) {
    s.q[j] = a.q[(size_t)rb * n + j];
    s.xt[j] = a.mask[(size_t)rb * n + j];
    s.x[j] = a.x0[(size_t)rb * n + j];
    s.d[j] = 1.0f;
  }
  for (int r = t.tid; r < m; r += t.nt) {
    s.l[r] = lb[r];
    s.u[r] = ub[r];
    s.z[r] = a.z0[(size_t)rb * m + r];
    s.y[r] = a.y0[(size_t)rb * m + r];
    s.e[r] = 1.0f;
  }
  for (int i = t.tid; i < dm.nb * 15; i += t.nt) s.cs[i] = c0[i];
  const float rho_mult = a.rho_mult[rb];
  __syncthreads();

  mask(dm, s, t, kt);
  const float c_cost = ruiz(dm, s, t, kt, a.ruiz_iters);
  // the inverse needs every register: the two scalars wait in shared memory
  if (t.tid == 0) {
    s.keep[0] = c_cost;
    s.keep[1] = rho_mult;
  }
  assemble_k(dm, s, t, kt, a.sigma, a.rho_base * rho_mult, a.rho_eq_scale,
             c_cost);
  spd_invert(dm, s, t, kt);
  const QpShared sa = qp_carve(s.inv, launder(dm), t.nt);
  admm(dm, sa, t, kt, a.iters, a.sigma, a.relax);
  float pri_rel, dua_rel;
  const float new_rm = residuals_rho(dm, sa, t, kt, a.sigma, sa.keep[1],
                                     a.deferred_rho != 0, &pri_rel, &dua_rel);
  const size_t ra = (size_t)launder(rb);
  const float viol = unscale(dm, sa, t, sa.keep[0], a.c_blocks + ra * dm.nb * 15,
                             a.lb + ra * m, a.ub + ra * m, a.x_out + ra * n,
                             a.z_out + ra * m, a.y_out + ra * m);
  if (t.tid == 0) {
    a.rm_out[ra] = new_rm;
    a.viol_out[ra] = viol;
    a.res_out[2 * ra] = pri_rel;
    a.res_out[2 * ra + 1] = dua_rel;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_solve_chain_kernel(const ChainSolveArgs a) {
#ifdef RLMPC_HOST_EMULATION
  float* smem = emu_shared;
#else
  extern __shared__ __align__(16) float smem[];
#endif
  const QpDims dm = a.io.dm;
  const QpThread t = qp_thread();
  const QpShared s = qp_carve(smem, dm, t.nt);
  const int rb = blockIdx.x;

  // 1. chain and weights in, P built in shared memory and read into the
  // tile; the chain's space is reused by the vectors from here
  const int cl = dm.h * dm.sd * dm.ad;
  const float* g = a.s_chain + (size_t)rb * cl;
  for (int i = t.tid; i < cl; i += t.nt) s.chain[i] = g[i];
  const float* gw = a.weights + (size_t)rb * dm.sd;
  for (int i = t.tid; i < dm.sd; i += t.nt) s.chain[cl + i] = gw[i];
  __syncthreads();
  build_p_from_chain(dm, s, t, a.alpha);
  KTile kt;
  load_tile(dm, t, s.K, dm.ld, kt);

  solve_from_tile(a.io, s, t, rb, kt);
}

__global__ void __launch_bounds__(kThreads, 2)
fused_solve_kernel(const PSolveArgs a) {
#ifdef RLMPC_HOST_EMULATION
  float* smem = emu_shared;
#else
  extern __shared__ __align__(16) float smem[];
#endif
  const QpDims dm = a.io.dm;
  const QpThread t = qp_thread();
  const QpShared s = qp_carve(smem, dm, t.nt);
  const int rb = blockIdx.x;

  // 1. P in from device memory straight into the tile; its loads are in
  // flight while solve_from_tile brings the vectors in
  KTile kt;
  load_tile(dm, t, a.p_mat + (size_t)rb * dm.n * dm.n, dm.n, kt);

  solve_from_tile(a.io, s, t, rb, kt);
}

// Host-side fill of the fields both entries share.
inline SolveIO solve_io(const float* q, const float* c_blocks, const float* lb,
                        const float* ub, const float* mask, const float* x0,
                        const float* z0, const float* y0, const float* rho_mult,
                        float* x_out, float* z_out, float* y_out, float* rm_out,
                        float* viol_out, float* res_out, QpDims dm, int iters,
                        int ruiz_iters, int deferred_rho, float sigma,
                        float relax, float rho_base, float rho_eq_scale) {
  SolveIO io;
  io.q = q; io.c_blocks = c_blocks; io.lb = lb; io.ub = ub; io.mask = mask;
  io.x0 = x0; io.z0 = z0; io.y0 = y0; io.rho_mult = rho_mult;
  io.x_out = x_out; io.z_out = z_out; io.y_out = y_out; io.rm_out = rm_out;
  io.viol_out = viol_out; io.res_out = res_out;
  io.dm = dm;
  io.iters = iters; io.ruiz_iters = ruiz_iters; io.deferred_rho = deferred_rho;
  io.sigma = sigma; io.relax = relax; io.rho_base = rho_base;
  io.rho_eq_scale = rho_eq_scale;
  return io;
}

}  // namespace rlmpc

extern "C" {

// Bytes of dynamic shared memory a block needs at these sizes, or -1 when the
// sizes do not describe a chain QP this kernel takes.
int rlmpc_fused_chain_shared_bytes(int n, int m, int nb, int h, int sd) {
  if (n <= 0 || h <= 0 || sd <= 0 || nb <= 0) return -1;
  if (n != 3 * nb || m != 5 * nb || n % h != 0) return -1;
  if (n > rlmpc::kGrid * rlmpc::kTile) return -1;
  rlmpc::QpDims dm{n, m, nb, h, sd, n / h, rlmpc::qp_ld(n)};
  return (int)sizeof(float) * rlmpc::qp_shared_floats(dm, rlmpc::kThreads);
}

// The same for the entries whose matrix comes from device memory
// (fused_solve_kernel, scaled_solve_kernel, stripped_solve_kernel).
int rlmpc_qp_shared_bytes(int n, int m, int nb) {
  return rlmpc::qp_dense_shared_bytes(n, m, nb);
}

#ifndef RLMPC_HOST_EMULATION
const char* rlmpc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Blocks of each entry resident on one SM at these sizes, or minus a
// cudaError_t.
int rlmpc_fused_chain_blocks_per_sm(int n, int m, int nb, int h, int sd) {
  return rlmpc::qp_blocks_per_sm(rlmpc::fused_solve_chain_kernel,
                                 rlmpc_fused_chain_shared_bytes(n, m, nb, h, sd));
}

int rlmpc_fused_solve_blocks_per_sm(int n, int m, int nb) {
  return rlmpc::qp_blocks_per_sm(rlmpc::fused_solve_kernel,
                                 rlmpc_qp_shared_bytes(n, m, nb));
}

int rlmpc_fused_solve_chain(
    const float* s_chain, const float* weights, const float* q,
    const float* c_blocks, const float* lb, const float* ub, const float* mask,
    const float* x0, const float* z0, const float* y0, const float* rho_mult,
    float* x_out, float* z_out, float* y_out, float* rm_out, float* viol_out,
    float* res_out, int batch, int n, int m, int nb, int h, int sd, int iters,
    int ruiz_iters, int deferred_rho, float alpha, float sigma, float relax,
    float rho_base, float rho_eq_scale, void* stream) {
  const int bytes = rlmpc_fused_chain_shared_bytes(n, m, nb, h, sd);
  if (bytes < 0 || bytes > rlmpc::kMaxSharedBytes || batch <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rlmpc::fused_solve_chain_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  rlmpc::ChainSolveArgs a;
  a.io = rlmpc::solve_io(q, c_blocks, lb, ub, mask, x0, z0, y0, rho_mult,
                         x_out, z_out, y_out, rm_out, viol_out, res_out,
                         rlmpc::QpDims{n, m, nb, h, sd, n / h, rlmpc::qp_ld(n)},
                         iters, ruiz_iters, deferred_rho, sigma, relax,
                         rho_base, rho_eq_scale);
  a.s_chain = s_chain; a.weights = weights; a.alpha = alpha;
  rlmpc::fused_solve_chain_kernel<<<batch, rlmpc::kThreads, bytes,
                                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int rlmpc_fused_solve(
    const float* p_mat, const float* q, const float* c_blocks, const float* lb,
    const float* ub, const float* mask, const float* x0, const float* z0,
    const float* y0, const float* rho_mult, float* x_out, float* z_out,
    float* y_out, float* rm_out, float* viol_out, float* res_out, int batch,
    int n, int m, int nb, int iters, int ruiz_iters, int deferred_rho,
    float sigma, float relax, float rho_base, float rho_eq_scale, void* stream) {
  const int bytes = rlmpc_qp_shared_bytes(n, m, nb);
  if (bytes < 0 || bytes > rlmpc::kMaxSharedBytes || batch <= 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rlmpc::fused_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  rlmpc::PSolveArgs a;
  a.io = rlmpc::solve_io(q, c_blocks, lb, ub, mask, x0, z0, y0, rho_mult,
                         x_out, z_out, y_out, rm_out, viol_out, res_out,
                         rlmpc::qp_dense_dims(n, m, nb),
                         iters, ruiz_iters, deferred_rho, sigma, relax,
                         rho_base, rho_eq_scale);
  a.p_mat = p_mat;
  rlmpc::fused_solve_kernel<<<batch, rlmpc::kThreads, bytes,
                              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif

}  // extern "C"
