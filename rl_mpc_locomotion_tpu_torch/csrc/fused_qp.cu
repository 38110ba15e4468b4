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

// Robot-solves of fused_solve_chain_kernel that took the compact path, one
// atomicAdd a block; read and reset through rlmpc_compact_solves /
// rlmpc_reset_compact_solves.
__device__ unsigned long long g_compact_solves = 0;

// Phases 2-8 for robot rb with its raw P in the tile: load the robot's
// vectors, mask, Ruiz, K, inverse, ADMM, residuals and rho, unscale, write
// out. kCompact (row 1 only, n_s <= kCompactVars): the vectors and cone
// blocks in the compact order, the stance block inverted alone and the swing
// blocks each by itself, the outputs in the input's order. n_s is read from
// shared memory where it is used, never held beside the whole tile.
template <bool kCompact>
__device__ __forceinline__ void solve_from_tile(const SolveIO& a, const QpShared& s,
                                                const QpThread& t, int rb,
                                                KTile& kt) {
  const QpDims dm = a.dm;
  const int n = dm.n, m = dm.m;
  const float* c0 = a.c_blocks + (size_t)rb * dm.nb * 15;
  const float* lb = a.lb + (size_t)rb * m;
  const float* ub = a.ub + (size_t)rb * m;
  if constexpr (kCompact) {   // gathered through the compact order
    for (int j = t.tid; j < n; j += t.nt) {
      const size_t g = (size_t)rb * n + src_var(s, j);
      s.q[j] = a.q[g];
      s.xt[j] = a.mask[g];
      s.x[j] = a.x0[g];
      s.d[j] = 1.0f;
    }
    for (int r = t.tid; r < m; r += t.nt) {
      const int ro = src_row(s, r);
      s.l[r] = lb[ro];
      s.u[r] = ub[ro];
      s.z[r] = a.z0[(size_t)rb * m + ro];
      s.y[r] = a.y0[(size_t)rb * m + ro];
      s.e[r] = 1.0f;
    }
    for (int i = t.tid; i < dm.nb * 15; i += t.nt) {
      const int k = i / 15;
      s.cs[i] = c0[15 * s.order[2 + k] + (i - 15 * k)];
    }
  } else {   // as written before the compact path: in another form the
             // same loads compiled to a row 1 that spills
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
  }
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
  if constexpr (kCompact) {
    const int ns = stance_vars(s);
    split_swing(dm, s, t, kt, ns);
    spd_invert<kCompactSlots>(s, t, kt, ns);
  } else {
    spd_invert(s, t, kt, dm.n);
  }
  const QpShared sa = qp_carve(s.inv, launder(dm), t.nt);
  int nsa = 0;
  if constexpr (kCompact) {
    nsa = stance_vars(sa);
    swing_invert(dm, sa, t, nsa);   // admm's first barrier publishes them
  }
  admm<kCompact>(dm, sa, t, kt, a.iters, a.sigma, a.relax, nsa);
  float pri_rel, dua_rel;
  const float new_rm = residuals_rho<kCompact>(
      dm, sa, t, kt, a.sigma, sa.keep[1], a.deferred_rho != 0, &pri_rel,
      &dua_rel, nsa);
  const size_t ra = (size_t)launder(rb);
  const float viol = unscale<kCompact>(
      dm, sa, t, sa.keep[0], a.c_blocks + ra * dm.nb * 15, a.lb + ra * m,
      a.ub + ra * m, a.x_out + ra * n, a.z_out + ra * m, a.y_out + ra * m);
  if (t.tid == 0) {
    a.rm_out[ra] = new_rm;
    a.viol_out[ra] = viol;
    a.res_out[2 * ra] = pri_rel;
    a.res_out[2 * ra + 1] = dua_rel;
    if constexpr (kCompact) atomicAdd(&g_compact_solves, 1ull);
  }
}

// The block's index and the thread's coordinates read anew from the
// special registers, by an asm read the compiler cannot merge with an
// earlier one. The compact path takes them so, and so holds no value of the
// code before the branch: one that it did hold would be live across the
// dense path too, which fills every register, and one of the two would
// spill.
__device__ __forceinline__ int sreg_anew_tid() {
#ifdef RLMPC_HOST_EMULATION
  return threadIdx.x;
#else
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
#endif
}

__device__ __forceinline__ int sreg_anew_ctaid() {
#ifdef RLMPC_HOST_EMULATION
  return blockIdx.x;
#else
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
#endif
}

__device__ __forceinline__ QpThread qp_thread_anew() {
  QpThread t;
  t.tid = sreg_anew_tid();
  t.nt = kThreads;
  t.ty = t.tid / kGrid;
  t.tx = t.tid - t.ty * kGrid;
  return t;
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

  // 1. chain and weights in, the live foot-steps from the mask; the path;
  // P built in shared memory and read into the tile (through the compact
  // order on the compact path); the chain's space is reused by the vectors
  // from here
  const int cl = dm.h * dm.sd * dm.ad;
  const float* g = a.s_chain + (size_t)rb * cl;
  for (int i = t.tid; i < cl; i += t.nt) s.chain[i] = g[i];
  const float* gw = a.weights + (size_t)rb * dm.sd;
  for (int i = t.tid; i < dm.sd; i += t.nt) s.chain[cl + i] = gw[i];
  live_set(dm, s, t, a.io.mask + (size_t)rb * dm.n);
  __syncthreads();
  KTile kt;
  if (stance_vars(s) <= kCompactVars) {   // uniform in the block
    const QpThread tc = qp_thread_anew();
    const QpShared sc = qp_carve(smem, launder(dm), tc.nt);
    compact_order(dm, sc, tc);
    build_p_from_chain(dm, sc, tc, a.alpha);
    load_tile_compact(dm, sc, tc, stance_vars(sc), kt);
    solve_from_tile<true>(a.io, sc, tc, sreg_anew_ctaid(), kt);
  } else {
    build_p_from_chain(dm, s, t, a.alpha);
    load_tile(dm, t, s.K, dm.ld, kt);
    solve_from_tile<false>(a.io, s, t, rb, kt);
  }
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

  solve_from_tile<false>(a.io, s, t, rb, kt);
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

// The robot-solves of fused_solve_chain_kernel that took the compact path on
// the current device since the last reset, into *out; a cudaError_t.
// Synchronous: it waits for the kernels queued before it.
int rlmpc_compact_solves(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, rlmpc::g_compact_solves, sizeof(*out));
}

int rlmpc_reset_compact_solves() {
  const unsigned long long zero = 0;
  return (int)cudaMemcpyToSymbol(rlmpc::g_compact_solves, &zero, sizeof(zero));
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
