// Runs the QP kernels of rl_mpc_locomotion_tpu_torch/csrc on the host, block
// after block, with the block's threads as std::threads (see shim.h). One
// plain C entry a kernel for ctypes, with the argument order of the matching
// rlmpc_* launch function, host pointers, no stream.
//
//   g++ -std=c++20 -O1 -pthread -shared -fPIC \
//       -I rl_mpc_locomotion_tpu_torch/csrc -o libemu.so \
//       tests/host_emulation/emulate.cpp
#define RLMPC_HOST_EMULATION 1
#include "shim.h"

#include <memory>
#include <thread>
#include <vector>

// found through -I <package>/csrc
#include "fused_qp.cu"
#include "mpc_assembly.cu"
#include "phase_probe.cu"
#include "scaled_solve.cu"

namespace {

// kernel(args) for every block of a grid of `blocks`, nt threads a block,
// `bytes` of shared memory filled with NaN, so a read of shared memory nobody
// wrote shows in the output.
template <class Kernel, class Args>
int run_blocks(Kernel kernel, const Args& a, int blocks, int bytes, int nt) {
  if (bytes < 0 || blocks <= 0) return 1;
  for (int b = 0; b < blocks; ++b) {
    std::vector<float> shared(bytes / sizeof(float), NAN);
    std::vector<float> exchange(nt, 0.0f);
    std::barrier<> bar(nt);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w * 32 < nt; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(
          nt - 32 * w < 32 ? nt - 32 * w : 32));
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t)
      threads.emplace_back([&, t, b]() {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = nt;
        gridDim.x = blocks;
        emu_barrier = &bar;
        emu_warp_barrier = warps[t / 32].get();
        emu_shared = shared.data();
        emu_exchange = exchange.data();
        kernel(a);
      });
    for (auto& th : threads) th.join();
  }
  return 0;
}

}  // namespace

extern "C" int rlmpc_emulate_fused_solve_chain(
    const float* s_chain, const float* weights, const float* q,
    const float* c_blocks, const float* lb, const float* ub, const float* mask,
    const float* x0, const float* z0, const float* y0, const float* rho_mult,
    float* x_out, float* z_out, float* y_out, float* rm_out, float* viol_out,
    float* res_out, int batch, int n, int m, int nb, int h, int sd, int iters,
    int ruiz_iters, int deferred_rho, float alpha, float sigma, float relax,
    float rho_base, float rho_eq_scale) {
  rlmpc::ChainSolveArgs a;
  a.io = rlmpc::solve_io(q, c_blocks, lb, ub, mask, x0, z0, y0, rho_mult,
                         x_out, z_out, y_out, rm_out, viol_out, res_out,
                         rlmpc::QpDims{n, m, nb, h, sd, n / h, rlmpc::qp_ld(n)},
                         iters, ruiz_iters, deferred_rho, sigma, relax,
                         rho_base, rho_eq_scale);
  a.s_chain = s_chain; a.weights = weights; a.alpha = alpha;
  return run_blocks(rlmpc::fused_solve_chain_kernel, a, batch,
                    rlmpc_fused_chain_shared_bytes(n, m, nb, h, sd),
                    rlmpc::kThreads);
}

// The robot-solves of fused_solve_chain_kernel that took the compact path
// since the last reset (rlmpc_compact_solves on the card).
extern "C" unsigned long long rlmpc_emulate_compact_solves() {
  return rlmpc::g_compact_solves;
}

extern "C" void rlmpc_emulate_reset_compact_solves() {
  rlmpc::g_compact_solves = 0;
}

extern "C" int rlmpc_emulate_fused_solve(
    const float* p_mat, const float* q, const float* c_blocks, const float* lb,
    const float* ub, const float* mask, const float* x0, const float* z0,
    const float* y0, const float* rho_mult, float* x_out, float* z_out,
    float* y_out, float* rm_out, float* viol_out, float* res_out, int batch,
    int n, int m, int nb, int iters, int ruiz_iters, int deferred_rho,
    float sigma, float relax, float rho_base, float rho_eq_scale) {
  rlmpc::PSolveArgs a;
  a.io = rlmpc::solve_io(q, c_blocks, lb, ub, mask, x0, z0, y0, rho_mult,
                         x_out, z_out, y_out, rm_out, viol_out, res_out,
                         rlmpc::qp_dense_dims(n, m, nb),
                         iters, ruiz_iters, deferred_rho, sigma, relax,
                         rho_base, rho_eq_scale);
  a.p_mat = p_mat;
  return run_blocks(rlmpc::fused_solve_kernel, a, batch,
                    rlmpc_qp_shared_bytes(n, m, nb), rlmpc::kThreads);
}

extern "C" int rlmpc_emulate_scaled_solve(
    const float* k_mat, const float* q_s, const float* c_s, const float* l_s,
    const float* u_s, const float* rho, const float* x0, const float* z0,
    const float* y0, float* x_out, float* z_out, float* y_out, int batch,
    int n, int m, int nb, int iters, float sigma, float relax) {
  rlmpc::ScaledSolveArgs a;
  a.k_mat = k_mat; a.q_s = q_s; a.c_s = c_s; a.l_s = l_s; a.u_s = u_s;
  a.rho = rho; a.x0 = x0; a.z0 = z0; a.y0 = y0;
  a.x_out = x_out; a.z_out = z_out; a.y_out = y_out;
  a.dm = rlmpc::qp_dense_dims(n, m, nb);
  a.iters = iters; a.sigma = sigma; a.relax = relax;
  return run_blocks(rlmpc::scaled_solve_kernel, a, batch,
                    rlmpc_qp_shared_bytes(n, m, nb), rlmpc::kThreads);
}

extern "C" int rlmpc_emulate_stripped_solve(
    const float* p_mat, const float* q, const float* c_blocks, float* out,
    int batch, int n, int m, int nb, int stage, int ruiz_iters, int admm_iters,
    float rho, float sigma, float relax, float bound) {
  rlmpc::StrippedArgs a;
  a.p_mat = p_mat; a.q = q; a.c_blocks = c_blocks; a.out = out;
  a.dm = rlmpc::qp_dense_dims(n, m, nb);
  a.stage = stage; a.ruiz_iters = ruiz_iters; a.admm_iters = admm_iters;
  a.rho = rho; a.sigma = sigma; a.relax = relax; a.bound = bound;
  return run_blocks(rlmpc::stripped_solve_kernel, a, batch,
                    rlmpc_qp_shared_bytes(n, m, nb), rlmpc::kThreads);
}

extern "C" int rlmpc_emulate_bm_dma(const float* p_pad, const float* q,
                                    float* out, int batch, int n, int np,
                                    int transpose) {
  // a grid of two persistent blocks, so that a block's ring wraps at B > 6
  rlmpc::BmDmaArgs a;
  a.p_pad = p_pad; a.q = q; a.out = out;
  a.batch = batch; a.n = n; a.np = np; a.transpose = transpose;
  a.slots = rlmpc::bm_dma_slots(n, np);
  return run_blocks(rlmpc::bm_dma_kernel, a, batch < 2 ? batch : 2,
                    rlmpc_bm_dma_shared_bytes(n, np), rlmpc::kThreads);
}

extern "C" int rlmpc_emulate_mpc_assembly(
    const float* rpy, const float* com_z, const float* omega,
    const float* vel, const float* feet, const float* table,
    const float* weights, const float* commands, const float* normal,
    const float* mass, const float* inertia, const float* height,
    const float* mu, float* s_chain, float* q, float* lb, float* ub,
    float* mask, int batch, int h, int per_robot, float dt) {
  const rlmpc::MpcAssemblyArgs a{
      rpy, com_z, omega, vel, feet, table, weights, commands, normal, mass,
      inertia, height, mu, s_chain, q, lb, ub, mask, batch, h, per_robot, dt};
  return run_blocks(rlmpc::mpc_assembly_kernel, a,
                    (batch + rlmpc::kAsmRobots - 1) / rlmpc::kAsmRobots,
                    4 * rlmpc::mpc_assembly_shared_floats(h),
                    rlmpc::kAsmThreads);
}
