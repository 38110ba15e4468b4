// Runs fused_solve_chain_kernel on the host, block after block, with the
// block's threads as std::threads (see shim.h). Plain C entry for ctypes with
// the argument order of rlmpc_fused_solve_chain, host pointers, no stream.
//
//   g++ -std=c++20 -O1 -pthread -shared -fPIC \
//       -I rl_mpc_locomotion_tpu_torch/csrc -o libemu.so \
//       tests/host_emulation/emulate.cpp
#define RLMPC_HOST_EMULATION 1
#include "shim.h"

#include <thread>
#include <vector>

#include "fused_qp.cu"  // found through -I <package>/csrc

extern "C" int rlmpc_emulate_fused_solve_chain(
    const float* s_chain, const float* weights, const float* q,
    const float* c_blocks, const float* lb, const float* ub, const float* mask,
    const float* x0, const float* z0, const float* y0, const float* rho_mult,
    float* x_out, float* z_out, float* y_out, float* rm_out, float* viol_out,
    float* res_out, int batch, int n, int m, int nb, int h, int sd, int iters,
    int ruiz_iters, int deferred_rho, float alpha, float sigma, float relax,
    float rho_base, float rho_eq_scale) {
  const int bytes = rlmpc_fused_chain_shared_bytes(n, m, nb, h, sd);
  if (bytes < 0 || batch <= 0) return 1;
  rlmpc::ChainSolveArgs a;
  a.s_chain = s_chain; a.weights = weights; a.q = q; a.c_blocks = c_blocks;
  a.lb = lb; a.ub = ub; a.mask = mask; a.x0 = x0; a.z0 = z0; a.y0 = y0;
  a.rho_mult = rho_mult;
  a.x_out = x_out; a.z_out = z_out; a.y_out = y_out; a.rm_out = rm_out;
  a.viol_out = viol_out; a.res_out = res_out;
  a.dm = rlmpc::QpDims{n, m, nb, h, sd, n / h, rlmpc::qp_ld(n)};
  a.iters = iters; a.ruiz_iters = ruiz_iters; a.deferred_rho = deferred_rho;
  a.alpha = alpha; a.sigma = sigma; a.relax = relax; a.rho_base = rho_base;
  a.rho_eq_scale = rho_eq_scale;
  const int nt = rlmpc::kThreads;
  for (int b = 0; b < batch; ++b) {
    // NaN-filled, so a read of shared memory nobody wrote shows in the output
    std::vector<float> shared(bytes / sizeof(float), NAN);
    std::vector<float> exchange(nt, 0.0f);
    std::barrier<> bar(nt);
    std::vector<std::thread> threads;
    for (int t = 0; t < nt; ++t)
      threads.emplace_back([&, t, b]() {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = nt;
        emu_barrier = &bar;
        emu_shared = shared.data();
        emu_exchange = exchange.data();
        rlmpc::fused_solve_chain_kernel(a);
      });
    for (auto& th : threads) th.join();
  }
  return 0;
}
