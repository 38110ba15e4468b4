// The MPC problem of every robot assembled in one pass: the foot positions in
// the world frame, the world inverse inertia, the continuous A and B, their
// exact zero-order-hold discretisation, the chain s[k] = A_exp^k B_exp, the
// gradient q = 2 B_qp^T Q (A_qp x0 - x_des), the bounds of the cone rows and
// the swing mask. Its plain version is assemble_mpc_batch_reference in
// ops/cuda/mpc_assembly.py, the PyTorch code that control/locomotion.py ran
// before; it replaces no TPU kernel (the JAX package leaves the assembly to
// XLA), and was written because those ~215 small launches, and their round
// trips through device memory, cost more of a fleet period than the work.
//
// What bounds it on an H100: bytes. A robot reads ~0.36 KB (state, feet,
// contact table, commands, parameters) and writes 8.8 KB at horizon 10
// (s_chain 6240 B, q 480 B, lb and ub 1600 B, mask 480 B); at 262144 robots
// that is 2.4 GB, 0.72 ms at 3.35 TB/s. The arithmetic is a few hundred
// operations a robot.
//
// What the design does about it. The continuous A has nonzeros only in rows
// 0-2 x cols 6-8 (W, angular velocity to rpy rate), rows 3-5 x cols 9-11 (I)
// and rows 9-11 x col 12 (the ground normal), and A^2 is the normal in rows
// 3-5 x col 12 alone, so A^3 = 0 and A_exp^k = I + k dt A + (k dt)^2/2 A^2
// exactly. With A^2 B = A^2 B_exp = 0 the chain is affine in k:
//   s[k] = S0 + k S1,  S0 = B_exp,  S1 = dt A B_exp,
// where S1 is nonzero in rows 0-5 only (dt^2 W T and dt^2/m), T the
// per-leg torque block I_w^-1 [r]x. The gradient regroups the same way:
//   q[a] = 2 (S0^T V_a + S1^T K_a),  V_a = sum_{j>=a} wsd[j],
//   K_a = sum_{j>=a} (j-a) wsd[j],
// two running sums from the end of the horizon, wsd[j] = w * (A_exp^(j+1) x0
// - x_des[j]) in its closed form, the last block of A_qp zeroed as the
// reference's fill loop leaves it (compat_last_aqp_zero). Nothing but the
// inputs and the five outputs touches device memory.
//
// Layout: kAsmRobots robots a block, kAsmLanes threads a robot in the set-up
// phase (lane c < 12 owns column c of B: leg c / 3, axis c % 3; lane 12 the
// bounds). Set-up writes S0, S1 and q to shared memory; then the whole block
// writes its robots' outputs, which lie contiguous in every output, with
// 16-byte stores on neighbouring addresses: s[k] as S0 + k S1 from shared
// memory, q copied, lb / ub / mask from the contact table staged in shared
// memory. Every output of a robot is a whole number of 16-byte words at any
// horizon (156 h, 12 h, 20 h and 12 h floats).
//
// Float32 throughout, accurate sinf / cosf / tanf, divisions correctly
// rounded (no fast-math). It differs from the plain version in rounding
// only: the closed forms and the regrouped sums take other orders than the
// repeated 13 x 13 products and cuBLAS's sums.
//
// Plain C interface for ctypes, as fused_qp.cu: device pointers, the launch
// function returns the cudaError_t of the launch.
#ifndef RLMPC_HOST_EMULATION
#include <cuda_runtime.h>
#endif

namespace rlmpc {

constexpr int kAsmRobots = 16;                      // robots a block
constexpr int kAsmLanes = 16;                       // set-up threads a robot
constexpr int kAsmThreads = kAsmRobots * kAsmLanes;
constexpr int kAsmChain = 13 * 12;                  // floats of one s[k]
constexpr int kAsmChainWords = kAsmChain / 4;       // 16-byte words of s[k]
constexpr int kAsmRate = 6 * 12;                    // rows 0-5 of S1
constexpr int kAsmRateWords = kAsmRate / 4;
constexpr int kAsmMaxShared = 232448;               // 227 KB a block on sm_90
constexpr float kAsmGravity = 9.8f;

// which inputs carry a robot axis (else one value serves the batch)
enum : int {
  kPerRobotWeights = 1, kPerRobotNormal = 2, kPerRobotMass = 4,
  kPerRobotInertia = 8, kPerRobotHeight = 16, kPerRobotMu = 32
};

struct MpcAssemblyArgs {
  const float* rpy;       // (B, 3) body rpy in the yaw-aligned ground frame
  const float* com_z;     // (B,) estimated CoM height
  const float* omega;     // (B, 3) body angular velocity
  const float* vel;       // (B, 3) body velocity
  const float* feet;      // (B, 4, 3) foot positions about the CoM, body frame
  const float* table;     // (B, h, 4) contact table in {0, 1}, 16-byte aligned
  const float* weights;   // (13,) or (B, 13)
  const float* commands;  // (B, 3) vx, vy, yaw rate
  const float* normal;    // (3,) or (B, 3) ground normal
  const float* mass;      // () or (B,)
  const float* inertia;   // (3, 3) or (B, 3, 3) body inertia
  const float* height;    // () or (B,) body height
  const float* mu;        // () or (B,) friction coefficient
  float* s_chain;         // (B, h, 13, 12)
  float* q;               // (B, 12 h)
  float* lb;              // (B, 20 h)
  float* ub;              // (B, 20 h)
  float* mask;            // (B, 12 h)
  int batch, h, per_robot;
  float dt;
};

// Shared floats a block: S0 (156), S1's rows 0-5 (72) and the bounds (4) a
// robot, then q (12 h) and the contact table (4 h) a robot.
__host__ __device__ inline int mpc_assembly_shared_floats(int h) {
  return kAsmRobots * (kAsmChain + kAsmRate + 4 + 16 * h);
}

__device__ __forceinline__ const float* robot_row(const float* p, int rb,
                                                  int size, bool per_robot) {
  return per_robot ? p + (size_t)rb * size : p;
}

// Lane `col` < 12 of robot rb: column col of S0 and S1 (col-major strides of
// 12 in the row-major blocks) and q[., col] for the whole horizon.
__device__ void assemble_column(const MpcAssemblyArgs& a, int rb, int col,
                                float* s0, float* s1, float* sq) {
  const int h = a.h, leg = col / 3, ax = col - 3 * leg;
  const int pr = a.per_robot;
  const float* rpy = a.rpy + (size_t)rb * 3;
  const float roll = rpy[0], pitch = rpy[1], yaw = rpy[2];
  const float sr = sinf(roll), cr = cosf(roll);
  const float sp = sinf(pitch), cp = cosf(pitch), tp = tanf(pitch);
  const float sy = sinf(yaw), cy = cosf(yaw);

  // foot in the world frame: Rx(r) Ry(p) Rz(y) active, the reference's order
  // for the feet
  const float* f = a.feet + (size_t)rb * 12 + 3 * leg;
  const float vx = cy * f[0] - sy * f[1], vy = sy * f[0] + cy * f[1];
  const float ux = cp * vx + sp * f[2], uz = -sp * vx + cp * f[2];
  const float fx = ux, fy = cr * vy - sr * uz, fz = sr * vy + cr * uz;

  // column ax of [r]x, then T[:, col] = R I^-1 R^T [r]x[:, ax] with the
  // inertia's rotation R = Rz(y) Ry(p) Rx(r) active
  const float sk0 = ax == 0 ? 0.f : (ax == 1 ? -fz : fy);
  const float sk1 = ax == 0 ? fz : (ax == 1 ? 0.f : -fx);
  const float sk2 = ax == 0 ? -fy : (ax == 1 ? fx : 0.f);
  const float r00 = cy * cp, r01 = cy * sp * sr - sy * cr,
              r02 = cy * sp * cr + sy * sr;
  const float r10 = sy * cp, r11 = sy * sp * sr + cy * cr,
              r12 = sy * sp * cr - cy * sr;
  const float r20 = -sp, r21 = cp * sr, r22 = cp * cr;
  const float b0 = r00 * sk0 + r10 * sk1 + r20 * sk2;
  const float b1 = r01 * sk0 + r11 * sk1 + r21 * sk2;
  const float b2 = r02 * sk0 + r12 * sk1 + r22 * sk2;
  // I^-1 b by the adjugate
  const float* in = robot_row(a.inertia, rb, 9, pr & kPerRobotInertia);
  const float i00 = in[0], i01 = in[1], i02 = in[2], i10 = in[3],
              i11 = in[4], i12 = in[5], i20 = in[6], i21 = in[7],
              i22 = in[8];
  const float c00 = i11 * i22 - i12 * i21, c01 = i02 * i21 - i01 * i22,
              c02 = i01 * i12 - i02 * i11;
  const float c10 = i12 * i20 - i10 * i22, c11 = i00 * i22 - i02 * i20,
              c12 = i02 * i10 - i00 * i12;
  const float c20 = i10 * i21 - i11 * i20, c21 = i01 * i20 - i00 * i21,
              c22 = i00 * i11 - i01 * i10;
  const float det = i00 * c00 + i01 * c10 + i02 * c20;
  const float e0 = (c00 * b0 + c01 * b1 + c02 * b2) / det;
  const float e1 = (c10 * b0 + c11 * b1 + c12 * b2) / det;
  const float e2 = (c20 * b0 + c21 * b1 + c22 * b2) / det;
  const float t0 = r00 * e0 + r01 * e1 + r02 * e2;
  const float t1 = r10 * e0 + r11 * e1 + r12 * e2;
  const float t2 = r20 * e0 + r21 * e1 + r22 * e2;

  // W, the angular velocity to rpy-rate map of A's rows 0-2
  const float w00 = cy / cp, w01 = sy / cp, w20 = cy * tp, w21 = sy * tp;
  const float wt0 = w00 * t0 + w01 * t1;
  const float wt1 = -sy * t0 + cy * t1;
  const float wt2 = w20 * t0 + w21 * t1 + t2;

  const float m = *robot_row(a.mass, rb, 1, pr & kPerRobotMass);
  const float inv_m = 1.0f / m;
  const float dt = a.dt, dt2 = dt * dt, half_dt2 = 0.5f * dt2;
  // S0 = B_exp: rows 0-2 dt^2/2 W T, rows 3-5 dt^2/(2m) on the leg's
  // diagonal, rows 6-8 dt T, rows 9-11 dt/m; row 12 zero
  const float wt[3] = {wt0, wt1, wt2}, tc[3] = {t0, t1, t2};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s0[c * 12 + col] = half_dt2 * wt[c];
    s0[(3 + c) * 12 + col] = c == ax ? half_dt2 * inv_m : 0.f;
    s0[(6 + c) * 12 + col] = dt * tc[c];
    s0[(9 + c) * 12 + col] = c == ax ? dt * inv_m : 0.f;
    s1[c * 12 + col] = dt2 * wt[c];
    s1[(3 + c) * 12 + col] = c == ax ? dt2 * inv_m : 0.f;
  }
  s0[12 * 12 + col] = 0.f;

  // the gradient, from the end of the horizon: wsd[j] = w * (x_pred[j] -
  // x_des[j]) with x_pred[j] = A_exp^(j+1) x0 (zero for the last block),
  // only the rows that column col of S0 and S1 reads
  const float* w = robot_row(a.weights, rb, 13, pr & kPerRobotWeights);
  const float* nrm = robot_row(a.normal, rb, 3, pr & kPerRobotNormal);
  const float* om = a.omega + (size_t)rb * 3;
  const float* v = a.vel + (size_t)rb * 3;
  const float* cmd = a.commands + (size_t)rb * 3;
  const float height = *robot_row(a.height, rb, 1, pr & kPerRobotHeight);
  const float z = a.com_z[rb];
  const float wom0 = w00 * om[0] + w01 * om[1];
  const float wom1 = -sy * om[0] + cy * om[1];
  const float wom2 = w20 * om[0] + w21 * om[1] + om[2];
  const float g_ax = -kAsmGravity * nrm[ax];
  const float p_ax = ax == 2 ? z : 0.f;
  const float pdes_ax = ax == 2 ? height : 0.f;
  const float vdes_ax = ax == 2 ? 0.f : cmd[ax];
  // V (rows 0-2, 3 + ax, 6-8, 9 + ax) and K (rows 0-2, 3 + ax)
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, vp = 0.f, v6 = 0.f, v7 = 0.f,
        v8 = 0.f, vv = 0.f;
  float k0 = 0.f, k1 = 0.f, k2 = 0.f, kp = 0.f;
  for (int j = h - 1; j >= 0; --j) {
    k0 += v0; k1 += v1; k2 += v2; kp += vp;
    const float tj = (float)(j + 1) * dt;
    const float live = j == h - 1 ? 0.f : 1.f;
    const float des_pos = ax == 2 ? pdes_ax : tj * vdes_ax;
    v0 += w[0] * (live * (roll + tj * wom0));
    v1 += w[1] * (live * (pitch + tj * wom1));
    v2 += w[2] * (live * (yaw + tj * wom2) - (yaw + tj * cmd[2]));
    vp += w[3 + ax] * (live * (p_ax + tj * v[ax] + 0.5f * tj * tj * g_ax)
                       - des_pos);
    v6 += w[6] * (live * om[0]);
    v7 += w[7] * (live * om[1]);
    v8 += w[8] * (live * om[2] - cmd[2]);
    vv += w[9 + ax] * (live * (v[ax] + tj * g_ax) - vdes_ax);
    sq[j * 12 + col] =
        2.f * (half_dt2 * (wt0 * v0 + wt1 * v1 + wt2 * v2 + inv_m * vp)
               + dt * (t0 * v6 + t1 * v7 + t2 * v8 + inv_m * vv)
               + dt2 * (wt0 * k0 + wt1 * k1 + wt2 * k2 + inv_m * kp));
  }
}

__global__ void __launch_bounds__(kAsmThreads)
mpc_assembly_kernel(const MpcAssemblyArgs a) {
#ifdef RLMPC_HOST_EMULATION
  float* smem = emu_shared;
#else
  extern __shared__ __align__(16) float smem[];
#endif
  const int h = a.h, tid = threadIdx.x;
  float* s0 = smem;
  float* s1 = s0 + kAsmRobots * kAsmChain;
  float* bnd = s1 + kAsmRobots * kAsmRate;
  float* sq = bnd + kAsmRobots * 4;
  float* tab = sq + kAsmRobots * 12 * h;
  const int rb0 = blockIdx.x * kAsmRobots;
  const int nr = a.batch - rb0 < kAsmRobots ? a.batch - rb0 : kAsmRobots;

  {  // the block's contact tables, contiguous in device memory
    const float4* src =
        reinterpret_cast<const float4*>(a.table + (size_t)rb0 * 4 * h);
    float4* dst = reinterpret_cast<float4*>(tab);
    for (int i = tid; i < nr * h; i += kAsmThreads) dst[i] = src[i];
  }
  const int r = tid / kAsmLanes, lane = tid - r * kAsmLanes;
  if (r < nr) {
    const int rb = rb0 + r;
    if (lane < 12) {
      assemble_column(a, rb, lane, s0 + r * kAsmChain, s1 + r * kAsmRate,
                      sq + r * 12 * h);
    } else if (lane == 12) {
      // fz in [0.1, 10] m g, friction rows in [0, (mu + 1) fz_max]
      const float m = *robot_row(a.mass, rb, 1, a.per_robot & kPerRobotMass);
      const float mu = *robot_row(a.mu, rb, 1, a.per_robot & kPerRobotMu);
      const float mg = m * kAsmGravity;
      const float fz_max = mg * 10.0f;
      bnd[r * 4 + 0] = mg * 0.1f;
      bnd[r * 4 + 1] = fz_max;
      bnd[r * 4 + 2] = (mu + 1.0f) * fz_max;
    }
  }
  __syncthreads();

  // s[k] = S0 + k S1 (S1 in rows 0-5, the first kAsmRateWords words)
  const float4* s04 = reinterpret_cast<const float4*>(s0);
  const float4* s14 = reinterpret_cast<const float4*>(s1);
  float4* chain = reinterpret_cast<float4*>(a.s_chain) +
                  (size_t)rb0 * kAsmChainWords * h;
  for (int i = tid; i < nr * kAsmChainWords * h; i += kAsmThreads) {
    const int rk = i / kAsmChainWords, e = i - rk * kAsmChainWords;
    const int rr = rk / h;
    float4 o = s04[rr * kAsmChainWords + e];
    if (e < kAsmRateWords) {
      const float k = (float)(rk - rr * h);
      const float4 g = s14[rr * kAsmRateWords + e];
      o.x = fmaf(k, g.x, o.x);
      o.y = fmaf(k, g.y, o.y);
      o.z = fmaf(k, g.z, o.z);
      o.w = fmaf(k, g.w, o.w);
    }
    chain[i] = o;
  }
  // q and the mask, 3 h words a robot
  const float4* sq4 = reinterpret_cast<const float4*>(sq);
  float4* q4 = reinterpret_cast<float4*>(a.q) + (size_t)rb0 * 3 * h;
  float4* mask4 = reinterpret_cast<float4*>(a.mask) + (size_t)rb0 * 3 * h;
  for (int i = tid; i < nr * 3 * h; i += kAsmThreads) {
    q4[i] = sq4[i];
    const int f = 4 * i;  // a foot-step's three variables share its entry
    mask4[i] = make_float4(tab[f / 3], tab[(f + 1) / 3], tab[(f + 2) / 3],
                           tab[(f + 3) / 3]);
  }
  // lb and ub, 5 h words a robot: a foot-step's rows 0-3 friction, row 4 fz
  float4* lb4 = reinterpret_cast<float4*>(a.lb) + (size_t)rb0 * 5 * h;
  float4* ub4 = reinterpret_cast<float4*>(a.ub) + (size_t)rb0 * 5 * h;
  for (int i = tid; i < nr * 5 * h; i += kAsmThreads) {
    const float* bd = bnd + 4 * (i / (5 * h));
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = 4 * i + j, cell = f / 5;
      const float c = tab[cell];
      const bool fz = f - 5 * cell == 4;
      lo[j] = fz ? bd[0] * c : 0.f;
      hi[j] = (fz ? bd[1] : bd[2]) * c;
    }
    lb4[i] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    ub4[i] = make_float4(hi[0], hi[1], hi[2], hi[3]);
  }
}

}  // namespace rlmpc

#ifndef RLMPC_HOST_EMULATION
// Dynamic shared memory a block of mpc_assembly_kernel needs at horizon h,
// or -1 for a horizon it does not take.
extern "C" int rlmpc_mpc_assembly_shared_bytes(int h) {
  if (h < 1) return -1;
  const long long bytes = 4LL * rlmpc::mpc_assembly_shared_floats(h);
  return bytes > rlmpc::kAsmMaxShared ? -1 : (int)bytes;
}

extern "C" int rlmpc_mpc_assembly(
    const float* rpy, const float* com_z, const float* omega,
    const float* vel, const float* feet, const float* table,
    const float* weights, const float* commands, const float* normal,
    const float* mass, const float* inertia, const float* height,
    const float* mu, float* s_chain, float* q, float* lb, float* ub,
    float* mask, int batch, int h, int per_robot, float dt, void* stream) {
  const int bytes = rlmpc_mpc_assembly_shared_bytes(h);
  if (bytes < 0 || batch <= 0) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rlmpc::mpc_assembly_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const rlmpc::MpcAssemblyArgs a{
      rpy, com_z, omega, vel, feet, table, weights, commands, normal, mass,
      inertia, height, mu, s_chain, q, lb, ub, mask, batch, h, per_robot, dt};
  const int blocks = (batch + rlmpc::kAsmRobots - 1) / rlmpc::kAsmRobots;
  rlmpc::mpc_assembly_kernel<<<blocks, rlmpc::kAsmThreads, bytes,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
