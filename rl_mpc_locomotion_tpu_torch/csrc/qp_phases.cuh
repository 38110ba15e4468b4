// Device-side phases of the GRF-QP solve on one robot's KKT matrix held in
// shared memory. One thread block owns one robot; every phase is a
// __device__ function over a `QpShared` view of the block's dynamic shared
// memory, so a kernel entry is a thin sequence of phases:
//
//   build_p_from_chain  P = 2 B_qp^T Q B_qp + alpha I from the chain A^k B
//   mask                swing-variable masking of P and q
//   ruiz                modified Ruiz equilibration + cost scaling
//   assemble_k          per-row rho, K = P + sigma I + C^T rho C, bounds and
//                       warm start moved into the scaled problem
//   spd_invert          K^-1 into registers (Gauss-Jordan, no pivoting: K is SPD)
//   admm                fixed-count OSQP iterations, K^-1 resident in registers
//   residuals_rho       relative residuals at x~ and the deferred rho rescale
//   unscale             unscaled x, z, y and the primal violation
//
// Replaces the TPU kernel bodies rl_mpc_locomotion_tpu/ops/pallas/fused_qp.py
// (_fused_kernel_chain, _fused_kernel, _solve_phases, _ruiz_in_vmem) together
// with admm_kernel.py (_gj_admm_kernel, gj_invert_symmetric,
// gj_invert_inplace, _admm_math). The entries that use them: fused_qp.cu
// (chain and prebuilt-P solves), scaled_solve.cu (inverse + ADMM on a scaled
// K), phase_probe.cu (the solve cut after a stage, for phase timing). The
// arithmetic and the
// I/O contract are the same; the layout is not: a robot's 120x120 matrix is
// 57.6 KB, so it lives in one block's shared memory and the block's threads
// work on its columns.
//
// What bounds it on an H100: global traffic is ~15 KB a robot, the work is
// ~3 MFLOP a robot, a third of it the inverse, every operand on the SM. It is
// bound by f32 arithmetic and, in this version, by the latency of the 120
// dependent pivot steps of the inverse, not by device memory. The design keeps
// all of a solve in one launch with K never leaving the SM; gives rows an odd
// stride so row-wise and column-wise walks are both free of bank conflicts;
// moves K into registers for the elimination (an 8 x 8 tile a thread, 16
// shared loads for 64 FMAs a pivot step, one barrier a step) and leaves K^-1
// there for the ADMM matvecs (64 FMAs and 32 shuffles a thread); a block takes
// about 73 KB of shared memory and 128 registers a thread, two blocks an SM.
#pragma once

namespace rlmpc {

// spd_invert's register tiling: a kGrid x kGrid thread grid, a kTile x kTile
// tile a thread.
constexpr int kTile = 8;
constexpr int kGrid = 16;
constexpr int kPivot = kTile * kGrid;   // padded length of a pivot row / column

constexpr int kThreads = 256;            // threads a block in every QP entry
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
static_assert(kThreads == kGrid * kGrid, "spd_invert's thread grid");

struct QpDims {
  int n;    // variables (h * ad)
  int m;    // constraint rows (5 * nb)
  int nb;   // 5x3 cone blocks (n / 3)
  int h;    // horizon steps
  int sd;   // state dimension of the chain (13)
  int ad;   // variables a step (n / h)
  int ld;   // row stride of K in shared memory (odd, >= n)
};

// Pointers into the block's dynamic shared memory (floats).
struct QpShared {
  float* K;     // n * ld   P, then K, then K^-1
  float* cs;    // nb * 15  scaled cone blocks
  float* q;     // n        masked, scaled gradient
  float* d;     // n        variable scaling
  float* x;     // n
  float* rhs;   // n
  float* xt;    // n        (swing mask until `mask` has run)
  float* colv;  // n        column norms
  float* l;     // m
  float* u;     // m
  float* z;     // m
  float* y;     // m
  float* rho;   // m
  float* e;     // m        row scaling
  float* w;     // m        scratch
  float* part;  // nt       partial results of two-stage reductions
  float* piv;   // 4 kPivot pivot column and row of spd_invert, double buffered
  float* red;   // one slot a warp for the block reductions
  float* chain; // h*sd*ad + sd; aliases l..w, dead once P is built
};

__host__ __device__ inline int qp_ld(int n) { return n | 1; }

__host__ __device__ inline int qp_union_floats(const QpDims& dm) {
  const int vecs = 7 * dm.m;
  const int chain = dm.h * dm.sd * dm.ad + dm.sd;
  return vecs > chain ? vecs : chain;
}

// Slots for the block reductions: one a warp (one a thread in the host build).
__host__ __device__ inline int qp_red_floats(int nt) {
#ifdef RLMPC_HOST_EMULATION
  return nt;
#else
  (void)nt;
  return 32;
#endif
}

__host__ __device__ inline int qp_shared_floats(const QpDims& dm, int nt) {
  return dm.n * dm.ld + dm.nb * 15 + 6 * dm.n + qp_union_floats(dm) + nt +
         4 * kPivot + qp_red_floats(nt);
}

// Bytes of dynamic shared memory a block needs for a QP whose matrix comes
// from device memory (no chain), or -1 when the sizes do not describe a
// cone-block QP the entries take.
__host__ __device__ inline int qp_dense_shared_bytes(int n, int m, int nb) {
  if (nb <= 0 || n != 3 * nb || m != 5 * nb || n > kGrid * kTile) return -1;
  const QpDims dm{n, m, nb, 1, 0, n, qp_ld(n)};
  return (int)sizeof(float) * qp_shared_floats(dm, kThreads);
}

__device__ inline QpShared qp_carve(float* base, const QpDims& dm, int nt) {
  QpShared s;
  float* p = base;
  s.K = p;     p += dm.n * dm.ld;
  s.cs = p;    p += dm.nb * 15;
  s.q = p;     p += dm.n;
  s.d = p;     p += dm.n;
  s.x = p;     p += dm.n;
  s.rhs = p;   p += dm.n;
  s.xt = p;    p += dm.n;
  s.colv = p;  p += dm.n;
  s.chain = p;
  s.l = p;     p += dm.m;
  s.u = p;     p += dm.m;
  s.z = p;     p += dm.m;
  s.y = p;     p += dm.m;
  s.rho = p;   p += dm.m;
  s.e = p;     p += dm.m;
  s.w = p;
  p = s.chain + qp_union_floats(dm);
  s.part = p;  p += nt;
  s.piv = p;   p += 4 * kPivot;
  s.red = p;
  return s;
}

// Thread coordinates. The n x n passes use a column-major split: thread
// (ti0, tj) walks rows ti0, ti0 + tis, ... of column tj, so a warp touches
// consecutive columns of one row.
struct QpThread {
  int tid, nt;
  int tj, ti0, tis;
  bool in2d;
};

__device__ inline QpThread qp_thread(const QpDims& dm) {
  QpThread t;
  t.tid = threadIdx.x;
  t.nt = blockDim.x;
  t.tis = t.nt / dm.n;
  t.ti0 = t.tid / dm.n;
  t.tj = t.tid - t.ti0 * dm.n;
  t.in2d = t.ti0 < t.tis;
  return t;
}

#ifdef RLMPC_HOST_EMULATION
// Host build for checking the arithmetic without a card: reductions go
// through shared memory only.
__device__ inline float block_max(float v, const QpShared& s, const QpThread& t) {
  s.red[t.tid] = v;
  __syncthreads();
  float r = s.red[0];
  for (int i = 1; i < t.nt; ++i) r = fmaxf(r, s.red[i]);
  __syncthreads();
  return r;
}
__device__ inline float block_sum(float v, const QpShared& s, const QpThread& t) {
  s.red[t.tid] = v;
  __syncthreads();
  float r = 0.0f;
  for (int i = 0; i < t.nt; ++i) r += s.red[i];
  __syncthreads();
  return r;
}
#else
// Every thread of the block returns the reduced value.
__device__ inline float block_max(float v, const QpShared& s, const QpThread& t) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if ((t.tid & 31) == 0) s.red[t.tid >> 5] = v;
  __syncthreads();
  const int nw = (t.nt + 31) >> 5;
  float r = s.red[0];
  for (int i = 1; i < nw; ++i) r = fmaxf(r, s.red[i]);
  __syncthreads();
  return r;
}
__device__ inline float block_sum(float v, const QpShared& s, const QpThread& t) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((t.tid & 31) == 0) s.red[t.tid >> 5] = v;
  __syncthreads();
  const int nw = (t.nt + 31) >> 5;
  float r = s.red[0];
  for (int i = 1; i < nw; ++i) r += s.red[i];
  __syncthreads();
  return r;
}
#endif

// K <- one robot's row-major n x n matrix g in device memory, at K's row
// stride. Coalesced reads; the writes walk a row of K. Ends unsynchronised.
__device__ inline void load_matrix(const QpDims& dm, const QpShared& s,
                                   const QpThread& t, const float* g) {
  const int n = dm.n, nn = dm.n * dm.n;
  for (int idx = t.tid; idx < nn; idx += t.nt) {
    const int i = idx / n;
    s.K[i * dm.ld + (idx - i * n)] = g[idx];
  }
}

// (C^T v)[j] for the block-diagonal C of 5x3 blocks.
__device__ inline float ct_apply_at(const float* cs, const float* v, int j) {
  const int k = j / 3, jj = j - 3 * k;
  const float* c = cs + k * 15 + jj;
  const float* vv = v + 5 * k;
  float acc = c[0] * vv[0];
  acc = fmaf(c[3], vv[1], acc);
  acc = fmaf(c[6], vv[2], acc);
  acc = fmaf(c[9], vv[3], acc);
  acc = fmaf(c[12], vv[4], acc);
  return acc;
}

// (C v)[r].
__device__ inline float c_apply_at(const float* cs, const float* v, int r) {
  const int k = r / 5, rr = r - 5 * k;
  const float* c = cs + k * 15 + rr * 3;
  const float* vv = v + 3 * k;
  float acc = c[0] * vv[0];
  acc = fmaf(c[1], vv[1], acc);
  acc = fmaf(c[2], vv[2], acc);
  return acc;
}

// ---- P = 2 B_qp^T Q B_qp + alpha I from s[k] = A^k B -----------------------
// Lower block (a, b), a >= b, d = a - b:  2 sum_{k <= h-1-a} s[k]^T Q s[k+d].
// One thread walks one (d, i, j) line down the block diagonal, so a block is
// the running sum of 13-term products; the mirror is written alongside.
__device__ inline void build_p_from_chain(const QpDims& dm, const QpShared& s,
                                          const QpThread& t, float alpha) {
  const int ad = dm.ad, sd = dm.sd, h = dm.h, ld = dm.ld;
  const float* S = s.chain;
  const float* w = s.chain + h * sd * ad;
  const int lines = h * ad * ad;
  for (int idx = t.tid; idx < lines; idx += t.nt) {
    const int dd = idx / (ad * ad);
    const int rem = idx - dd * ad * ad;
    const int i = rem / ad;
    const int j = rem - i * ad;
    float acc = 0.0f;
    for (int k = 0; k + dd < h; ++k) {
      const float* sa = S + (k * sd) * ad + i;
      const float* sb = S + ((k + dd) * sd) * ad + j;
      float term = 0.0f;
      for (int c = 0; c < sd; ++c)
        term = fmaf(sa[c * ad] * sb[c * ad], w[c], term);
      acc += term;
      const int a = h - 1 - k, b = a - dd;
      float v = 2.0f * acc;
      if (dd == 0 && i == j) v += alpha;
      s.K[(a * ad + i) * ld + b * ad + j] = v;
      if (dd > 0) s.K[(b * ad + j) * ld + a * ad + i] = v;
    }
  }
  __syncthreads();
}

// ---- swing masking: P o mm^T + diag(1 - m), q o m ---------------------------
// The mask sits in s.xt.
__device__ inline void mask(const QpDims& dm, const QpShared& s, const QpThread& t) {
  const int n = dm.n, ld = dm.ld;
  const float* mk = s.xt;
  if (t.in2d) {
    const int j = t.tj;
    const float mj = mk[j];
    for (int i = t.ti0; i < n; i += t.tis) {
      float v = s.K[i * ld + j] * mk[i] * mj;
      if (i == j) v += 1.0f - mj;
      s.K[i * ld + j] = v;
    }
  }
  for (int j = t.tid; j < n; j += t.nt) s.q[j] *= mk[j];
  __syncthreads();
}

// Column inf-norms of K, stage one: partial maxima into s.part.
__device__ inline void col_absmax_partial(const QpDims& dm, const QpShared& s,
                                          const QpThread& t) {
  if (t.in2d) {
    float mx = 0.0f;
    for (int i = t.ti0; i < dm.n; i += t.tis)
      mx = fmaxf(mx, fabsf(s.K[i * dm.ld + t.tj]));
    s.part[t.ti0 * dm.n + t.tj] = mx;
  }
}

__device__ inline float col_absmax_finish(const QpDims& dm, const QpShared& s,
                                          const QpThread& t, int j) {
  float v = s.part[j];
  for (int p = 1; p < t.tis; ++p) v = fmaxf(v, s.part[p * dm.n + j]);
  return v;
}

// ---- modified Ruiz equilibration with cost scaling --------------------------
// Returns the cost scaling c_cost (the same value in every thread).
__device__ inline float ruiz(const QpDims& dm, const QpShared& s, const QpThread& t,
                             int iters) {
  const int n = dm.n, m = dm.m, ld = dm.ld;
  float c_cost = 1.0f;
  for (int it = 0; it < iters; ++it) {
    col_absmax_partial(dm, s, t);
    __syncthreads();
    for (int j = t.tid; j < n; j += t.nt) {
      const int k = j / 3, jj = j - 3 * k;
      const float* c = s.cs + k * 15 + jj;
      float cc = fabsf(c[0]);
      for (int r = 1; r < 5; ++r) cc = fmaxf(cc, fabsf(c[3 * r]));
      const float col = fmaxf(col_absmax_finish(dm, s, t, j), cc);
      s.colv[j] = rsqrtf(fmaxf(col, 1e-8f));
    }
    for (int r = t.tid; r < m; r += t.nt) {
      const float* c = s.cs + r * 3;
      const float rc = fmaxf(fabsf(c[0]), fmaxf(fabsf(c[1]), fabsf(c[2])));
      s.w[r] = rsqrtf(fmaxf(rc, 1e-8f));
    }
    __syncthreads();
    // scale, and take the scaled column norms in the same pass
    if (t.in2d) {
      const int j = t.tj;
      const float dj = s.colv[j];
      float mx = 0.0f;
      for (int i = t.ti0; i < n; i += t.tis) {
        const float v = s.K[i * ld + j] * s.colv[i] * dj;
        s.K[i * ld + j] = v;
        mx = fmaxf(mx, fabsf(v));
      }
      s.part[t.ti0 * n + j] = mx;
    }
    for (int idx = t.tid; idx < dm.nb * 15; idx += t.nt) {
      const int k = idx / 15, rem = idx - 15 * k;
      const int r = rem / 3, jj = rem - 3 * r;
      s.cs[idx] = s.cs[idx] * s.w[5 * k + r] * s.colv[3 * k + jj];
    }
    for (int j = t.tid; j < n; j += t.nt) {
      s.q[j] *= s.colv[j];
      s.d[j] *= s.colv[j];
    }
    for (int r = t.tid; r < m; r += t.nt) s.e[r] *= s.w[r];
    __syncthreads();
    // cost scaling: gamma = 1 / max(mean column norm of P, |q|_inf)
    float csum = 0.0f, qmax = 0.0f;
    for (int j = t.tid; j < n; j += t.nt) {
      csum += col_absmax_finish(dm, s, t, j);
      qmax = fmaxf(qmax, fabsf(s.q[j]));
    }
    csum = block_sum(csum, s, t);
    qmax = block_max(qmax, s, t);
    const float gamma = 1.0f / fmaxf(fmaxf(csum / (float)n, qmax), 1e-8f);
    if (t.in2d)
      for (int i = t.ti0; i < n; i += t.tis) s.K[i * ld + t.tj] *= gamma;
    for (int j = t.tid; j < n; j += t.nt) s.q[j] *= gamma;
    c_cost *= gamma;
    __syncthreads();
  }
  return c_cost;
}

// ---- rho, K = P + sigma I + C^T rho C, scaled bounds and warm start ----------
// On entry l, u, x, z, y hold the unscaled inputs.
__device__ inline void assemble_k(const QpDims& dm, const QpShared& s, const QpThread& t,
                                  float sigma, float rho_base_mult, float rho_eq_scale,
                                  float c_cost) {
  const int n = dm.n, m = dm.m, ld = dm.ld;
  for (int r = t.tid; r < m; r += t.nt) {
    const float lo = s.l[r], hi = s.u[r];
    s.rho[r] = (hi - lo < 1e-9f) ? rho_base_mult * rho_eq_scale : rho_base_mult;
    const float er = s.e[r];
    s.l[r] = er * lo;
    s.u[r] = er * hi;
    s.z[r] = s.z[r] * er;
    s.y[r] = s.y[r] * (c_cost / er);
  }
  for (int j = t.tid; j < n; j += t.nt) s.x[j] = s.x[j] / s.d[j];
  __syncthreads();
  for (int idx = t.tid; idx < dm.nb * 9; idx += t.nt) {
    const int k = idx / 9, rem = idx - 9 * k;
    const int i = rem / 3, j = rem - 3 * i;
    const float* c = s.cs + k * 15;
    float v = 0.0f;
    for (int r = 0; r < 5; ++r)
      v = fmaf(c[3 * r + i] * s.rho[5 * k + r], c[3 * r + j], v);
    if (i == j) v += sigma;
    s.K[(3 * k + i) * ld + 3 * k + j] += v;
  }
  __syncthreads();
}

// ---- inverse of the SPD K: Gauss-Jordan without pivoting, in registers -------
// The block's threads form a kGrid x kGrid grid and thread (ty, tx) owns the
// kTile x kTile elements (ty + kGrid a, tx + kGrid b) of K in registers. A
// pivot step reads the pivot column at its rows and the pivot row at its
// columns from shared memory (16 loads) and does its 64 updates in registers;
// the owners of row and column k+1 post them for the next step in the other
// half of a double buffer, so a step costs one barrier. K^-1 stays in the
// registers for the ADMM steps (kinv_apply); shared memory's copy of K is dead
// from here. Needs blockDim.x == kGrid^2 and n <= kGrid * kTile.
struct KTile {
  float v[kTile][kTile];
};

__device__ inline void spd_invert(const QpDims& dm, const QpShared& s, const QpThread& t,
                                  KTile& kt) {
  const int n = dm.n, ld = dm.ld;
  const int ty = t.tid / kGrid, tx = t.tid - ty * kGrid;
  float* colbuf = s.piv;                // 2 x kPivot, zero beyond n
  float* rowbuf = s.piv + 2 * kPivot;   // 2 x kPivot
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const int i = ty + kGrid * a, j = tx + kGrid * b;
      const float v = (i < n && j < n) ? s.K[i * ld + j] : 0.0f;
      kt.v[a][b] = v;
      if (j == 0) colbuf[i] = v;
      if (i == 0) rowbuf[j] = v;
    }
  }
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    const float* col = colbuf + (k & 1) * kPivot;
    const float* row = rowbuf + (k & 1) * kPivot;
    float* ncol = colbuf + ((k + 1) & 1) * kPivot;
    float* nrow = rowbuf + ((k + 1) & 1) * kPivot;
    const float dpv = __frcp_rn(col[k]);
    float ci[kTile], rj[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) ci[a] = col[ty + kGrid * a];
#pragma unroll
    for (int b = 0; b < kTile; ++b) rj[b] = row[tx + kGrid * b] * dpv;
    // the rank-1 update of every element, then the pivot row and column are
    // overwritten by the few threads that own them
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
#pragma unroll
      for (int b = 0; b < kTile; ++b)
        kt.v[a][b] = fmaf(-ci[a], rj[b], kt.v[a][b]);
    }
    const int ka = k / kGrid, kr = k - ka * kGrid;   // pivot's tile slot, owner
    if (ty == kr) {
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        if (a == ka) {
#pragma unroll
          for (int b = 0; b < kTile; ++b) kt.v[a][b] = rj[b];
        }
      }
    }
    if (tx == kr) {
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        if (b == ka) {
#pragma unroll
          for (int a = 0; a < kTile; ++a)
            kt.v[a][b] = (ty + kGrid * a == k) ? dpv : -ci[a] * dpv;
        }
      }
    }
    // post row and column k+1 for the next step (entries beyond n are 0)
    const int na = (k + 1) / kGrid, nr = (k + 1) - na * kGrid;
    if (ty == nr) {
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        if (a == na) {
#pragma unroll
          for (int b = 0; b < kTile; ++b) nrow[tx + kGrid * b] = kt.v[a][b];
        }
      }
    }
    if (tx == nr) {
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        if (b == na) {
#pragma unroll
          for (int a = 0; a < kTile; ++a) ncol[ty + kGrid * a] = kt.v[a][b];
        }
      }
    }
    __syncthreads();
  }
}

// xt = K^-1 rhs with K^-1 in registers: each thread takes its 8 x 8 tile times
// its 8 entries of rhs, the 16 threads of a row group add up by shuffles
// (tx is the low four bits of the lane). Ends synchronised.
__device__ inline void kinv_apply(const QpDims& dm, const QpShared& s, const QpThread& t,
                                  const KTile& kt) {
  const int n = dm.n;
  const int ty = t.tid / kGrid, tx = t.tid - ty * kGrid;
  float rb[kTile], p[kTile];
#pragma unroll
  for (int b = 0; b < kTile; ++b) {
    const int j = tx + kGrid * b;
    rb[b] = j < n ? s.rhs[j] : 0.0f;
  }
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc = fmaf(kt.v[a][b], rb[b], acc);
    p[a] = acc;
  }
#pragma unroll
  for (int o = kGrid / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) p[a] += __shfl_xor_sync(0xffffffffu, p[a], o);
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int i = ty + kGrid * a;
      if (i < n) s.xt[i] = p[a];
    }
  }
  __syncthreads();
}

// rhs = sigma x - q + C^T w, with w = rho z - y already in s.w; ends synchronised.
__device__ inline void admm_rhs(const QpDims& dm, const QpShared& s, const QpThread& t,
                                float sigma) {
  for (int j = t.tid; j < dm.n; j += t.nt)
    s.rhs[j] = sigma * s.x[j] - s.q[j] + ct_apply_at(s.cs, s.w, j);
  __syncthreads();
}

// ---- fixed-count OSQP ADMM iterations ----------------------------------------
// Leaves w = rho z - y of the final iterate in s.w for residuals_rho.
__device__ inline void admm(const QpDims& dm, const QpShared& s, const QpThread& t,
                            const KTile& kt, int iters, float sigma, float relax) {
  for (int r = t.tid; r < dm.m; r += t.nt) s.w[r] = s.rho[r] * s.z[r] - s.y[r];
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    admm_rhs(dm, s, t, sigma);
    kinv_apply(dm, s, t, kt);
    for (int r = t.tid; r < dm.m; r += t.nt) {
      const float zt = c_apply_at(s.cs, s.xt, r);
      const float zr = relax * zt + (1.0f - relax) * s.z[r];
      const float rho = s.rho[r];
      const float yr = s.y[r];
      const float zn = fminf(fmaxf(zr + (1.0f / rho) * yr, s.l[r]), s.u[r]);
      const float yn = yr + rho * (zr - zn);
      s.y[r] = yn;
      s.z[r] = zn;
      s.w[r] = rho * zn - yn;
    }
    for (int j = t.tid; j < dm.n; j += t.nt)
      s.x[j] = relax * s.xt[j] + (1.0f - relax) * s.x[j];
    __syncthreads();
  }
}

// ---- relative residuals at x~ and the deferred rho rescale --------------------
// Only K^-1 is at hand, so P x~ comes from K x~ = rhs:
//   P x~ = rhs - sigma x~ - C^T rho C x~.
// Expects w = rho z - y in s.w, as admm leaves it.
__device__ inline float residuals_rho(const QpDims& dm, const QpShared& s, const QpThread& t,
                                      const KTile& kt, float sigma, float rho_mult,
                                      bool deferred_rho, float* pri_rel_out,
                                      float* dua_rel_out) {
  const int n = dm.n, m = dm.m;
  admm_rhs(dm, s, t, sigma);
  kinv_apply(dm, s, t, kt);
  float pri = 0.0f, mcx = 0.0f, mz = 0.0f;
  for (int r = t.tid; r < m; r += t.nt) {
    const float cx = c_apply_at(s.cs, s.xt, r);
    s.w[r] = s.rho[r] * cx;
    pri = fmaxf(pri, fabsf(cx - s.z[r]));
    mcx = fmaxf(mcx, fabsf(cx));
    mz = fmaxf(mz, fabsf(s.z[r]));
  }
  __syncthreads();
  float dua = 0.0f, mpx = 0.0f, mcty = 0.0f, mq = 0.0f;
  for (int j = t.tid; j < n; j += t.nt) {
    const float px = s.rhs[j] - sigma * s.xt[j] - ct_apply_at(s.cs, s.w, j);
    const float cty = ct_apply_at(s.cs, s.y, j);
    const float qj = s.q[j];
    dua = fmaxf(dua, fabsf(px + qj + cty));
    mpx = fmaxf(mpx, fabsf(px));
    mcty = fmaxf(mcty, fabsf(cty));
    mq = fmaxf(mq, fabsf(qj));
  }
  pri = block_max(pri, s, t);
  mcx = block_max(mcx, s, t);
  mz = block_max(mz, s, t);
  dua = block_max(dua, s, t);
  mpx = block_max(mpx, s, t);
  mcty = block_max(mcty, s, t);
  mq = block_max(mq, s, t);
  const float pri_rel = pri / fmaxf(fmaxf(mcx, mz), 1e-8f);
  const float dua_rel = dua / fmaxf(fmaxf(mpx, fmaxf(mcty, mq)), 1e-8f);
  *pri_rel_out = pri_rel;
  *dua_rel_out = dua_rel;
  if (!deferred_rho) return rho_mult;
  float scale = sqrtf(pri_rel / fmaxf(dua_rel, 1e-10f));
  scale = fminf(fmaxf(scale, 1e-2f), 1e2f);
  return fminf(fmaxf(rho_mult * scale, 1e-3f), 1e3f);
}

// ---- unscale, z = C x on the raw blocks, primal violation ---------------------
// c0, lb, ub point at this robot's raw inputs in global memory; x_out, z_out,
// y_out at its output rows. Returns the violation in every thread.
__device__ inline float unscale(const QpDims& dm, const QpShared& s, const QpThread& t,
                                float c_cost, const float* c0, const float* lb,
                                const float* ub, float* x_out, float* z_out,
                                float* y_out) {
  for (int j = t.tid; j < dm.n; j += t.nt) {
    const float xu = s.x[j] * s.d[j];
    s.xt[j] = xu;
    x_out[j] = xu;
  }
  __syncthreads();
  float viol = -3.0e38f;
  for (int r = t.tid; r < dm.m; r += t.nt) {
    const float zu = c_apply_at(c0, s.xt, r);
    z_out[r] = zu;
    y_out[r] = s.y[r] * (s.e[r] / c_cost);
    viol = fmaxf(viol, fmaxf(lb[r] - zu, zu - ub[r]));
  }
  viol = block_max(viol, s, t);
  return fmaxf(viol, 0.0f);
}

}  // namespace rlmpc
