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
//   spd_invert          K^-1 into registers (blocked Gauss-Jordan, no pivoting:
//                       K is SPD)
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
// bound by f32 arithmetic and by the latency of the inverse's dependent
// steps, not by device memory. The design keeps all of a solve in one launch
// with K never leaving the SM; gives rows an odd stride so row-wise and
// column-wise walks are both free of bank conflicts; moves K into registers
// for a blocked elimination (an 8 x 8 tile a thread; panels of 8 pivots, three
// barriers a panel, a rank-8 update of 512 FMAs a thread between them fed by
// four 16-byte shared loads a pivot) and leaves K^-1 there for the ADMM
// matvecs (64 FMAs and 32 shuffles a thread); a block takes about 92 KB of
// shared memory and at most 128 registers a thread, two blocks an SM.
#pragma once

namespace rlmpc {

// spd_invert's register tiling: a kGrid x kGrid thread grid, a kTile x kTile
// tile a thread.
constexpr int kTile = 8;
constexpr int kGrid = 16;
constexpr int kPivot = kTile * kGrid;   // padded length of a pivot row / column
// spd_invert's panels: kPanel pivots a panel; its shared scratch holds the
// panel's raw rows, its raw columns (two buffers, by panel parity), the row
// slab T, the column slab V (kPanel x kPivot each), the pivot block's inverse
// and the column, row and reciprocal pivot of each of its elimination steps.
constexpr int kPanel = 8;
constexpr int kSlab = kPanel * kPivot;
constexpr int kInvFloats = 5 * kSlab + 3 * kPanel * kPanel + kPanel;

constexpr int kThreads = 256;            // threads a block in every QP entry
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
static_assert(kThreads == kGrid * kGrid, "spd_invert's thread grid");
static_assert(kTile == kPanel && kGrid == 2 * kPanel,
              "a panel's rows lie in one tile slot of half the thread rows");

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
  float* inv;   // kInvFloats spd_invert's panel slabs (first: 16-byte aligned)
  float* red;   // one slot a warp for the block reductions
  float* keep;  // 2        scalars kept out of the registers across the inverse
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
  return kInvFloats + dm.n * dm.ld + dm.nb * 15 + 6 * dm.n +
         qp_union_floats(dm) + nt + qp_red_floats(nt) + 2;
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
  s.inv = p;   p += kInvFloats;
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
  s.red = p;   p += qp_red_floats(nt);
  s.keep = p;
  return s;
}

// The same value, made opaque to the compiler: what is derived from it
// afterwards is computed anew instead of held in registers from before. The
// entries carve their shared memory again after spd_invert from laundered
// sizes (the base stays the shared array, so the addresses stay 32-bit
// shared-window ones) and derive their output addresses there, so that no
// address of the later phases is kept across the inverse, which needs every
// register.
__device__ __forceinline__ int launder(int v) {
#ifndef RLMPC_HOST_EMULATION
  asm volatile("" : "+r"(v));
#endif
  return v;
}

__device__ __forceinline__ QpDims launder(QpDims dm) {
  dm.n = launder(dm.n);
  dm.m = launder(dm.m);
  dm.nb = launder(dm.nb);
  dm.ld = launder(dm.ld);
  return dm;
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

// ---- inverse of the SPD K: blocked Gauss-Jordan without pivoting, in registers
// The block's threads form a kGrid x kGrid grid and thread (ty, tx) owns the
// kTile x kTile elements (ty + kGrid a, tx + kGrid b) of K in registers, the
// identity beyond n. The pivots go in panels of kPanel; panel p (pivots
// c0 = 8p ... c0 + 7) with A = [[A_pp, A_pr], [A_rp, A_rr]] becomes
//   [[A_pp^-1, T], [-A_rp A_pp^-1, A_rr - A_rp T]],  T = A_pp^-1 A_pr,
// which is the panel's eight scalar pivot steps at once, in three barriers:
//   1. the owners post the panel's raw rows (R) and columns (S);
//   2. one warp inverts the 8 x 8 pivot block by shuffles and keeps each of
//      its eight elimination steps (pivot column, pivot row, 1 / pivot);
//   3. a thread forms a column of the row slab T or a row of the column slab
//      V = -S A_pp^-1 by replaying those steps on a raw row or column: the
//      scalar elimination's own arithmetic, which stays accurate where A_pp
//      is ill-conditioned (a product with A_pp^-1 would not), with A_pp^-1
//      at the panel's own entries;
//   4. a rank-8 update of every thread's tile from S and T (512 FMAs, four
//      16-byte shared loads a pivot, no barrier), then the owners write the
//      panel's rows (from T) and columns (from V).
// Panel p's rows ty + 16a all lie in tile slot a = p / 2 at ty in
// [8 (p & 1), 8 (p & 1) + 8), its columns likewise in slot b = p / 2, so the
// owners' steps dispatch once a panel on the slot (a switch) to code whose
// register indices are static; unrolling the panel loop instead would copy
// the update fifteen times. The slabs are laid out so that a thread's eight entries
// are two float4 (slab_at). K^-1 stays in the registers for the ADMM steps
// (kinv_apply); shared memory's copy of K is dead from here. Needs
// blockDim.x == kGrid^2 and n <= kGrid * kTile.
struct KTile {
  float v[kTile][kTile];
};

// Slab entry (r, c) for c = lo + kGrid * slot: a thread's eight entries of
// one slab row (slots 0-7 at its lo) are two float4, 64 floats apart.
__device__ __forceinline__ int slab_at(int r, int lo, int slot) {
  return r * kPivot + (slot >> 2) * (4 * kGrid) + lo * 4 + (slot & 3);
}

__device__ __forceinline__ void lds8(const float* p, float v[kTile]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4 * kGrid);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Eight consecutive floats (16-byte aligned) as two float4.
__device__ __forceinline__ void lds8p(const float* p, float v[kTile]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void sts8(float* p, const float v[kTile]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4 * kGrid) = make_float4(v[4], v[5], v[6], v[7]);
}

// Step 1 for a panel in tile slot A: row owners post their row into R,
// column owners their column into S.
template <int A>
__device__ __forceinline__ void panel_post(const KTile& kt, float* R, float* S,
                                           int ty, int tx, int half) {
  if ((ty >> 3) == half) {
    float* r = R + (ty & 7) * kPivot + tx;
#pragma unroll
    for (int b = 0; b < kTile; ++b) r[kGrid * b] = kt.v[A][b];
  }
  if ((tx >> 3) == half) {
    float c[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) c[a] = kt.v[a][A];
    sts8(S + (tx & 7) * kPivot + ty * 4, c);
  }
}

// The owners' half of step 4: rows from T, then columns from V (the pivot
// block from V, which holds A_pp^-1 there as T does).
template <int A>
__device__ __forceinline__ void panel_write(KTile& kt, const float* T,
                                            const float* V, int ty, int tx,
                                            int half) {
  float v[kTile];
  if ((ty >> 3) == half) {
    lds8(T + (ty & 7) * kPivot + tx * 4, v);
#pragma unroll
    for (int b = 0; b < kTile; ++b) kt.v[A][b] = v[b];
  }
  if ((tx >> 3) == half) {
    lds8(V + (tx & 7) * kPivot + ty * 4, v);
#pragma unroll
    for (int a = 0; a < kTile; ++a) kt.v[a][A] = v[a];
  }
}

// Step 2: the 8 x 8 pivot block (R's columns c0 ... c0 + 7) inverted by one
// warp, scalar Gauss-Jordan; lane l holds row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1. The eight steps are one dependent chain while the other
// warps wait, so a step is kept short: four shuffles, an approximate
// reciprocal with one Newton step, selects instead of branches. Writes
// A_pp^-1 row-major to pinv, then step k's pivot column and pivot row as
// they were before the step (pinv + 64 + 8k, pinv + 128 + 8k, rotated by k
// for step 3) and its reciprocal pivot (pinv + 192 + k).
__device__ __forceinline__ float rcp_refined(float v) {
#ifdef RLMPC_HOST_EMULATION
  return 1.0f / v;
#else
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return fmaf(r, fmaf(-v, r, 1.0f), r);
#endif
}

__device__ __forceinline__ void pivot_block_inverse(const float* R, int c0,
                                                    float* pinv, int lane) {
  constexpr int kSq = kPanel * kPanel;
  const int r = lane >> 2, c = 2 * (lane & 3);
  float e0 = R[r * kPivot + c0 + c], e1 = R[r * kPivot + c0 + c + 1];
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
    const float mine = (k & 1) ? e1 : e0;                   // (r, k) if c-pair holds k
    const float rk0 = __shfl_sync(0xffffffffu, e0, k * 4 + (lane & 3));  // (k, c)
    const float rk1 = __shfl_sync(0xffffffffu, e1, k * 4 + (lane & 3));  // (k, c+1)
    const float ck = __shfl_sync(0xffffffffu, mine, r * 4 + (k >> 1));   // (r, k)
    const float pv = __shfl_sync(0xffffffffu, mine, k * 4 + (k >> 1));   // (k, k)
    const float d = rcp_refined(pv);
    // stored rotated by k: entry i of step k's vectors is pivot index (i + k) % 8
    if ((lane & 3) == 0) pinv[kSq + k * kPanel + ((r - k) & 7)] = ck;
    if (r == 0) {
      pinv[2 * kSq + k * kPanel + ((c - k) & 7)] = rk0;
      pinv[2 * kSq + k * kPanel + ((c + 1 - k) & 7)] = rk1;
    }
    if (lane == 0) pinv[3 * kSq + k] = d;
    const float f = -ck * d;
    const bool rowk = r == k;
    const float u0 = rowk ? rk0 * d : fmaf(f, rk0, e0);
    const float u1 = rowk ? rk1 * d : fmaf(f, rk1, e1);
    const float pk = rowk ? d : f;                          // column k
    e0 = (c == k) ? pk : u0;
    e1 = (c + 1 == k) ? pk : u1;
  }
  pinv[r * kPanel + c] = e0;
  pinv[r * kPanel + c + 1] = e1;
}

#define RLMPC_PANEL_SLOTS(fn, slot, ...)                       \
  switch (slot) {                                              \
    case 0: fn<0>(__VA_ARGS__); break;                         \
    case 1: fn<1>(__VA_ARGS__); break;                         \
    case 2: fn<2>(__VA_ARGS__); break;                         \
    case 3: fn<3>(__VA_ARGS__); break;                         \
    case 4: fn<4>(__VA_ARGS__); break;                         \
    case 5: fn<5>(__VA_ARGS__); break;                         \
    case 6: fn<6>(__VA_ARGS__); break;                         \
    default: fn<7>(__VA_ARGS__); break;                        \
  }

__device__ inline void spd_invert(const QpDims& dm, const QpShared& s, const QpThread& t,
                                  KTile& kt) {
  const int n = dm.n, ld = dm.ld;
  const int ty = t.tid / kGrid, tx = t.tid - ty * kGrid;
  float* R = s.inv;
  float* T = s.inv + 3 * kSlab;
  float* V = s.inv + 4 * kSlab;
  float* pinv = s.inv + 5 * kSlab;
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const int i = ty + kGrid * a, j = tx + kGrid * b;
      kt.v[a][b] = (i < n && j < n) ? s.K[i * ld + j] : (i == j ? 1.0f : 0.0f);
    }
  }
  // the slab thread of step 3: column sj of T or row sj of V
  const int sj = t.tid & (kPivot - 1);
  const int panels = (n + kPanel - 1) / kPanel;
  for (int p = 0; p < panels; ++p) {
    const int c0 = p * kPanel, half = p & 1;
    float* S = s.inv + (1 + half) * kSlab;   // by parity: step 4 reads it late
    RLMPC_PANEL_SLOTS(panel_post, p >> 1, kt, R, S, ty, tx, half)
    __syncthreads();
    if (t.tid < 32) pivot_block_inverse(R, c0, pinv, t.tid);
    __syncthreads();
    {
      // threads 0-127: column sj of T; threads 128-255: row sj of V. The
      // steps go round a rolled loop, so that no more than the next step's
      // loads are held beside the tile: x[i] holds entry (i + k) % 8 at step
      // k, so that the step's own entry is x[0] and every register index is
      // static; the steps' vectors are stored rotated to match
      const float* pcol = pinv + kPanel * kPanel;
      const float* prow = pinv + 2 * kPanel * kPanel;
      const float* pdinv = pinv + 3 * kPanel * kPanel;
      const int jp = sj - c0, at = slab_at(0, sj & (kGrid - 1), sj / kGrid);
      const bool own = jp >= 0 && jp < kPanel;
      const bool col = t.tid < kPivot;
      float x[kPanel];
#pragma unroll
      for (int l = 0; l < kPanel; ++l)
        x[l] = col ? R[l * kPivot + sj] : S[slab_at(l, sj & (kGrid - 1), sj / kGrid)];
      const float* steps = col ? pcol : prow;
      float w[kPanel];
      lds8p(steps, w);
#pragma unroll 1
      for (int k = 0; k < kPanel; ++k) {
        float wn[kPanel];
        lds8p(steps + ((k + 1) & 7) * kPanel, wn);   // the next step's
        const float f = x[0] * pdinv[k];
#pragma unroll
        for (int i = 1; i < kPanel; ++i) x[i] = fmaf(-f, w[i], x[i]);
#pragma unroll
        for (int i = 0; i + 1 < kPanel; ++i) x[i] = x[i + 1];
        x[kPanel - 1] = col ? f : -f;
#pragma unroll
        for (int i = 0; i < kPanel; ++i) w[i] = wn[i];
      }
      float* slab = col ? T : V;
#pragma unroll
      for (int m = 0; m < kPanel; ++m)
        slab[at + m * kPivot] =
            own ? pinv[col ? m * kPanel + jp : jp * kPanel + m] : x[m];
    }
    __syncthreads();
    // one pivot at a time: the tile and 12 slab values live, no more
#pragma unroll 1
    for (int l = 0; l < kPanel; ++l) {
      float rj[kTile];
      lds8(T + l * kPivot + tx * 4, rj);
#pragma unroll
      for (int h = 0; h < 2; ++h) {       // the tile's rows four at a time
        const float4 c4 = *reinterpret_cast<const float4*>(
            S + l * kPivot + h * 4 * kGrid + ty * 4);
        const float ci[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < kTile; ++b)
            kt.v[4 * h + a][b] = fmaf(-ci[a], rj[b], kt.v[4 * h + a][b]);
        }
      }
    }
    RLMPC_PANEL_SLOTS(panel_write, p >> 1, kt, T, V, ty, tx, half)
  }
}

#undef RLMPC_PANEL_SLOTS

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
