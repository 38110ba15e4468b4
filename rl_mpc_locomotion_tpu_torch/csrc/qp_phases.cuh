// Device-side phases of the GRF-QP solve on one robot. One thread block owns
// one robot. Its matrix lives in a register tile (KTile: 8 x 8 entries a
// thread on a 16 x 16 thread grid) from the moment it is read, through
// masking, equilibration, assembly and inversion, and K^-1 stays there for the
// ADMM steps; the vectors of the solve live in the block's dynamic shared
// memory (a `QpShared` view of it). A kernel entry is a thin sequence of
// phases:
//
//   load_tile           P (or K) from device memory straight into the tile
//   build_p_from_chain  P = 2 B_qp^T Q B_qp + alpha I from the chain A^k B,
//                       into shared memory (row 1 only), then load_tile
//   mask                swing-variable masking of P and q
//   ruiz                modified Ruiz equilibration + cost scaling
//   assemble_k          per-row rho, K = P + sigma I + C^T rho C, bounds and
//                       warm start moved into the scaled problem
//   spd_invert          K^-1 in the tile (blocked Gauss-Jordan, no pivoting:
//                       K is SPD)
//   admm                fixed-count OSQP iterations, K^-1 resident in the tile
//   residuals_rho       relative residuals at x~ and the deferred rho rescale
//   unscale             unscaled x, z, y and the primal violation
//
// Row 1's compact path. The mask is the gait's contact table repeated over a
// foot-step's 3 force variables, so masking turns every variable of a swing
// foot-step (all three mask entries exactly 0) into a unit row and column of
// P; sigma I + C^T rho C is block-diagonal in the same 3 x 3 blocks, and Ruiz
// scaling keeps the zero pattern. With the live foot-steps ordered first, K
// is therefore exactly block-diagonal: a dense block of the n_s stance
// variables (3 x the live foot-steps) and one 3 x 3 block a swing foot-step,
// and K^-1 has the same shape. Where n_s <= 64 (kCompactVars: tile slots
// 0-3; a trot has n_s = 60 at every horizon step) row 1 takes the compact
// path (live_set, compact_order): it gathers P, the vectors and the cone
// blocks through that order (load_tile_compact, the loads of
// solve_from_tile), runs mask, ruiz and assemble_k as they are, moves the
// swing blocks out of the tile (split_swing), inverts the stance block over
// ceil(n_s / 8) panels and tile slots 0-3 only (spd_invert<4>: a quarter of
// the update's FMAs) and each swing block by itself (swing_invert), applies
// K^-1 as a 4 x 4-slot matvec plus a 3 x 3 product a swing row
// (kinv_apply<true>), and writes x, z, y back in the input's order
// (unscale<true>). Otherwise, and in rows 2-4 always, the dense path runs
// unchanged. The choice is per robot and uniform over its block; a device
// counter (g_compact_solves in fused_qp.cu) counts the robot-solves that
// took the compact path.
//
// Replaces the TPU kernel bodies rl_mpc_locomotion_tpu/ops/pallas/fused_qp.py
// (_fused_kernel_chain, _fused_kernel, _solve_phases, _ruiz_in_vmem) together
// with admm_kernel.py (_gj_admm_kernel, gj_invert_symmetric,
// gj_invert_inplace, _admm_math). The entries that use them: fused_qp.cu
// (chain and prebuilt-P solves), scaled_solve.cu (inverse + ADMM on a scaled
// K), phase_probe.cu (the solve cut after a stage, for phase timing). The
// arithmetic and the I/O contract are the same; the layout is not: a robot's
// 120x120 matrix is 57.6 KB, so it is spread over one block's registers.
//
// What bounds it on an H100: global traffic is ~15 KB a robot (plus 57.6 KB
// of P or K where the entry reads it), the work is ~3 MFLOP a robot, a third
// of it the inverse, every operand on the SM. It is bound by f32 arithmetic
// and by the latency of dependent steps and barriers, not by device memory.
// The design keeps all of a solve in one launch with K never leaving the SM
// and never going through shared memory (only row 1 builds its P there):
// each thread reads its 64 entries of P with independent loads (load_tile),
// masks, scales and assembles them where they lie, reducing column norms by
// shuffles and one slot a warp (about three barriers a Ruiz pass); inverts
// by panels of 8 pivots (three barriers a panel, a rank-8 update of 512 FMAs
// a thread between them fed by four 16-byte shared loads a pivot); and runs
// each ADMM step as a matvec (64 FMAs and a reduce-scatter of 8 shuffles a
// thread) and one cone-block phase whose lanes keep their rows' and
// variables' state in registers, two barriers a step. A block takes about
// 32 KB of shared memory (row 1: 89 KB) and at most 128 registers a thread,
// two blocks an SM. On the compact path the inverse keeps its three
// barriers and its serial pivot-block chain a panel but has at most 8
// panels and 128 update FMAs a thread a panel, and an ADMM step's matvec is
// 16 FMAs and 4 shuffles a thread: the barriers and the dependent chains,
// not the arithmetic, bound it more than before.
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
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSharedBytes = 232448;  // 227 KB a block on sm_90
static_assert(kThreads == kGrid * kGrid, "spd_invert's thread grid");
static_assert(kTile == kPanel && kGrid == 2 * kPanel,
              "a panel's rows lie in one tile slot of half the thread rows");
// Scratch of the phases before the inverse, inside spd_invert's slabs, which
// it first writes two barriers after it starts: the Ruiz passes' column
// maxima (one slot a warp and tile column) where T goes, the 3 x 3 blocks of
// sigma I + C^T rho C (9 nb <= 378 floats) where V goes.
constexpr int kRuizPart = 3 * kSlab;
constexpr int kAssembleBlocks = 4 * kSlab;
static_assert(kWarps * kPivot <= kSlab && 9 * (kPivot / 3) <= kSlab,
              "the scratch fits a slab");
// Row 1's compact path: at most kCompactVars stance variables, tile slots
// 0 ... kCompactSlots - 1. Its order of the cone blocks (compact_order) takes
// kOrderInts ints of shared memory: the two ballot words of the live
// foot-steps, then the input's block of each of the solve's kMaxBlocks.
constexpr int kCompactSlots = 4;
constexpr int kCompactVars = kCompactSlots * kGrid;
constexpr int kMaxBlocks = kPivot / 3;
constexpr int kOrderInts = 2 + kMaxBlocks;
static_assert(kMaxBlocks <= 64, "the live foot-steps fit two ballot words");

struct QpDims {
  int n;    // variables (h * ad)
  int m;    // constraint rows (5 * nb)
  int nb;   // 5x3 cone blocks (n / 3)
  int h;    // horizon steps
  int sd;   // state dimension of the chain (13)
  int ad;   // variables a step (n / h)
  int ld;   // row stride of P in shared memory (odd, >= n) for row 1, which
            // builds it there; 0 where the matrix comes from device memory
};

// Pointers into the block's dynamic shared memory (floats).
struct QpShared {
  float* K;     // n * ld   P as row 1 builds it (none where ld = 0); on the
                //          compact path, once P is in the tile, the 3 x 3
                //          swing blocks of K and then of K^-1 (9 nb)
  float* cs;    // nb * 15  scaled cone blocks
  float* q;     // n        masked, scaled gradient
  float* d;     // n        variable scaling
  float* x;     // n
  float* rhs;   // n
  float* xt;    // n        (swing mask until `mask` has run)
  float* colv;  // n        column scaling of a Ruiz pass
  float* l;     // m
  float* u;     // m
  float* z;     // m
  float* y;     // m
  float* rho;   // m
  float* e;     // m        row scaling
  float* w;     // m        scratch
  float* inv;   // kInvFloats spd_invert's panel slabs (first: 16-byte aligned)
  float* red;   // two slots a warp for the block reductions
  float* keep;  // 2        scalars kept out of the registers across the inverse
  float* chain; // h*sd*ad + sd; aliases l..w, dead once P is built
  int* order;   // kOrderInts (row 1 only): the compact path's block order
};

__host__ __device__ inline int qp_ld(int n) { return n | 1; }

// The sizes of an entry whose matrix comes from device memory.
__host__ __device__ inline QpDims qp_dense_dims(int n, int m, int nb) {
  return QpDims{n, m, nb, 1, 0, n, 0};
}

__host__ __device__ inline int qp_union_floats(const QpDims& dm) {
  const int vecs = 7 * dm.m;
  const int chain = dm.h * dm.sd * dm.ad + dm.sd;
  return vecs > chain ? vecs : chain;
}

// Slots for the block reductions: two a warp (two a thread in the host build).
__host__ __device__ inline int qp_red_floats(int nt) {
#ifdef RLMPC_HOST_EMULATION
  return 2 * nt;
#else
  (void)nt;
  return 32;
#endif
}

__host__ __device__ inline int qp_shared_floats(const QpDims& dm, int nt) {
  return kInvFloats + dm.n * dm.ld + dm.nb * 15 + 6 * dm.n +
         qp_union_floats(dm) + qp_red_floats(nt) + 2 +
         (dm.ld > 0 ? kOrderInts : 0);
}

// Bytes of dynamic shared memory a block needs for a QP whose matrix comes
// from device memory (no chain), or -1 when the sizes do not describe a
// cone-block QP the entries take.
__host__ __device__ inline int qp_dense_shared_bytes(int n, int m, int nb) {
  if (nb <= 0 || n != 3 * nb || m != 5 * nb || n > kGrid * kTile) return -1;
  return (int)sizeof(float) * qp_shared_floats(qp_dense_dims(n, m, nb), kThreads);
}

#ifndef RLMPC_HOST_EMULATION
// Blocks of `kernel` (kThreads a block) resident on one SM with `bytes` of
// dynamic shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
// minus a cudaError_t.
template <class Kernel>
inline int qp_blocks_per_sm(Kernel kernel, int bytes) {
  if (bytes < 0 || bytes > kMaxSharedBytes) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, bytes);
  return err == cudaSuccess ? blocks : -(int)err;
}
#endif

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
  s.red = p;   p += qp_red_floats(nt);
  s.keep = p;  p += 2;
  s.order = reinterpret_cast<int*>(p);
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

// Thread coordinates: tid = kGrid ty + tx on the tile's thread grid, so a
// warp holds two row groups (ty = 2w, 2w + 1) of 16 lanes. Through mask, Ruiz
// and assembly thread j < n owns entry j of the n-vectors (q, d, x) and
// thread r < m entry r of the m-vectors (n <= 128, m <= 210 < kThreads), so
// their updates need no barrier of their own.
struct QpThread {
  int tid, nt;
  int ty, tx;
};

__device__ inline QpThread qp_thread() {
  QpThread t;
  t.tid = threadIdx.x;
  t.nt = blockDim.x;
  t.ty = t.tid / kGrid;
  t.tx = t.tid - t.ty * kGrid;
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
__device__ inline void block_sum_max(float& sum, float& mx, const QpShared& s,
                                     const QpThread& t) {
  s.red[t.tid] = sum;
  s.red[t.nt + t.tid] = mx;
  __syncthreads();
  sum = 0.0f;
  mx = s.red[t.nt];
  for (int i = 0; i < t.nt; ++i) {
    sum += s.red[i];
    mx = fmaxf(mx, s.red[t.nt + i]);
  }
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
// A sum and a maximum in one barrier, and none after it: the caller writes
// s.red again only after another barrier.
__device__ inline void block_sum_max(float& sum, float& mx, const QpShared& s,
                                     const QpThread& t) {
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if ((t.tid & 31) == 0) {
    s.red[t.tid >> 5] = sum;
    s.red[16 + (t.tid >> 5)] = mx;
  }
  __syncthreads();
  const int nw = (t.nt + 31) >> 5;
  sum = s.red[0];
  mx = s.red[16];
  for (int i = 1; i < nw; ++i) {
    sum += s.red[i];
    mx = fmaxf(mx, s.red[16 + i]);
  }
}
#endif

// ---- the register tile --------------------------------------------------------
// Thread (ty, tx) owns the kTile x kTile entries (ty + kGrid a, tx + kGrid b)
// of the matrix, the identity beyond n. Needs blockDim.x == kGrid^2 and
// n <= kGrid * kTile.
struct KTile {
  float v[kTile][kTile];
};

// The tile <- one robot's n x n matrix g at row stride ld: from device
// memory (ld = n) with 64 independent loads a thread, for each (a, b) a
// warp reading two runs of 16 consecutive floats, whole 32-byte sectors
// where rows start on one (n a multiple of 8, as n = 120); or P as row 1
// builds it in shared memory (ld = dm.ld).
__device__ inline void load_tile(const QpDims& dm, const QpThread& t,
                                 const float* g, int ld, KTile& kt) {
  const int n = dm.n;
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    const int i = t.ty + kGrid * a;
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const int j = t.tx + kGrid * b;
      kt.v[a][b] = (i < n && j < n) ? g[i * ld + j] : (i == j ? 1.0f : 0.0f);
    }
  }
}

// ---- row 1's compact path: the live set and the order of the blocks --------
// Foot-step k is live if any of mask[3k .. 3k + 2] is not exactly 0. Warps 0
// and 1 ballot the nb <= 42 flags from the robot's mask row (device memory)
// into order[0], order[1]; ends unsynchronised.
__device__ inline void live_set(const QpDims& dm, const QpShared& s, const QpThread& t,
                                const float* mask) {
  if (t.tid < 64) {
    const int k = t.tid;
    const bool live = k < dm.nb && (mask[3 * k] != 0.0f || mask[3 * k + 1] != 0.0f ||
                                    mask[3 * k + 2] != 0.0f);
    const unsigned bits = __ballot_sync(0xffffffffu, live);
    if ((t.tid & 31) == 0) s.order[t.tid >> 5] = (int)bits;
  }
}

// n_s, the stance variables, from the ballot words (after a barrier).
__device__ __forceinline__ int stance_vars(const QpShared& s) {
  return 3 * (__popc((unsigned)s.order[0]) + __popc((unsigned)s.order[1]));
}

// The compact order, live foot-steps first, each group in the input's order:
// order[2 + k] is the input's block at the solve's block k. Ends
// unsynchronised.
__device__ inline void compact_order(const QpDims& dm, const QpShared& s,
                                     const QpThread& t) {
  const int k = t.tid;
  if (k < dm.nb) {
    const unsigned w0 = (unsigned)s.order[0], w1 = (unsigned)s.order[1];
    const unsigned lo = k < 32 ? w0 & ((1u << k) - 1u) : w0;
    const unsigned hi = k < 32 ? 0u : w1 & ((1u << (k - 32)) - 1u);
    const int below = __popc(lo) + __popc(hi);   // live blocks before k
    const bool live = ((k < 32 ? w0 >> k : w1 >> (k - 32)) & 1u) != 0;
    const int slot = live ? below : __popc(w0) + __popc(w1) + k - below;
    s.order[2 + slot] = k;
  }
}

// The input's index of the compact solve's variable j or row r.
__device__ __forceinline__ int src_var(const QpShared& s, int j) {
  const int k = j / 3;
  return 3 * s.order[2 + k] + (j - 3 * k);
}
__device__ __forceinline__ int src_row(const QpShared& s, int r) {
  const int k = r / 5;
  return 5 * s.order[2 + k] + (r - 5 * k);
}

// load_tile for the compact path, from P in shared memory: the stance block
// gathered through the order into tile slots 0-3, the identity elsewhere
// (mask makes the swing rows and columns what the dense path's are from
// any finite entries there).
__device__ inline void load_tile_compact(const QpDims& dm, const QpShared& s,
                                         const QpThread& t, int ns, KTile& kt) {
  int rows[kCompactSlots], cols[kCompactSlots];
#pragma unroll
  for (int a = 0; a < kCompactSlots; ++a) {
    const int i = t.ty + kGrid * a, j = t.tx + kGrid * a;
    rows[a] = i < ns ? src_var(s, i) * dm.ld : -1;
    cols[a] = j < ns ? src_var(s, j) : -1;
  }
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      if (a < kCompactSlots && b < kCompactSlots && rows[a] >= 0 && cols[b] >= 0)
        kt.v[a][b] = s.K[rows[a] + cols[b]];
      else   // row ty + kGrid a is column tx + kGrid b
        kt.v[a][b] = (a == b && t.ty == t.tx) ? 1.0f : 0.0f;
    }
  }
}

// Per tile slot, the entries of v at the thread's rows (ty + kGrid a) and
// columns (tx + kGrid b); `pad` beyond n.
__device__ __forceinline__ void tile_rows(const float* v, int n, const QpThread& t,
                                          float pad, float r[kTile]) {
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    const int i = t.ty + kGrid * a;
    r[a] = i < n ? v[i] : pad;
  }
}
__device__ __forceinline__ void tile_cols(const float* v, int n, const QpThread& t,
                                          float pad, float c[kTile]) {
#pragma unroll
  for (int b = 0; b < kTile; ++b) {
    const int j = t.tx + kGrid * b;
    c[b] = j < n ? v[j] : pad;
  }
}

// out = v + row 0 of the tile, from the registers of the threads with ty == 0.
__device__ inline void write_row0(const QpDims& dm, const QpThread& t,
                                  const KTile& kt, const float* v, float* out) {
  if (t.ty == 0) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const int j = t.tx + kGrid * b;
      if (j < dm.n) out[j] = v[j] + kt.v[0][b];
    }
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

// ---- swing masking: P o mm^T + diag(1 - m), q o m, on the tile ---------------
// The mask sits in s.xt, published by a barrier; q's entries are their
// owners'. Ends unsynchronised.
__device__ inline void mask(const QpDims& dm, const QpShared& s, const QpThread& t,
                            KTile& kt) {
  const int n = dm.n;
  float mr[kTile], mc[kTile];
  tile_rows(s.xt, n, t, 1.0f, mr);
  tile_cols(s.xt, n, t, 1.0f, mc);
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) kt.v[a][b] = kt.v[a][b] * mr[a] * mc[b];
  }
  if (t.ty == t.tx) {   // the diagonal: entries (ty + kGrid a, tx + kGrid a)
#pragma unroll
    for (int a = 0; a < kTile; ++a) kt.v[a][a] += 1.0f - mc[a];
  }
  if (t.tid < n) s.q[t.tid] *= s.xt[t.tid];
}

// Column maxima of |tile|: over the thread's 8 rows, the warp's two row
// groups by a shuffle, then into one slot a warp, part[warp * kPivot + j].
__device__ __forceinline__ void tile_col_absmax(const KTile& kt, float* part,
                                                const QpThread& t) {
  float mx[kTile];
#pragma unroll
  for (int b = 0; b < kTile; ++b) {
    mx[b] = fabsf(kt.v[0][b]);
#pragma unroll
    for (int a = 1; a < kTile; ++a) mx[b] = fmaxf(mx[b], fabsf(kt.v[a][b]));
  }
#pragma unroll
  for (int b = 0; b < kTile; ++b)
    mx[b] = fmaxf(mx[b], __shfl_xor_sync(0xffffffffu, mx[b], 16));
  if ((t.tid & 31) < kGrid) {
#pragma unroll
    for (int b = 0; b < kTile; ++b)
      part[(t.tid >> 5) * kPivot + t.tx + kGrid * b] = mx[b];
  }
}

// Column j's maximum from the warps' slots.
__device__ __forceinline__ float col_absmax(const float* part, int j) {
  float v = part[j];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = fmaxf(v, part[w * kPivot + j]);
  return v;
}

// ---- modified Ruiz equilibration with cost scaling, on the tile --------------
// A pass: column scaling d = 1 / sqrt(max(|K col|, |C col|)) and row scaling
// of C (barrier), K <- D K D with the new column maxima taken in the same
// walk over the registers, C, q, d, e scaled (barrier), then the cost
// scaling gamma = 1 / max(mean column norm, |q|_inf) from one two-value block
// reduction (barrier). The next pass's column maxima are these times gamma,
// exactly (rounding is monotone), so each pass walks the tile once and the
// first one more time. Returns the cost scaling c_cost (the same value in
// every thread); ends unsynchronised.
__device__ inline float ruiz(const QpDims& dm, const QpShared& s, const QpThread& t,
                             KTile& kt, int iters) {
  const int n = dm.n, m = dm.m;
  float* part = s.inv + kRuizPart;
  float c_cost = 1.0f;
  if (iters <= 0) return c_cost;
  tile_col_absmax(kt, part, t);
  __syncthreads();
  float col = t.tid < n ? col_absmax(part, t.tid) : 0.0f;   // this pass's |K col|
  for (int it = 0; it < iters; ++it) {
    if (t.tid < n) {
      const int k = t.tid / 3, jj = t.tid - 3 * k;
      const float* c = s.cs + k * 15 + jj;
      float cc = fabsf(c[0]);
      for (int r = 1; r < 5; ++r) cc = fmaxf(cc, fabsf(c[3 * r]));
      s.colv[t.tid] = rsqrtf(fmaxf(fmaxf(col, cc), 1e-8f));
    }
    if (t.tid < m) {
      const float* c = s.cs + t.tid * 3;
      const float rc = fmaxf(fabsf(c[0]), fmaxf(fabsf(c[1]), fabsf(c[2])));
      s.w[t.tid] = rsqrtf(fmaxf(rc, 1e-8f));
    }
    __syncthreads();
    // scale, and take the scaled column maxima in the same pass
    {
      float dr[kTile], dc[kTile];
      tile_rows(s.colv, n, t, 1.0f, dr);
      tile_cols(s.colv, n, t, 1.0f, dc);
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
#pragma unroll
        for (int b = 0; b < kTile; ++b) kt.v[a][b] = kt.v[a][b] * dr[a] * dc[b];
      }
    }
    tile_col_absmax(kt, part, t);
    for (int idx = t.tid; idx < dm.nb * 15; idx += t.nt) {
      const int k = idx / 15, rem = idx - 15 * k;
      const int r = rem / 3, jj = rem - 3 * r;
      s.cs[idx] = s.cs[idx] * s.w[5 * k + r] * s.colv[3 * k + jj];
    }
    float csum = 0.0f, qmax = 0.0f;
    if (t.tid < n) {
      const float dj = s.colv[t.tid];
      s.q[t.tid] *= dj;
      s.d[t.tid] *= dj;
      qmax = fabsf(s.q[t.tid]);
    }
    if (t.tid < m) s.e[t.tid] *= s.w[t.tid];
    __syncthreads();
    // cost scaling: gamma = 1 / max(mean column norm of P, |q|_inf)
    if (t.tid < n) {
      col = col_absmax(part, t.tid);
      csum = col;
    }
    block_sum_max(csum, qmax, s, t);
    const float gamma = 1.0f / fmaxf(fmaxf(csum / (float)n, qmax), 1e-8f);
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const float g = t.ty + kGrid * a < n ? gamma : 1.0f;   // padding stays I
#pragma unroll
      for (int b = 0; b < kTile; ++b) kt.v[a][b] *= g;
    }
    if (t.tid < n) {
      s.q[t.tid] *= gamma;
      col *= gamma;
    }
    c_cost *= gamma;
  }
  return c_cost;
}

// ---- rho, K = P + sigma I + C^T rho C, scaled bounds and warm start ----------
// On entry l, u, x, z, y hold the unscaled inputs. The nb 3 x 3 blocks of
// sigma I + C^T rho C go through shared memory (barrier); the owners of the
// block diagonal's entries add them: (i, j) with i / 3 == j / 3 lies in tile
// slots b = a - 1, a, a + 1 (|i - j| <= 2). Ends unsynchronised.
__device__ inline void assemble_k(const QpDims& dm, const QpShared& s, const QpThread& t,
                                  KTile& kt, float sigma, float rho_base_mult,
                                  float rho_eq_scale, float c_cost) {
  const int n = dm.n, m = dm.m;
  if (t.tid < m) {
    const int r = t.tid;
    const float lo = s.l[r], hi = s.u[r];
    s.rho[r] = (hi - lo < 1e-9f) ? rho_base_mult * rho_eq_scale : rho_base_mult;
    const float er = s.e[r];
    s.l[r] = er * lo;
    s.u[r] = er * hi;
    s.z[r] = s.z[r] * er;
    s.y[r] = s.y[r] * (c_cost / er);
  }
  if (t.tid < n) s.x[t.tid] = s.x[t.tid] / s.d[t.tid];
  __syncthreads();
  float* blk = s.inv + kAssembleBlocks;
  for (int idx = t.tid; idx < dm.nb * 9; idx += t.nt) {
    const int k = idx / 9, rem = idx - 9 * k;
    const int i = rem / 3, j = rem - 3 * i;
    const float* c = s.cs + k * 15;
    float v = 0.0f;
    for (int r = 0; r < 5; ++r)
      v = fmaf(c[3 * r + i] * s.rho[5 * k + r], c[3 * r + j], v);
    if (i == j) v += sigma;
    blk[idx] = v;
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    const int i = t.ty + kGrid * a, ki = i / 3;
#pragma unroll
    for (int b = a - 1; b <= a + 1; ++b) {
      if (b < 0 || b >= kTile) continue;
      const int j = t.tx + kGrid * b;
      if (i < n && j / 3 == ki)
        kt.v[a][b] += blk[9 * ki + 3 * (i - 3 * ki) + (j - 3 * ki)];
    }
  }
}

// ---- the compact path: the swing blocks out of the tile ---------------------
// After assemble_k, on the compact path: the owners of each swing block's
// entries (i / 3 == j / 3, i >= ns; slots b = a - 1 ... a + 1 as in
// assemble_k) copy them to s.K (9 floats a block, at the solve's block), and
// tile slots 0-3 become the identity outside the stance block, so that the
// compact inverse's last panel pivots on unit rows there. Ends
// unsynchronised.
__device__ inline void split_swing(const QpDims& dm, const QpShared& s,
                                   const QpThread& t, KTile& kt, int ns) {
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    const int i = t.ty + kGrid * a, ki = i / 3;
#pragma unroll
    for (int b = a - 1; b <= a + 1; ++b) {
      if (b < 0 || b >= kTile) continue;
      const int j = t.tx + kGrid * b;
      if (i >= ns && i < dm.n && j / 3 == ki)
        s.K[9 * ki + 3 * (i - 3 * ki) + (j - 3 * ki)] = kt.v[a][b];
    }
  }
#pragma unroll
  for (int a = 0; a < kCompactSlots; ++a) {
    const int i = t.ty + kGrid * a;
#pragma unroll
    for (int b = 0; b < kCompactSlots; ++b) {
      const int j = t.tx + kGrid * b;
      if (i >= ns || j >= ns) kt.v[a][b] = (a == b && t.ty == t.tx) ? 1.0f : 0.0f;
    }
  }
}

// ---- inverse of the SPD K: blocked Gauss-Jordan without pivoting, in the tile
// K in the register tile (KTile), the identity beyond n. The pivots go in panels of kPanel; panel p (pivots
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
// are two float4 (slab_at). K^-1 stays in the tile for the ADMM steps
// (kinv_apply).

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

// The first S tile slots' entries of a slab row: lds8 / sts8 for S = kTile,
// their first float4 for S = kCompactSlots.
template <int S>
__device__ __forceinline__ void lds_slots(const float* p, float v[kTile]) {
  if constexpr (S == kTile) {
    lds8(p, v);
  } else {
    static_assert(S == 4, "a float4 of slots");
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
}
template <int S>
__device__ __forceinline__ void sts_slots(float* p, const float v[kTile]) {
  if constexpr (S == kTile) {
    sts8(p, v);
  } else {
    static_assert(S == 4, "a float4 of slots");
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Step 1 for a panel in tile slot A: row owners post their row into R,
// column owners their column into S; both over the inverse's first kS tile
// slots (none for A >= kS).
template <int A, int kS>
__device__ __forceinline__ void panel_post(const KTile& kt, float* R, float* S,
                                           int ty, int tx, int half) {
  if constexpr (A < kS) {
    if ((ty >> 3) == half) {
      float* r = R + (ty & 7) * kPivot + tx;
#pragma unroll
      for (int b = 0; b < kS; ++b) r[kGrid * b] = kt.v[A][b];
    }
    if ((tx >> 3) == half) {
      float c[kTile];
#pragma unroll
      for (int a = 0; a < kS; ++a) c[a] = kt.v[a][A];
      sts_slots<kS>(S + (tx & 7) * kPivot + ty * 4, c);
    }
  }
}

// The owners' half of step 4: rows from T, then columns from V (the pivot
// block from V, which holds A_pp^-1 there as T does).
template <int A, int kS>
__device__ __forceinline__ void panel_write(KTile& kt, const float* T,
                                            const float* V, int ty, int tx,
                                            int half) {
  if constexpr (A < kS) {
    float v[kTile];
    if ((ty >> 3) == half) {
      lds_slots<kS>(T + (ty & 7) * kPivot + tx * 4, v);
#pragma unroll
      for (int b = 0; b < kS; ++b) kt.v[A][b] = v[b];
    }
    if ((tx >> 3) == half) {
      lds_slots<kS>(V + (tx & 7) * kPivot + ty * 4, v);
#pragma unroll
      for (int a = 0; a < kS; ++a) kt.v[a][A] = v[a];
    }
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

// Each swing block's 3 x 3 inverse in place, one thread a block: scalar
// Gauss-Jordan without pivoting (the block is SPD), each step the pivot
// block's arithmetic of spd_invert (pivot_block_inverse). Starts with a
// barrier, which publishes what split_swing wrote (spd_invert has none where
// n_s = 0); ends unsynchronised.
__device__ inline void swing_invert(const QpDims& dm, const QpShared& s,
                                    const QpThread& t, int ns) {
  __syncthreads();
  const int k = ns / 3 + t.tid;
  if (k >= dm.nb) return;
  float* g = s.K + 9 * k;
  float e[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) e[i][j] = g[3 * i + j];
  }
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float d = rcp_refined(e[p][p]);
    float rk[3], ck[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rk[j] = e[p][j];
      ck[j] = e[j][p];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float f = -ck[i] * d;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float u = i == p ? rk[j] * d : fmaf(f, rk[j], e[i][j]);
        e[i][j] = j == p ? (i == p ? d : f) : u;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) g[3 * i + j] = e[i][j];
  }
}

#define RLMPC_PANEL_SLOTS(fn, kS, slot, ...)                   \
  switch (slot) {                                              \
    case 0: fn<0, kS>(__VA_ARGS__); break;                     \
    case 1: fn<1, kS>(__VA_ARGS__); break;                     \
    case 2: fn<2, kS>(__VA_ARGS__); break;                     \
    case 3: fn<3, kS>(__VA_ARGS__); break;                     \
    case 4: fn<4, kS>(__VA_ARGS__); break;                     \
    case 5: fn<5, kS>(__VA_ARGS__); break;                     \
    case 6: fn<6, kS>(__VA_ARGS__); break;                     \
    default: fn<7, kS>(__VA_ARGS__); break;                    \
  }

// K^-1 over pivots 0 ... n - 1 and the first kS tile slots: the whole K on
// the dense path (kS = kTile), the stance block on the compact path
// (n = n_s <= kCompactVars, kS = kCompactSlots, the tile the identity beyond
// n_s there).
template <int kS = kTile>
__device__ inline void spd_invert(const QpShared& s, const QpThread& t, KTile& kt,
                                  int n) {
  static_assert(kS == kTile || kS == kCompactSlots, "the dense or the compact inverse");
  const int ty = t.ty, tx = t.tx;
  float* R = s.inv;
  float* T = s.inv + 3 * kSlab;
  float* V = s.inv + 4 * kSlab;
  float* pinv = s.inv + 5 * kSlab;
  // the slab thread of step 3: column sj of T or row sj of V
  const int sj = t.tid & (kPivot - 1);
  const int panels = (n + kPanel - 1) / kPanel;
  for (int p = 0; p < panels; ++p) {
    const int c0 = p * kPanel, half = p & 1;
    float* S = s.inv + (1 + half) * kSlab;   // by parity: step 4 reads it late
    RLMPC_PANEL_SLOTS(panel_post, kS, p >> 1, kt, R, S, ty, tx, half)
    __syncthreads();
    if (t.tid < 32) pivot_block_inverse(R, c0, pinv, t.tid);
    __syncthreads();
    if (kS == kTile || sj < kS * kGrid) {
      // threads 0-127: column sj of T; threads 128-255: row sj of V (on the
      // compact path sj < 64 only). The
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
      lds_slots<kS>(T + l * kPivot + tx * 4, rj);
#pragma unroll
      for (int h = 0; h < kS / 4; ++h) {  // the tile's rows four at a time
        const float4 c4 = *reinterpret_cast<const float4*>(
            S + l * kPivot + h * 4 * kGrid + ty * 4);
        const float ci[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < kS; ++b)
            kt.v[4 * h + a][b] = fmaf(-ci[a], rj[b], kt.v[4 * h + a][b]);
        }
      }
    }
    RLMPC_PANEL_SLOTS(panel_write, kS, p >> 1, kt, T, V, ty, tx, half)
  }
}

#undef RLMPC_PANEL_SLOTS

// xt = K^-1 rhs with K^-1 in the tile: each thread takes its 8 x 8 tile times
// its 8 entries of rhs, then the 16 lanes of a row group (tx, the low four
// bits of the lane) reduce-scatter their 8 partial row sums: at each of
// three shuffle rounds (4, 2, 1 values) a lane keeps half of its rows and
// adds its partner's partial sums of them, so that lanes 2c and 2c + 1 hold
// row ty + kGrid c over eight lanes each, and one more shuffle joins the
// pair. The even lanes write. Ends synchronised.
//
// On the compact path (kCompact, ns = n_s) the stance rows are the 4 x 4
// slots' matvec (16 FMAs), reduce-scattered in two rounds (2, 1 values) and
// summed over the last four lanes, lane 4c writing row ty + kGrid c; swing
// row i (ns <= i < n) is thread i's product of its row of the block's 3 x 3
// inverse (in s.K) with the block's 3 entries of rhs.
template <bool kCompact = false>
__device__ inline void kinv_apply(const QpDims& dm, const QpShared& s, const QpThread& t,
                                  const KTile& kt, int ns = 0) {
  if constexpr (kCompact) {
    const int tx = t.tx;
    float rb[kCompactSlots], p[kCompactSlots];
#pragma unroll
    for (int b = 0; b < kCompactSlots; ++b) {
      const int j = tx + kGrid * b;
      rb[b] = j < ns ? s.rhs[j] : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kCompactSlots; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int b = 0; b < kCompactSlots; ++b) acc = fmaf(kt.v[a][b], rb[b], acc);
      p[a] = acc;
    }
    const bool h8 = (tx & 8) != 0, h4 = (tx & 4) != 0;
    float p2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)   // rows 2 h8 + i
      p2[i] = (h8 ? p[2 + i] : p[i]) +
              __shfl_xor_sync(0xffffffffu, h8 ? p[i] : p[2 + i], 8);
    float p1 = (h4 ? p2[1] : p2[0]) +   // row tx / 4
               __shfl_xor_sync(0xffffffffu, h4 ? p2[0] : p2[1], 4);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
    p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
    const int i = t.ty + kGrid * (tx >> 2);
    if ((tx & 3) == 0 && i < ns) s.xt[i] = p1;
    const int r = t.tid;
    if (r >= ns && r < dm.n) {
      const int k = r / 3;
      const float* g = s.K + 9 * k + 3 * (r - 3 * k);
      const float* v = s.rhs + 3 * k;
      s.xt[r] = fmaf(g[2], v[2], fmaf(g[1], v[1], g[0] * v[0]));
    }
    __syncthreads();
    return;
  }
  const int n = dm.n, tx = t.tx;
  float rb[kTile], p[kTile];
  tile_cols(s.rhs, n, t, 0.0f, rb);
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc = fmaf(kt.v[a][b], rb[b], acc);
    p[a] = acc;
  }
  const bool h8 = (tx & 8) != 0, h4 = (tx & 4) != 0, h2 = (tx & 2) != 0;
  float p4[4], p2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)   // rows 4 h8 + i
    p4[i] = (h8 ? p[4 + i] : p[i]) +
            __shfl_xor_sync(0xffffffffu, h8 ? p[i] : p[4 + i], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)   // rows 4 h8 + 2 h4 + i
    p2[i] = (h4 ? p4[2 + i] : p4[i]) +
            __shfl_xor_sync(0xffffffffu, h4 ? p4[i] : p4[2 + i], 4);
  float p1 = (h2 ? p2[1] : p2[0]) +   // row tx / 2
             __shfl_xor_sync(0xffffffffu, h2 ? p2[0] : p2[1], 2);
  p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
  const int i = t.ty + kGrid * (tx >> 1);
  if ((tx & 1) == 0 && i < n) s.xt[i] = p1;
  __syncthreads();
}

// ---- fixed-count OSQP ADMM iterations ----------------------------------------
// C is block-diagonal in 5 x 3 cone blocks, so the projection of cone block
// k's 5 rows (z, y, w), the relaxation of its 3 variables (x) and their next
// rhs = sigma x - q + C^T w need only x~ of block k and the block's own
// state. A step is the matvec with its reduction (kinv_apply, one barrier)
// and one cone-block phase that writes the next rhs (one barrier). In that
// phase lane 5 c + rr (c < 6) of warp w takes row rr of cone block
// k = 6 w + c, and the lanes with rr < 3 also variable 3 k + rr, which
// gather the block's 5 values of w from its lanes by shuffles. A lane keeps
// what it owns in registers over the steps (ConeState), so a step reads
// only x~ of its block from shared memory and writes only the rhs.
struct ConeLane {
  int k, rr;   // cone block, row in it
  int lane0;   // the lane of the block's row 0
  bool row;    // the lane has row 5 k + rr
  bool var;    // ... and variable 3 k + rr
};
static_assert(6 * kWarps * 3 >= kPivot, "every variable of n <= kPivot has a lane");

__device__ inline ConeLane cone_lane(const QpDims& dm, const QpThread& t) {
  const int lane = t.tid & 31, c = lane / 5;
  ConeLane cl;
  cl.k = 6 * (t.tid >> 5) + c;
  cl.rr = lane - 5 * c;
  cl.lane0 = 5 * c;
  cl.row = c < 6 && cl.k < dm.nb;
  cl.var = cl.row && cl.rr < 3;
  return cl;
}

// A lane's part of the cone-block phase, kept in its registers across the
// steps: its row's state, bounds, penalty and row of C, and its variable's
// x, q and column of C.
struct ConeState {
  float z, y, w, lo, hi, rho, rinv, cr[3];
  float x, q, cc[5];
};

// rhs of variable 3 k + rr = sigma x - q + (C^T w) from its block's 5 values
// of w (0 on a lane without a row). Every lane of the warp takes part in the
// shuffles.
__device__ __forceinline__ void cone_rhs(const QpShared& s, const ConeLane& cl,
                                         const ConeState& st, float sigma) {
  float wr[5];
#pragma unroll
  for (int r = 0; r < 5; ++r)
    wr[r] = __shfl_sync(0xffffffffu, st.w, (cl.lane0 + r) & 31);
  if (cl.var) {
    float acc = st.cc[0] * wr[0];
#pragma unroll
    for (int r = 1; r < 5; ++r) acc = fmaf(st.cc[r], wr[r], acc);
    s.rhs[3 * cl.k + cl.rr] = sigma * st.x - st.q + acc;
  }
}

// Takes x, z, y from shared memory and puts them back after the last step,
// with w = rho z - y of the final iterate in s.w and the next step's rhs in
// s.rhs, for residuals_rho; ends synchronised. 1 / rho is taken once, the
// same value as the plain version's at every step.
template <bool kCompact = false>
__device__ inline void admm(const QpDims& dm, const QpShared& s, const QpThread& t,
                            const KTile& kt, int iters, float sigma, float relax,
                            int ns = 0) {
  const ConeLane cl = cone_lane(dm, t);
  const int r = 5 * cl.k + cl.rr, j = 3 * cl.k + cl.rr;
  ConeState st = {};
  if (cl.row) {
    st.z = s.z[r];
    st.y = s.y[r];
    st.lo = s.l[r];
    st.hi = s.u[r];
    st.rho = s.rho[r];
    st.rinv = 1.0f / st.rho;
#pragma unroll
    for (int i = 0; i < 3; ++i) st.cr[i] = s.cs[15 * cl.k + 3 * cl.rr + i];
    st.w = st.rho * st.z - st.y;
  }
  if (cl.var) {
    st.x = s.x[j];
    st.q = s.q[j];
#pragma unroll
    for (int i = 0; i < 5; ++i) st.cc[i] = s.cs[15 * cl.k + 3 * i + cl.rr];
  }
  cone_rhs(s, cl, st, sigma);
  __syncthreads();
  const float* xk = s.xt + 3 * cl.k;
  for (int it = 0; it < iters; ++it) {
    kinv_apply<kCompact>(dm, s, t, kt, ns);
    if (cl.row) {
      float zt = st.cr[0] * xk[0];
      zt = fmaf(st.cr[1], xk[1], zt);
      zt = fmaf(st.cr[2], xk[2], zt);
      const float zr = relax * zt + (1.0f - relax) * st.z;
      const float zn = fminf(fmaxf(zr + st.rinv * st.y, st.lo), st.hi);
      st.y = st.y + st.rho * (zr - zn);
      st.z = zn;
      st.w = st.rho * zn - st.y;
    }
    if (cl.var) st.x = relax * xk[cl.rr] + (1.0f - relax) * st.x;
    cone_rhs(s, cl, st, sigma);
    __syncthreads();
  }
  if (cl.row) {
    s.z[r] = st.z;
    s.y[r] = st.y;
    s.w[r] = st.w;
  }
  if (cl.var) s.x[j] = st.x;
  __syncthreads();
}

// ---- relative residuals at x~ and the deferred rho rescale --------------------
// Only K^-1 is at hand, so P x~ comes from K x~ = rhs:
//   P x~ = rhs - sigma x~ - C^T rho C x~.
// Expects w = rho z - y in s.w and rhs = sigma x - q + C^T w in s.rhs, as
// admm leaves them.
template <bool kCompact = false>
__device__ inline float residuals_rho(const QpDims& dm, const QpShared& s, const QpThread& t,
                                      const KTile& kt, float sigma, float rho_mult,
                                      bool deferred_rho, float* pri_rel_out,
                                      float* dua_rel_out, int ns = 0) {
  const int n = dm.n, m = dm.m;
  kinv_apply<kCompact>(dm, s, t, kt, ns);
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
// y_out at its output rows, each in the input's order (on the compact path
// through the block order). Returns the violation in every thread.
template <bool kCompact = false>
__device__ inline float unscale(const QpDims& dm, const QpShared& s, const QpThread& t,
                                float c_cost, const float* c0, const float* lb,
                                const float* ub, float* x_out, float* z_out,
                                float* y_out) {
  if constexpr (kCompact) {
    for (int j = t.tid; j < dm.n; j += t.nt) {
      const float xu = s.x[j] * s.d[j];
      s.xt[j] = xu;
      x_out[src_var(s, j)] = xu;
    }
    __syncthreads();
    float viol = -3.0e38f;
    for (int r = t.tid; r < dm.m; r += t.nt) {
      const int k = r / 5, ro = src_row(s, r);   // the input's block of row r
      const float* c = c0 + 15 * s.order[2 + k] + 3 * (r - 5 * k);
      const float* v = s.xt + 3 * k;
      const float zu = fmaf(c[2], v[2], fmaf(c[1], v[1], c[0] * v[0]));
      z_out[ro] = zu;
      y_out[ro] = s.y[r] * (s.e[r] / c_cost);
      viol = fmaxf(viol, fmaxf(lb[ro] - zu, zu - ub[ro]));
    }
    viol = block_max(viol, s, t);
    return fmaxf(viol, 0.0f);
  } else {   // as written before the compact path, which keeps rows 2-4's code
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
}

}  // namespace rlmpc
