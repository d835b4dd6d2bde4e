// chol_blocked.cu — batched Cholesky factor + solve by slabs of 8 columns
// (K6a, K6b): a lane on `warps` warps, several lanes a block.
//
// Replaces the TPU kernels of lbmpc_tpu/ops/pallas_chol.py with
// LBMPC_CHOL_BLOCKED=1 at n_p = 8 ceil(n / 8) >= 32:
//   chol_factor_solve_blocked_launch <- _factor_solve_call.kernel_blocked
//       (K6a): factor the SPD M (B, n, n), solve M x = b, and store L;
//   chol_solve_blocked_launch        <- _solve_call.kernel_blocked (K6b):
//       the same without storing L (LBMPC_CHOL_STORE=0).
// Both keep _chol_blocked_inplace's slab form: each entry subtracts its
// terms in the order k = 0..j-1 of the column form, every product,
// difference, quotient and square root rounded on its own (chol::sub_prod,
// chol::pivot, __fdiv_rn), so K6a equals K5a (L and x) and K6b equals K5b
// bit for bit, and both equal the plain version (ops/chol_kernel.py
// cholesky_floor and _tri_solves). The TPU version replicates columns
// through the MXU with its TILE8 / BC8 constant matrices, a device of the
// TPU's with no counterpart here.
//
// What bounds it on an H100: bytes, as K5: M's lower triangle in, L's out
// (K6a), 2 n(n+1) bytes each way a lane, against n^3/3 operations. What
// sets the time is each lane's serial chain (a square root, a quotient and
// two shuffles a column of the factorization, a quotient and a shuffle a
// column of each sweep) and the instruction slots of the SM's lanes, so
// the design keeps the chain short and on one warp, with no block barrier
// inside a slab, and fills each SM with lanes:
// - a lane runs on `warps` warps, `lanes` lanes a block; the host picks both
//   (ops/chol_kernel.blocked_launch). A lane's warps meet at their own named
//   barriers (bar.sync 1 + lane slot once a slab, 5 + lane slot mid-slab);
// - shared memory holds only L's lower triangle (row i padded to a multiple
//   of 8 floats, so a slab's 8 columns of a row are two aligned float4), the
//   right-hand side and y: 22.9 KB a lane at n = 101, where the earlier
//   kernel staged all n^2 entries and three vectors (42 KB);
// - the panel warp holds a slab's panel (its 8 columns, rows j0..n-1, 4 rows
//   x 8 a thread) in registers and factors it with shuffles, with no branch
//   inside a whole slab's columns (templates on the row groups and on a
//   whole slab); the forward sweep runs inside it (the right-hand side is
//   the panel's ninth column: y_j on the diagonal's lane, every row below
//   subtracts L[i][j] y_j);
// - look-ahead: while the other warps subtract slab s's terms from the
//   columns right of slab s+1, the panel warp factors slab s+1 once its
//   own columns have them (it subtracts them from the first 32 rows, the
//   other warps from the rest): every entry still takes its terms in
//   column order, and a slab costs two lane barriers where the earlier
//   kernel took two block barriers a slab and three warp barriers a column;
// - the trailing update runs from registers over the lower triangle only: a
//   warp lane owns two columns and their slab rows L[k][j0..j0+7], each row
//   i >= k reads its slab row by broadcast, no division or modulo an entry;
// - the back sweep runs on the panel warp with shuffles (row j of L read by
//   consecutive lanes, no branch inside a step), L's store on the other
//   warps beside it, row by row, coalesced, with the zeros above the
//   diagonal.
//
// Layout: M, L (B, n, n) row-major, b and x (B, n), float32, contiguous,
// n <= 128. Only M's lower triangle is read. L is written whole, lower
// triangle with the diagonal and zeros above, in K5's layout, so K5c
// (chol_resolve) resolves it as it is.

#include <cuda_runtime.h>

#include "chol_body.cuh"

namespace {

using chol::kFull;
using chol::pivot;
using chol::sub_prod;

constexpr int kSlab = 8;                   // columns a slab (the reference's kernel_blocked)
constexpr int kMaxLanes = 4;               // lanes a block: named barriers 1..8
constexpr int kMaxThreads = 512;           // threads a block
constexpr int kMinBlocks = 2;              // blocks an SM: 64 registers a thread at 512

// Row i of a lane's triangle starts at tri_row(i): rows 8q..8q+7 hold 8(q+1)
// floats each, row i's columns 0..i and its padding.
__host__ __device__ constexpr int tri_row(int i) {
  return kSlab * ((i >> 3) + 1) * (4 * (i >> 3) + (i & 7));
}
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }
// A lane's shared memory in floats: the triangle, the right-hand side, y.
__host__ __device__ constexpr size_t lane_floats(int n) {
  return (size_t)tri_row(n) + 2 * round4(n);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// The lane's barriers: its `threads` threads only (wait; or arrive and go
// on).
__device__ __forceinline__ void lane_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void lane_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void ld8(const float* p, float (&v)[kSlab]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = c.x, v[5] = c.y, v[6] = c.z, v[7] = c.w;
}

__device__ __forceinline__ void st8(float* p, const float (&v)[kSlab]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// Phase clocks, for tools/k6_compare.py only: built with K6_PHASE_CLOCKS,
// the lane's thread 0 (the panel warp's lane 0) adds the clock64() cycles of
// each phase into the slots of the tool's PHASES — the stage; the panel
// warp's factorization of its rows; its waits at the slab barriers, the
// time the other warps take beyond it; L's store and the forward sweep,
// both 0 (the one beside the back sweep, the other inside the panels); the
// back sweep, L's store beside it; the panel warp's row loads and
// look-ahead — and the lane's thread 32 (the next warp's lane 0) its
// trailing updates; the lane's total last, into
// k6_clocks[lane * kClockSlots + slot]; `chol_blocked_clocks(out, lanes)`
// copies the first `lanes` lanes' to the host. The package's build never
// defines the macro, and then PhaseClock is empty.
enum {
  kClkStage, kClkPanel, kClkWait, kClkStore, kClkForward, kClkBack, kClkApply, kClkTrail,
  kClkTotal, kClockSlots
};
#ifdef K6_PHASE_CLOCKS
constexpr int kClockLanes = 16384;
__device__ unsigned long long k6_clocks[kClockLanes * kClockSlots];
struct PhaseClock {
  int who, lane;  // who: 0 thread 0, 1 thread 32, -1 neither
  long long last, first;
  unsigned long long acc[kClockSlots];
  __device__ __forceinline__ PhaseClock(int tid, int lb)
      : who(lb >= kClockLanes ? -1 : tid == 0 ? 0 : tid == 32 ? 1 : -1), lane(lb) {
    last = first = clock64();
#pragma unroll
    for (int p = 0; p < kClockSlots; ++p) acc[p] = 0;
  }
  __device__ __forceinline__ void mark(int p) {
    const long long t = clock64();
    acc[p] += t - last;
    last = t;
  }
  __device__ __forceinline__ void store() {
    if (who < 0) return;
    acc[kClkTotal] = clock64() - first;
#pragma unroll
    for (int p = 0; p < kClockSlots; ++p)
      if ((p == kClkTrail) == (who == 1))
        k6_clocks[lane * kClockSlots + p] = acc[p];
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ PhaseClock(int, int) {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void store() {}
};
#endif

// Rows i = c0 + 32 q + l (l the warp lane) of slab c0 (columns c0..c0+w-1,
// w = min(8, n - c0): 8 when kWhole) into a (8 columns) and r (their
// right-hand side), with slab p0's terms subtracted first when p0 >= 0 (the
// look-ahead: p0 = c0 - 8, whose columns are final; the rows have every
// earlier slab's): entry (i, c0+kk) L[i][p0+jj] L[c0+kk][p0+jj] for jj =
// 0..7 in that order. Rows past n read as zeros.
template <bool kWhole>
__device__ __forceinline__ void load_rows(const float* T, const float* v, int n, int c0, int p0,
                                          int q, int l, float (&a)[kSlab], float& r) {
  const int i = c0 + 32 * q + l, w = kWhole ? kSlab : min(kSlab, n - c0);
  float pi[kSlab];
#pragma unroll
  for (int kk = 0; kk < kSlab; ++kk) a[kk] = pi[kk] = 0.f;
  r = 0.f;
  if (i < n) {
    ld8(T + tri_row(i) + c0, a);
    r = v[i];
    if (p0 >= 0) ld8(T + tri_row(i) + p0, pi);
  }
  if (p0 < 0) return;
#pragma unroll
  for (int kk = 0; kk < kSlab; ++kk) {
    if (kk < w) {
      const float* pk = T + tri_row(c0 + kk) + p0;
#pragma unroll
      for (int h = 0; h < kSlab; h += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(pk + h);
        a[kk] = sub_prod(a[kk], pi[h], k4.x);
        a[kk] = sub_prod(a[kk], pi[h + 1], k4.y);
        a[kk] = sub_prod(a[kk], pi[h + 2], k4.z);
        a[kk] = sub_prod(a[kk], pi[h + 3], k4.w);
      }
    }
  }
}

// Slab c0 on the lane's panel warp (l its warp lane): thread l holds the
// slab's rows i = c0 + l + 32 q, q < NQ (8 columns each) and their
// right-hand side r in registers, slab p0's terms subtracted first
// (load_rows: rows c0..c0+31 here; with mid > 0 the other warps subtract
// them from the rest, apply_rows, and the panel warp reads those after the
// lane's barrier mid). Column jj: L[i][j] = acc_i / sqrt(max(acc_jj, 1e-30)) (the
// pivot from lane jj by a shuffle), y_j = r_j / L[j][j] on lane jj (the
// forward sweep inside the panel), every row's r subtracts L[i][j] y_j and
// its columns right of jj subtract L[i][j] L[c0+kk][j] (that factor from
// lane kk by a shuffle). Rows above a column's diagonal and past n divide
// 1, not their entry: a zero operand sends __fdiv_rn down its slow path for
// the whole warp (their quotients go unread). A whole slab (kWhole: 8 columns)
// has no branch inside its columns, so the compiler schedules each
// column's chain (shuffle, square root, quotient, shuffle, product and
// difference) with the rest around it; NQ fixes the row groups likewise.
// The panel goes back to T (8 floats a row: the entries right of the
// diagonal land in the row's padding and are never read), y_j to y, and
// the rows past the slab's r to v.
template <int NQ, bool kWhole>
__device__ __forceinline__ void panel(float* T, float* v, float* y, int n, int c0, int p0,
                                      int l, int mid, int lt, PhaseClock& clk) {
  const int w = kWhole ? kSlab : min(kSlab, n - c0);
  float a[NQ][kSlab], r[NQ];
  load_rows<kWhole>(T, v, n, c0, p0, 0, l, a[0], r[0]);
  if (NQ > 1 && mid > 0) lane_sync(mid, lt);
#pragma unroll
  for (int q = 1; q < NQ; ++q)
    load_rows<kWhole>(T, v, n, c0, mid > 0 ? -1 : p0, q, l, a[q], r[q]);
  clk.mark(kClkApply);
#pragma unroll
  for (int jj = 0; jj < kSlab; ++jj) {
    if (jj < w) {
      const float pj = pivot(__shfl_sync(kFull, a[0][jj], jj));
      float lij[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const bool own = c0 + 32 * q + l < n && 32 * q + l >= jj;
        lij[q] = __fdiv_rn(own ? a[q][jj] : 1.f, pj);
      }
      const float yj =
          __shfl_sync(kFull, __fdiv_rn(l == jj ? r[0] : 1.f, l == jj ? lij[0] : 1.f), jj);
      if (l == jj) y[c0 + jj] = yj;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        r[q] = sub_prod(r[q], lij[q], yj);
        a[q][jj] = lij[q];
      }
#pragma unroll
      for (int kk = jj + 1; kk < kSlab; ++kk) {
        if (kk < w) {
          const float lk = __shfl_sync(kFull, lij[0], kk);
#pragma unroll
          for (int q = 0; q < NQ; ++q) a[q][kk] = sub_prod(a[q][kk], lij[q], lk);
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = c0 + 32 * q + l;
    if (i < n) {
      st8(T + tri_row(i) + c0, a[q]);
      if (32 * q + l >= kSlab) v[i] = r[q];
    }
  }
}

// panel<NQ, kWhole> at slab c0: NQ = ceil((n - c0) / 32) row groups; the
// last slab, when n is not a multiple of 8, the one partial (one group).
__device__ __forceinline__ void panel_slab(float* T, float* v, float* y, int n, int c0, int p0,
                                          int l, int mid, int lt, PhaseClock& clk) {
  if (n - c0 < kSlab) return panel<1, false>(T, v, y, n, c0, p0, l, mid, lt, clk);
  switch ((n - c0 + 31) >> 5) {
    case 1: return panel<1, true>(T, v, y, n, c0, p0, l, mid, lt, clk);
    case 2: return panel<2, true>(T, v, y, n, c0, p0, l, mid, lt, clk);
    case 3: return panel<3, true>(T, v, y, n, c0, p0, l, mid, lt, clk);
    default: return panel<4, true>(T, v, y, n, c0, p0, l, mid, lt, clk);
  }
}

// Slab c0's rows i = c0 + 32 q + l, q >= 1, with slab p0's terms subtracted
// (load_rows), back to T, on warp tw of nt beside the panel warp's own
// look-ahead of rows c0..c0+31; the panel warp reads them after the
// lane's mid-slab barrier.
__device__ __forceinline__ void apply_rows(float* T, const float* v, int n, int c0, int p0,
                                           int tw, int nt, int l) {
  for (int q = 1 + tw; 32 * q < n - c0; q += nt) {
    float a[kSlab], r;  // r unused: the panel warp loads v itself
    if (n - c0 >= kSlab) load_rows<true>(T, v, n, c0, p0, q, l, a, r);
    else load_rows<false>(T, v, n, c0, p0, q, l, a, r);
    if (c0 + 32 * q + l < n) st8(T + tri_row(c0 + 32 * q + l) + c0, a);
  }
}

// Slab j0's terms (columns j0..j0+7, final) subtracted from the trailing
// lower triangle's columns k >= k0, on warp tw of nt: thread l takes columns
// ka = c + l and kb = c + 32 + l of each block of 64 and keeps L[k][j0..j0+7]
// of both in registers; the rows i >= c go round-robin over the warps, each
// row's L[i][j0..j0+7] read by broadcast once for both; entry (i, k), k <= i,
// subtracts L[i][j] L[k][j] for j = j0..j0+7 in that order.
__device__ __forceinline__ void trailing(float* T, int n, int j0, int k0, int tw, int nt,
                                         int l) {
  for (int c = k0; c < n; c += 64) {
    const int ka = c + l, kb = c + 32 + l;
    float pa[kSlab], pb[kSlab];
    ld8(T + tri_row(min(ka, n - 1)) + j0, pa);
    ld8(T + tri_row(min(kb, n - 1)) + j0, pb);
    for (int i = c + tw; i < n; i += nt) {
      float* Ti = T + tri_row(i);
      float pi[kSlab];
      ld8(Ti + j0, pi);
      if (ka <= i) {
        float e = Ti[ka];
#pragma unroll
        for (int jj = 0; jj < kSlab; ++jj) e = sub_prod(e, pi[jj], pa[jj]);
        Ti[ka] = e;
      }
      if (kb <= i) {
        float e = Ti[kb];
#pragma unroll
        for (int jj = 0; jj < kSlab; ++jj) e = sub_prod(e, pi[jj], pb[jj]);
        Ti[kb] = e;
      }
    }
  }
}

// The back sweep L' x = y on the lane's panel warp: thread l holds y and
// L[i][i] of rows i = l + 32 q, q < NQ = ceil(n / 32). Column j, from the
// last: x_j = y_j / L[j][j] on lane j % 32, broadcast by a shuffle; every
// row i < j subtracts L[j][i] x_j (row j of L: consecutive lanes read
// consecutive words). The steps carry no branch (predicated loads and
// updates), so the next step's loads go ahead of this step's quotient.
// Writes x.
template <int NQ>
__device__ __forceinline__ void back_sweep(const float* T, const float* y,
                                           float* __restrict__ x_out, int n, int l) {
  float yv[NQ], dg[NQ], xv[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = l + 32 * q;
    yv[q] = i < n ? y[i] : 0.f;
    dg[q] = i < n ? T[tri_row(i) + i] : 1.f;
    xv[q] = 0.f;
  }
#pragma unroll
  for (int q = NQ - 1; q >= 0; --q) {
    for (int jj = q == NQ - 1 ? n - 1 - 32 * q : 31; jj >= 0; --jj) {
      const int j = 32 * q + jj;
      const float* Lj = T + tri_row(j);
      float lj[NQ];
#pragma unroll
      for (int p = 0; p <= q; ++p) lj[p] = l + 32 * p < j ? Lj[l + 32 * p] : 0.f;
      const float xj = __shfl_sync(kFull, __fdiv_rn(l == jj ? yv[q] : 1.f, dg[q]), jj);
      if (l == jj) xv[q] = xj;
#pragma unroll
      for (int p = 0; p <= q; ++p)
        if (l + 32 * p < j) yv[p] = sub_prod(yv[p], lj[p], xj);
    }
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    if (l + 32 * q < n) x_out[l + 32 * q] = xv[q];
}

__device__ __forceinline__ void back_sweep_rows(const float* T, const float* y,
                                                float* __restrict__ x_out, int n, int l) {
  switch ((n + 31) >> 5) {
    case 1: return back_sweep<1>(T, y, x_out, n, l);
    case 2: return back_sweep<2>(T, y, x_out, n, l);
    case 3: return back_sweep<3>(T, y, x_out, n, l);
    default: return back_sweep<4>(T, y, x_out, n, l);
  }
}

// `warps` warps a lane, blockDim.x / (32 warps) lanes a block.
template <bool kStore>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
chol_blocked_kernel(const float* __restrict__ Min, const float* __restrict__ b,
                    float* __restrict__ L_out, float* __restrict__ x_out, int B, int n,
                    int warps) {
  extern __shared__ __align__(16) float smem[];
  const int lt = warps * 32;  // a lane's threads
  const int g = threadIdx.x / lt;
  const int lb = blockIdx.x * (blockDim.x / lt) + g;
  if (lb >= B) return;  // whole lanes leave together
  // the lane's warp 0 (the panel warp) runs the panels and the back sweep,
  // the others the trailing updates and L's store
  const int tid = threadIdx.x - g * lt, w = tid >> 5, l = tid & 31, bar = 1 + g;
  float* T = smem + (size_t)g * lane_floats(n);  // L's lower triangle, rows padded
  float* v = T + tri_row(n);                     // the running right-hand side
  float* y = v + round4(n);                      // the forward sweep's result
  const float* Mb = Min + (size_t)lb * n * n;
  PhaseClock clk(tid, lb);

  // M's lower triangle, a warp a row, each row's padding zeroed; b
  for (int i = w; i < n; i += warps) {
    float* Ti = T + tri_row(i);
    const float* Mi = Mb + (size_t)i * n;
    for (int k = l; k < ((i + kSlab) & ~(kSlab - 1)); k += 32) {
      if (k <= i) cp_async4(Ti + k, Mi + k);
      else Ti[k] = 0.f;
    }
  }
  for (int i = tid; i < n; i += lt) cp_async4(v + i, b + (size_t)lb * n + i);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  lane_sync(bar, lt);
  clk.mark(kClkStage);

  // slab by slab: slab c0 on the panel warp, slab c0 - 8's terms subtracted
  // first (none for the first slab: the panel warp from the slab's first 32
  // rows, the other warps from its rows past them, then a mid-slab barrier
  // 1 + kMaxLanes + lane slot); beside it the other warps subtract slab
  // c0 - 8's terms from the columns past slab c0 (one warp: the same warp
  // after its panel); one barrier a slab
  const int tw = warps > 1 ? w - 1 : 0, nt = warps > 1 ? warps - 1 : 1;
  const int mid = 1 + kMaxLanes + g;
  for (int c0 = 0; c0 < n; c0 += kSlab) {
    const int p0 = c0 - kSlab;
    const bool split = warps > 1 && p0 >= 0 && n - c0 > 32;
    if (w == 0) panel_slab(T, v, y, n, c0, p0, l, split ? mid : 0, lt, clk);
    clk.mark(kClkPanel);
    if (split && w > 0) {
      apply_rows(T, v, n, c0, p0, tw, nt, l);
      lane_arrive(mid, lt);
    }
    if (c0 > 0 && (w > 0 || warps == 1)) trailing(T, n, p0, c0 + kSlab, tw, nt, l);
    clk.mark(kClkTrail);
    lane_sync(bar, lt);
    clk.mark(kClkWait);
  }

  // the back sweep on the panel warp; L's store on the others beside it
  // (one warp: before it), rows by warps and columns by lanes, with the
  // zeros above the diagonal
  if (kStore && (w > 0 || warps == 1)) {
    float* Lb = L_out + (size_t)lb * n * n;
    for (int i = tw; i < n; i += nt) {
      const float* Ti = T + tri_row(i);
      for (int k = l; k < n; k += 32) Lb[(size_t)i * n + k] = k <= i ? Ti[k] : 0.f;
    }
  }
  if (w == 0) back_sweep_rows(T, y, x_out + (size_t)lb * n, n, l);
  clk.mark(kClkBack);
#ifdef K6_PHASE_CLOCKS
  lane_sync(bar, lt);
  clk.mark(kClkStore);
#endif
  clk.store();
}

bool valid(int n, int warps, int lanes) {
  return n >= 1 && n <= chol::kNMax && warps >= 1 && lanes >= 1 && lanes <= kMaxLanes &&
         warps * lanes * 32 <= kMaxThreads;
}

size_t smem_bytes(int n, int lanes) { return (size_t)lanes * lane_floats(n) * sizeof(float); }

template <bool kStore>
int launch(const float* M, const float* b, float* L, float* x, int B, int n, int warps,
           int lanes, void* stream) {
  if (!valid(n, warps, lanes) || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(n, lanes);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        chol_blocked_kernel<kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  chol_blocked_kernel<kStore><<<(B + lanes - 1) / lanes, lanes * warps * 32, smem,
                                (cudaStream_t)stream>>>(M, b, L, x, B, n, warps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chol_factor_solve_blocked_launch(const float* M, const float* b, float* L,
                                                float* x, int B, int n, int warps, int lanes,
                                                void* stream) {
  return launch<true>(M, b, L, x, B, n, warps, lanes, stream);
}

extern "C" int chol_solve_blocked_launch(const float* M, const float* b, float* x, int B,
                                         int n, int warps, int lanes, void* stream) {
  return launch<false>(M, b, nullptr, x, B, n, warps, lanes, stream);
}

// The dynamic shared memory of a block of `lanes` lanes on `warps` warps
// each (bytes), -1 where the kernels do not take the shape;
// ops/chol_kernel.blocked_smem_bytes is held to it.
extern "C" long long chol_blocked_smem_bytes(int n, int warps, int lanes) {
  return valid(n, warps, lanes) ? (long long)smem_bytes(n, lanes) : -1;
}

// The lanes one SM holds in blocks of `lanes` lanes on `warps` warps each
// (CUDA's occupancy calculator) for kind 0 (K6a) or 1 (K6b).
extern "C" int chol_blocked_resident_lanes(int kind, int n, int warps, int lanes) {
  if (!valid(n, warps, lanes)) return -1;
  const size_t smem = smem_bytes(n, lanes);
  auto occ = [&](auto kernel) {
    int blocks = 0;
    // a launch above 48 KB raises the attribute itself; lowering it below
    // 48 KB here would refuse a later launch of more (launch() sets it only
    // above 48 KB)
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, lanes * warps * 32, smem);
    return blocks * lanes;
  };
  return kind == 0 ? occ(chol_blocked_kernel<true>) : occ(chol_blocked_kernel<false>);
}

#ifdef K6_PHASE_CLOCKS
extern "C" int chol_blocked_clocks(unsigned long long* out, int lanes) {
  if (lanes < 0 || lanes > kClockLanes) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, k6_clocks,
                                   (size_t)lanes * kClockSlots * sizeof(unsigned long long));
}
#endif

extern "C" const char* chol_blocked_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
