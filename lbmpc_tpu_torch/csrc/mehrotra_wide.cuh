// mehrotra_wide.cuh — K2's Mehrotra loop for one lane on one 256-thread
// block, at 32 < nz <= 128 and mI <= 1024: the body of mehrotra_h_wide.cu
// (K2w) and of gn_mehrotra_wide.cu (K3w).
//
//   min 1/2 x'H x + g'x  s.t.  G x <= h   (G shared by the batch)
//
// The iteration is K2's (mehrotra_warp.cuh), with its constants and its
// order of steps: d = min(z / max(s, 1e-25), d_cap), M = G' diag(d) G + H +
// 1e-6 I, symmetric Jacobi equilibration, Cholesky with the pivot floor, two
// triangular solves each for the predictor and the corrector, sigma =
// (mu_aff / max(mu, 1e-25))^3, ratio tests with the 1e6 sentinel, step
// fraction tau. What bounds it on an H100, per lane and iteration: the
// assembly's multiply-adds and the serial chain of the factorization and
// the sweeps; G (414 KB at the DMS shape) does not fit a block's shared
// memory, so it stays in device memory, L2-resident, read by every block.
//
// G's structure comes from a host plan computed once per G (ops/qp_kernel
// WidePlan: each row's nonzero extent, each column's causal suffix, each
// chunk's tiles; the reference's r5 analysis, pallas_ipm.py:84-92). The
// kernels skip only products that are structural zeros, and add everything
// else in the order and with the rounding of the dense version this one
// replaced (a warp a row, the whole square), so for finite inputs they
// return its bits (tools/k2w_numerics.py --parent checks it; chip_smoke.py
// phase 20 holds them to their plain version, and a summation order that
// differs moves the share of float32 lanes that stall by several points,
// PERF.md). Rows keep G's order: the reference's sort by last column saves
// no tile at the DMS shape and 6 % at N40, and would reorder every sum over
// the rows.
// - The assembly of G' diag(d) G streams the rows a chunk at a time into a
//   shared ring by cp.async (the next chunks' copies overlap this chunk's
//   multiply-adds; one block barrier a chunk), only the 16-column tiles the
//   chunk reaches (chunk_tiles; every other tile holds no nonzero of the
//   chunk). The block's 16 x 16 threads each keep the lower-triangle tiles'
//   entries (ty + 16a, tx + 16b), b <= a, in registers; a chunk adds only
//   the tiles a < chunk_tiles (the causal suffix at 16-column granularity).
//   Partial sums over kGroupRows rows join a running total, as the dense
//   version's 32-row chunks joined M.
// - G x and G dx: a thread a row, over the row's nonzero extent, from the
//   column-major copy GpT (coalesced across the rows, many loads in
//   flight), into registers, in the dense version's association (a warp's
//   32 lanes' strided partial sums, then a shuffled butterfly; RowDot).
// - G'v: column c sums the rows of its tile's causal suffix, kParts
//   partitions, the partials added in partition order.
// The factorization is a panel Cholesky on every thread: each panel of
// kPanel columns lives in registers, a row a thread, two block barriers a
// column (the pivot and the panel rows' L broadcast through shared memory),
// then the trailing matrix is updated once, a warp a row, each lane holding
// its columns' panel entries in registers; every entry gets the column
// form's terms in its order and rounding (chol_body.cuh factor_cols). The
// solves go by blocks of 32 columns: warp 0 solves the diagonal block with
// shuffles, the block subtracts it from the rest as one matrix-vector
// product — two barriers a block instead of one a column — with chol::solve's terms,
// order and rounding. Both are chol_body.cuh's factor_panel and
// solve_blocked, which K5 runs above n = 32 too.
// One thread per constraint row keeps that row's s, z, d, rp and the
// predictor/corrector terms in registers (mehrotra_body.cuh's kRowsPerThread
// rows); step lengths and mu are K2's block reductions.
// The kernels that include this file (K2w, K3w) are built with -fmad=false
// (ops/_cuda.py), so the compiler fuses no multiply-add on its own, and
// fuses them alike in both; the dot products and the assembly use explicit
// fused multiply-adds (__fmaf_rn). K3w runs the same functions on the same
// plan, so it equals K1w, then K2w, bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "chol_body.cuh"
#include "mehrotra_body.cuh"

namespace mehrotra_wide {

using mehrotra::kBig;
using mehrotra::kFull;
using mehrotra::kMaxRows;
using mehrotra::kRidge;
using mehrotra::kRowsPerThread;
using mehrotra::kThreads;
using mehrotra::kWarps;

constexpr int kNzMin = mehrotra::kNzMax + 1;    // K2 takes nz <= 32
constexpr int kNzMax = 128;
constexpr int kTile = 16;                       // 16 x 16 threads; column tiles (WidePlan.TILE)
constexpr int kGroupRows = 32;                  // rows summed in registers before the total
constexpr int kParts = 8;                       // row partitions of G'v
constexpr int kPanel = chol::kPanel;            // columns a factorization panel
static_assert(kThreads == chol::kBlockThreads, "chol::factor_panel runs on K2w's block");

// Phase clocks, for tools/k2w_split.py only: built with K2W_PHASE_CLOCKS,
// thread 0 of each block adds the clock64() cycles of every phase of every
// iteration into kClockSlots counters (each stamp is a block barrier in that
// build, so thread 0's clock is the block's) and solve() stores them in
// k2w_clocks[block * kClockSlots + phase]. The package's build never defines
// the macro, and then PhaseClock is empty.
enum ClockPhase { kClkGx, kClkGtz, kClkAssemble, kClkEquil, kClkFactor, kClkGtv, kClkSweep,
                  kClkGdx, kClkReduce, kClkTotal, kClockSlots };
#ifdef K2W_PHASE_CLOCKS
constexpr int kClockBlocks = 16384;
__device__ unsigned long long k2w_clocks[kClockBlocks * kClockSlots];
struct PhaseClock {
  long long last, first;
  unsigned long long acc[kClockSlots];
  __device__ __forceinline__ void start() {
    __syncthreads();
    if (threadIdx.x == 0) {
      last = first = clock64();
#pragma unroll
      for (int p = 0; p < kClockSlots; ++p) acc[p] = 0;
    }
  }
  __device__ __forceinline__ void mark(int p) {
    __syncthreads();
    if (threadIdx.x == 0) {
      const long long t = clock64();
      acc[p] += t - last;
      last = t;
    }
  }
  __device__ __forceinline__ void store() {
    if (threadIdx.x == 0 && blockIdx.x < kClockBlocks) {
      acc[kClkTotal] = clock64() - first;
#pragma unroll
      for (int p = 0; p < kClockSlots; ++p) k2w_clocks[blockIdx.x * kClockSlots + p] = acc[p];
    }
  }
};
// `<source>_clocks(out, blocks)`: the first `blocks` blocks' counters of the
// last launch, copied to the host array `out`
#define K2W_CLOCKS_EXPORT(source)                                                        \
  extern "C" int source##_clocks(unsigned long long* out, int blocks) {                  \
    return (int)cudaMemcpyFromSymbol(                                                    \
        out, mehrotra_wide::k2w_clocks,                                                  \
        (size_t)blocks * mehrotra_wide::kClockSlots * sizeof(unsigned long long));       \
  }
#else
#define K2W_CLOCKS_EXPORT(source)
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void store() {}
};
#endif

// Rows a staged chunk (WidePlan.chunk_rows, a divisor of kGroupRows): two
// chunks at the DMS width, where the ring must leave two blocks an SM their
// shared memory; one (fewer block barriers and copy latencies) where the
// columns are few.
__host__ __device__ constexpr int chunk_rows(int nz) { return nz <= 64 ? 32 : 16; }

// Chunks the ring holds: copies start that many chunks less one ahead
// of the multiply-adds; four where the shared memory allows, two at the DMS
// width.
__host__ __device__ constexpr int ring_chunks(int nz) { return nz <= 64 ? 4 : 2; }

// The plan on the device (ops/qp_kernel.WidePlan): Gp, G zero-padded to
// (mI rounded up to chunk_rows) x ld, ld = nz rounded up to kTile; GpT, G
// transposed (nz x mI); meta = row_lo (mI) | row_hi (mI) | col_start (nz) |
// chunk_tiles (mI / chunk_rows rounded up).
struct Plan {
  const float* Gp;
  const float* GpT;
  const int* row_lo;
  const int* row_hi;
  const int* col_start;
  const int* chunk_tiles;
  int ld;     // Gp's row stride
  int chunk;  // chunk_rows(nz)
};

__host__ __device__ constexpr int round_up(int a, int m) { return (a + m - 1) / m * m; }

__device__ __forceinline__ Plan make_plan(const float* Gp, const float* GpT, const int* meta,
                                          int mI, int nz) {
  Plan p;
  p.Gp = Gp;
  p.GpT = GpT;
  p.row_lo = meta;
  p.row_hi = meta + mI;
  p.col_start = meta + 2 * mI;
  p.chunk_tiles = meta + 2 * mI + nz;
  p.ld = round_up(nz, kTile);
  p.chunk = chunk_rows(nz);
  return p;
}

struct Shared {
  float* ring;   // ring_chunks * chunk * ld: the staged chunks (first: 16-byte aligned)
  float* H;      // nz * nz
  float* A;      // nz * nz: M, equilibrated, factored in place into L (lower)
  float* va;     // mI (rounded up to chunk): z, then the KKT's t
  float* vb;     // the same: d
  float* part;   // kParts * nz: partial column sums of G'v
  float* x;      // kNzMax each from here on
  float* dx;
  float* rd;
  float* gt;
  float* sc;
  float* g;
  float* v;      // the KKT right-hand side, solved in place
  float* panel;  // 2 * kPanel: the factorization's pivot and panel column
  float* red;    // 2 * kWarps + 2
};

__host__ __device__ constexpr size_t shared_floats(int mI, int nz) {
  return (size_t)ring_chunks(nz) * chunk_rows(nz) * round_up(nz, kTile) + 2 * (size_t)nz * nz
         + 2 * (size_t)round_up(mI, chunk_rows(nz)) + (size_t)kParts * nz + 7 * kNzMax
         + 2 * kPanel + 2 * kWarps + 2;
}

__device__ __forceinline__ Shared carve(float* smem, int mI, int nz) {
  Shared sh;
  const int ld = round_up(nz, kTile), mIp = round_up(mI, chunk_rows(nz));
  sh.ring = smem;
  sh.H = sh.ring + ring_chunks(nz) * chunk_rows(nz) * ld;
  sh.A = sh.H + nz * nz;
  sh.va = sh.A + nz * nz;
  sh.vb = sh.va + mIp;
  sh.part = sh.vb + mIp;
  sh.x = sh.part + kParts * nz;
  sh.dx = sh.x + kNzMax;
  sh.rd = sh.dx + kNzMax;
  sh.gt = sh.rd + kNzMax;
  sh.sc = sh.gt + kNzMax;
  sh.g = sh.sc + kNzMax;
  sh.v = sh.g + kNzMax;
  sh.panel = sh.v + kNzMax;
  sh.red = sh.panel + 2 * kPanel;
  return sh;
}

// One row's dot product with vec in the association of the dense version's
// warp: lane u summed the row's columns c = u (mod 32) in order, and
// mehrotra::warp_sum added the lanes by a butterfly (offsets 16, 8, 4, 2,
// 1). Here one thread computes lane 0's result: v<K, U> is the value lane U
// holds after K steps of the butterfly, walked depth first, so about K
// partial sums are live at once; leaf<U> is lane U's sum over its kM
// columns (those outside [lo, hi) hold zeros). Reads GpT (G transposed),
// coalesced across the rows of a warp's threads; vec (kNzMax floats) must
// be 0 past nz.
template <int kM>
struct RowDot {
  const float* col;  // GpT + the row
  const float* vec;
  int mI, lo, hi;
  template <int U>
  __device__ __forceinline__ float leaf() const {
    float a = 0.f;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      // a column outside the extent adds an exact zero (vec is 0 past nz):
      // a predicated load, no branch
      const int c = U + 32 * m;
      const float gc = (c >= lo && c < hi) ? __ldg(col + (size_t)c * mI) : 0.f;
      a = __fmaf_rn(gc, vec[c], a);
    }
    return a;
  }
  template <int K, int U>
  __device__ __forceinline__ float v() const {
    if constexpr (K == 0) {
      return this->template leaf<U>();
    } else {
      const float lhs = this->template v<K - 1, U>();
      return lhs + this->template v<K - 1, U + (16 >> (K - 1))>();
    }
  }
};

// out[t] = row r = tid + t kThreads of G x vec over the row's extent, into
// the thread's registers (RowDot; 16 kT >= nz). No barrier.
template <int kT>
__device__ __forceinline__ void row_dots(const Plan& P, const float* vec,
                                         float (&out)[kRowsPerThread], int mI) {
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = threadIdx.x + t * kThreads;
    out[t] = 0.f;
    if (r < mI) {
      const RowDot<(kT + 1) / 2> dot{P.GpT + r, vec, mI, __ldg(P.row_lo + r),
                                     __ldg(P.row_hi + r)};
      out[t] = dot.template v<5, 0>();
    }
  }
}

// out[c] = sum over the rows t >= col_start[c] of G[t][c] v[t]: kParts
// partitions, the pair q = p nz + c summing the rows t = p (mod kParts)
// from col_start[c] up, the partials added in p order (the dense sum, less
// its structural zeros). Entry synchronised; exit too.
__device__ __forceinline__ void col_dots(const Shared& sh, const Plan& P, const float* v,
                                         float* out, int mI, int nz) {
  const int tid = threadIdx.x;
  for (int q = tid; q < kParts * nz; q += kThreads) {
    const int c = q % nz, p = q / nz;
    // the suffix of c's tile's first column (no later than c's own: the
    // extra rows hold zeros in column c), so a tile's threads read one row
    // at a time
    const int start = __ldg(P.col_start + (c & ~(kTile - 1)));
    float a = 0.f;
    {
      const float* gc = P.Gp + c;
#pragma unroll 4
      for (int t = start + ((p - start) % kParts + kParts) % kParts; t < mI; t += kParts)
        a = __fmaf_rn(__ldg(gc + (size_t)t * P.ld), v[t], a);
    }
    sh.part[q] = a;
  }
  __syncthreads();
  if (tid < nz) {
    float a = 0.f;
#pragma unroll
    for (int p = 0; p < kParts; ++p) a += sh.part[p * nz + tid];
    out[tid] = a;
  }
  __syncthreads();
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start the copy of chunk k (P.chunk rows, the first 16 `tiles` columns of
// each) into buf, and commit it as one group.
__device__ __forceinline__ void stage(float* buf, const Plan& P, int k, int tiles) {
  const int per_row = tiles * (kTile / 4);
  const float* src = P.Gp + (size_t)k * P.chunk * P.ld;
  for (int e = threadIdx.x; e < P.chunk * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * 4;
    cp_async16(buf + r * P.ld + c, src + (size_t)r * P.ld + c);
  }
  cp_async_commit();
}

// The index of the lower tile pair (a, b), b <= a, in a thread's registers.
__host__ __device__ constexpr int tri_index(int a, int b) { return a * (a + 1) / 2 + b; }

// One staged chunk into acc: rows rr < rows of buf (row stride ld), d in
// dch; only the tile pairs b <= a <= kS (the chunk reaches kS + 1 tiles).
template <int kT, int kS>
__device__ __forceinline__ void add_chunk(float (&acc)[kT * (kT + 1) / 2], const float* buf,
                                          const float* dch, int rows, int ld, int ty, int tx) {
  for (int rr = 0; rr < rows; ++rr) {
    const float* gr = buf + rr * ld;
    const float dr = dch[rr];
    float gi[kS + 1], gj[kS + 1];
#pragma unroll
    for (int a = 0; a <= kS; ++a) {
      gi[a] = gr[ty + kTile * a];
      gj[a] = dr * gr[tx + kTile * a];
    }
#pragma unroll
    for (int a = 0; a <= kS; ++a)
#pragma unroll
      for (int b = 0; b <= a; ++b)
        acc[tri_index(a, b)] = __fmaf_rn(gi[a], gj[b], acc[tri_index(a, b)]);
  }
}

// A's lower triangle = G' diag(d) G + H + 1e-6 I, d by row in sh.vb; kT =
// the register tile's side (16 kT >= nz). Entry synchronised; exit too.
template <int kT>
__device__ __forceinline__ void assemble(const Shared& sh, const Plan& P, int mI, int nz) {
  constexpr int kPairs = kT * (kT + 1) / 2;
  const int tid = threadIdx.x;
  const int ty = tid / kTile, tx = tid % kTile;
  const int ld = P.ld, chunk = P.chunk, n_chunks = (mI + chunk - 1) / chunk;
  const int group = max(1, kGroupRows / chunk);
  float tot[kPairs], acc[kPairs];
#pragma unroll
  for (int e = 0; e < kPairs; ++e) tot[e] = acc[e] = 0.f;
  // chunk c goes to ring slot c % slots; each step commits one copy group
  // (empty past the last chunk), so chunk k is in once at most slots - 2
  // groups are pending
  const int slots = ring_chunks(nz);
  const auto fetch = [&](int c) {
    if (c < n_chunks)
      stage(sh.ring + (c % slots) * chunk * ld, P, c, __ldg(P.chunk_tiles + c));
    else
      cp_async_commit();
  };
  for (int c = 0; c < slots - 1; ++c) fetch(c);
  for (int k = 0; k < n_chunks; ++k) {
    if (slots == 4)
      cp_async_wait<2>();
    else
      cp_async_wait<0>();
    __syncthreads();  // chunk k is in; chunk k - 1's slot is free
    fetch(k + slots - 1);
    const float* buf = sh.ring + (k % slots) * chunk * ld;
    const float* dch = sh.vb + k * chunk;
    const int rows = min(chunk, mI - k * chunk);
    switch (__ldg(P.chunk_tiles + k)) {
      case 1: add_chunk<kT, 0>(acc, buf, dch, rows, ld, ty, tx); break;
      case 2: if constexpr (kT >= 2) add_chunk<kT, 1>(acc, buf, dch, rows, ld, ty, tx); break;
      case 3: if constexpr (kT >= 3) add_chunk<kT, 2>(acc, buf, dch, rows, ld, ty, tx); break;
      case 4: if constexpr (kT >= 4) add_chunk<kT, 3>(acc, buf, dch, rows, ld, ty, tx); break;
      case 5: if constexpr (kT >= 5) add_chunk<kT, 4>(acc, buf, dch, rows, ld, ty, tx); break;
      case 6: if constexpr (kT >= 6) add_chunk<kT, 5>(acc, buf, dch, rows, ld, ty, tx); break;
      case 7: if constexpr (kT >= 7) add_chunk<kT, 6>(acc, buf, dch, rows, ld, ty, tx); break;
      default: if constexpr (kT >= 8) add_chunk<kT, 7>(acc, buf, dch, rows, ld, ty, tx); break;
    }
    if ((k + 1) % group == 0 || k + 1 == n_chunks) {
#pragma unroll
      for (int e = 0; e < kPairs; ++e) {
        tot[e] += acc[e];
        acc[e] = 0.f;
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kT; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      const int i = ty + kTile * a, j = tx + kTile * b;
      if (i < nz && j <= i)
        sh.A[i * nz + j] = tot[tri_index(a, b)] + sh.H[i * nz + j] + (i == j ? kRidge : 0.f);
    }
  }
  __syncthreads();
}

// Symmetric Jacobi equilibration of A's lower triangle, scale in sh.sc.
// Entry synchronised; exit too.
__device__ __forceinline__ void equilibrate(const Shared& sh, int nz) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid < nz) sh.sc[tid] = 1.f / sqrtf(fmaxf(sh.A[tid * nz + tid], 1e-30f));
  __syncthreads();
  for (int i = warp; i < nz; i += kWarps)
    for (int j = lane; j <= i; j += 32) sh.A[i * nz + j] = sh.A[i * nz + j] * sh.sc[i] * sh.sc[j];
  __syncthreads();
}

// One KKT solve for the complementarity right-hand side rc:
// dx = sc * L^-T L^-1 (-(rd + G' t) * sc), t = d rp - rc / s_safe, then
// dz = d (rp + G dx) - rc / s_safe and ds = -rp - G dx per row (K2's kkt).
template <int kT>
__device__ __forceinline__ void kkt(const Shared& sh, const Plan& P, int mI, int nz,
                                    const float (&d)[kRowsPerThread],
                                    const float (&rp)[kRowsPerThread],
                                    const float (&ss)[kRowsPerThread],
                                    const float (&rc)[kRowsPerThread],
                                    float (&ds)[kRowsPerThread], float (&dz)[kRowsPerThread],
                                    PhaseClock& clk) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = tid + t * kThreads;
    if (r < mI) sh.va[r] = d[t] * rp[t] - rc[t] / ss[t];
  }
  __syncthreads();
  col_dots(sh, P, sh.va, sh.gt, mI, nz);
  if (tid < nz) sh.v[tid] = -(sh.rd[tid] + sh.gt[tid]) * sh.sc[tid];
  __syncthreads();
  clk.mark(kClkGtv);
  chol::solve_blocked(sh.A, sh.v, nz);
  if (tid < nz) sh.dx[tid] = sh.v[tid] * sh.sc[tid];
  __syncthreads();
  clk.mark(kClkSweep);
  float gdx[kRowsPerThread];
  row_dots<kT>(P, sh.dx, gdx, mI);
  clk.mark(kClkGdx);
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    if (tid + t * kThreads < mI) {
      dz[t] = d[t] * (rp[t] + gdx[t]) - rc[t] / ss[t];
      ds[t] = -rp[t] - gdx[t];
    }
  }
}

// The iteration loop. On entry the caller has staged H (nz x nz, row-major;
// M reads its lower triangle, H x its rows) and g in shared memory, set sh.x
// and sh.dx (all kNzMax entries) to 0, put each row's s, z and h in the
// thread's registers (rows >= mI: zeros), and synchronised. On exit sh.x
// holds the solution and s, z the final interior.
template <int kT>
__device__ __forceinline__ void solve(const Shared& sh, const Plan& P, int mI, int nz,
                                      int iters, float tau, float d_cap,
                                      float (&s)[kRowsPerThread], float (&z)[kRowsPerThread],
                                      const float (&hr)[kRowsPerThread]) {
  const int tid = threadIdx.x;
  const float inv_m = 1.f / (float)mI;
  PhaseClock clk;
  clk.start();
  for (int it = 0; it < iters; ++it) {
    float gx[kRowsPerThread];
    row_dots<kT>(P, sh.x, gx, mI);  // G x
    clk.mark(kClkGx);
    float rp[kRowsPerThread], ss[kRowsPerThread], d[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      rp[t] = ss[t] = d[t] = 0.f;
      if (r < mI) {
        rp[t] = gx[t] + s[t] - hr[t];
        ss[t] = fmaxf(s[t], 1e-25f);
        d[t] = fminf(z[t] / ss[t], d_cap);
        sh.va[r] = z[t];
        sh.vb[r] = d[t];
      }
    }
    __syncthreads();
    col_dots(sh, P, sh.va, sh.gt, mI, nz);  // G'z
    if (tid < nz) {
      float hx = 0.f;
      for (int j = 0; j < nz; ++j) hx = __fmaf_rn(sh.H[tid * nz + j], sh.x[j], hx);
      sh.rd[tid] = hx + sh.g[tid] + sh.gt[tid];
    }
    __syncthreads();
    clk.mark(kClkGtz);
    assemble<kT>(sh, P, mI, nz);
    clk.mark(kClkAssemble);
    equilibrate(sh, nz);
    clk.mark(kClkEquil);
    chol::factor_panel(sh.A, sh.panel, nz);
    clk.mark(kClkFactor);

    // predictor
    float mu_part = 0.f, rc[kRowsPerThread], dsa[kRowsPerThread], dza[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      rc[t] = s[t] * z[t];
      dsa[t] = dza[t] = 0.f;
      if (r < mI) mu_part += rc[t];
    }
    clk.mark(kClkReduce);
    kkt<kT>(sh, P, mI, nz, d, rp, ss, rc, dsa, dza, clk);
    const float mu = mehrotra::block_reduce2<false>(mu_part, 0.f, sh.red).x * inv_m;
    const float2 ra = mehrotra::ratio_min(mI, s, dsa, z, dza, kBig, sh.red);
    const float ap_a = fminf(1.f, 1.f * ra.x), ad_a = fminf(1.f, 1.f * ra.y);
    float aff_part = 0.f;
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      if (r < mI) aff_part += (s[t] + ap_a * dsa[t]) * (z[t] + ad_a * dza[t]);
    }
    const float mu_aff = mehrotra::block_reduce2<false>(aff_part, 0.f, sh.red).x * inv_m;
    const float sr = mu_aff / fmaxf(mu, 1e-25f);
    const float sigma = sr * sr * sr;

    // corrector
    float ds[kRowsPerThread], dz[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      rc[t] = s[t] * z[t] + dsa[t] * dza[t] - sigma * mu;
      ds[t] = dz[t] = 0.f;
    }
    clk.mark(kClkReduce);
    kkt<kT>(sh, P, mI, nz, d, rp, ss, rc, ds, dz, clk);
    const float2 rs = mehrotra::ratio_min(mI, s, ds, z, dz, kBig, sh.red);
    const float ap = fminf(1.f, tau * rs.x), ad = fminf(1.f, tau * rs.y);
    if (tid < nz) sh.x[tid] += ap * sh.dx[tid];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      s[t] += ap * ds[t];
      z[t] += ad * dz[t];
    }
    __syncthreads();
    clk.mark(kClkReduce);
  }
  clk.store();
}

}  // namespace mehrotra_wide
