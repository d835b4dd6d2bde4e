// chol_body.cuh — block-wide Cholesky factorizations and solves of one
// lane's SPD matrix in shared memory, shared by chol.cu (K5 above n = 32)
// and mehrotra_wide.cuh (K2w, K3w).
//
// The factorization is the TPU kernel's column recurrence (pallas_chol.py
// _chol_cols): column j is acc = M[:, j] - sum_{k<j} L[j, k] L[:, k] with the
// terms taken in the order k = 0, 1, ..., j-1, L[j, j] = acc_j /
// sqrt(max(acc_j, 1e-30)) and L[i, j] = acc_i / sqrt(max(acc_j, 1e-30)) below
// it — the pivot floor included. Every form here runs it in place on the
// lower triangle of A (n x n, row-major) and gives each entry the same terms
// in the same order, with every product, difference, quotient and square
// root rounded on its own (__fmul_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn: no
// fused multiply-add), so they agree with each other, with chol.cu's warp
// form (n <= 32), with chol_blocked.cu (K6) and with the plain version
// ops/chol_kernel.cholesky_floor bit for bit:
//   factor_cols: right-looking by columns; after column j is final, every
//     entry (i, k) of the trailing lower triangle subtracts L[i, j] L[k, j];
//     two block barriers a column (the reference form; no kernel runs it);
//   factor_panel (K2w, K5 above n = 32): panels of kPanel = 8 columns, a row
//     of the panel a thread in registers, two barriers a column; then the
//     trailing update once a panel, a warp a row, from registers.
// The solves are the TPU kernel's column sweep (_tri_lower) forward, then
// the same sweep on L' (row j of L) back: `solve` one block barrier a
// column (the reference form), `solve_blocked` blocks of kSolveBlock columns, two barriers a
// block (K2w, K5 above n = 32).

#pragma once

#include <cuda_runtime.h>

namespace chol {

constexpr int kNMax = 128;
constexpr int kPanel = 8;            // factor_panel's columns a panel
constexpr int kSolveBlock = 32;      // solve_blocked's columns a block
constexpr int kBlockThreads = 256;   // the block factor_panel and solve_blocked run on
constexpr int kBlockWarps = kBlockThreads / 32;
constexpr float kPivotFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

// a - x y, the product and the difference each rounded on its own
__device__ __forceinline__ float sub_prod(float a, float x, float y) {
  return __fsub_rn(a, __fmul_rn(x, y));
}

// sqrt(max(acc, 1e-30)); the floor lets NaN through, as jnp.maximum and
// torch.clamp do (fmaxf would turn a NaN pivot into the floor)
__device__ __forceinline__ float pivot(float acc) {
  return __fsqrt_rn(acc < kPivotFloor ? kPivotFloor : acc);
}

// The column form, the order every other form reproduces: A (n x n) in
// place, col (n floats) scratch. Every thread of the block calls it; entry on
// a synchronised A.
__device__ __forceinline__ void factor_cols(float* A, float* col, int n) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = T >> 5;
  for (int j = 0; j < n; ++j) {
    const float djj = pivot(A[j * n + j]);
    for (int i = j + tid; i < n; i += T) col[i] = __fdiv_rn(A[i * n + j], djj);
    __syncthreads();
    for (int i = j + tid; i < n; i += T) A[i * n + j] = col[i];
    for (int i = j + 1 + warp; i < n; i += nwarps) {
      const float lij = col[i];
      float* row = A + i * n;
      for (int k = j + 1 + lane; k <= i; k += 32)
        row[k] = sub_prod(row[k], lij, col[k]);
    }
    __syncthreads();
  }
}

// L L' x = b with L the lower triangle of A: v holds b on entry and x on
// exit, y (n floats) is scratch. Every thread calls it; entry and exit
// synchronised.
__device__ __forceinline__ void solve(const float* A, float* v, float* y, int n) {
  const int tid = threadIdx.x, T = blockDim.x;
  // forward: L y = b, column by column
  for (int j = 0; j < n; ++j) {
    const float yj = __fdiv_rn(v[j], A[j * n + j]);
    for (int i = j + 1 + tid; i < n; i += T)
      v[i] = sub_prod(v[i], A[i * n + j], yj);
    if (tid == 0) y[j] = yj;
    __syncthreads();
  }
  // back: L' x = y, column by column of L' (row j of L)
  for (int j = n - 1; j >= 0; --j) {
    const float xj = __fdiv_rn(y[j], A[j * n + j]);
    for (int i = tid; i < j; i += T) y[i] = sub_prod(y[i], A[j * n + i], xj);
    if (tid == 0) v[j] = xj;
    __syncthreads();
  }
}

// K2w's and K5's (n > 32) factorization, on a block of kBlockThreads: A's
// lower triangle (n x n, row-major) in place, with the pivot floor: L[i][j] =
// acc_i / sqrt(max(acc_j, 1e-30)) (NaN passes), factor_cols term for term.
// Thread t holds panel row j0 + t in registers; for column j the pivot and the panel rows' L[k][j] go
// through `panel` (2 kPanel floats of shared memory); then the trailing
// lower triangle subtracts the panel's terms in column order, a warp a row.
// Entry synchronised; exit too.
__device__ __forceinline__ void factor_panel(float* A, float* panel, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j0 = 0; j0 < n; j0 += kPanel) {
    const int w = min(kPanel, n - j0);
    const int i = j0 + tid;  // n - j0 <= 128 < kBlockThreads: one row a thread
    const bool own = i < n;
    float a[kPanel];
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj)
      a[jj] = (own && jj < w && jj <= tid) ? A[i * n + j0 + jj] : 0.f;
    if (tid == 0) panel[0] = a[0];
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj) {
      if (jj < w) {
        // L[i][j] = acc_i / sqrt(max(acc_j, 1e-30)) for i >= j, the diagonal
        // included (the reference's pivot floor, pallas_chol.py _chol_cols);
        // the panel's rows publish theirs for the update
        // rows above the panel's column and past n divide 1, not their zero:
        // a zero operand sends __fdiv_rn down its slow path, and every warp
        // waits for the slowest at the barrier (their quotients go unread)
        const float lij =
            __fdiv_rn((own && jj <= tid) ? a[jj] : 1.f, pivot(panel[jj]));
        if (tid < w) panel[kPanel + tid] = lij;
        __syncthreads();
#pragma unroll
        for (int kk = jj + 1; kk < kPanel; ++kk)
          if (kk < w && kk <= tid) a[kk] = sub_prod(a[kk], lij, panel[kPanel + kk]);
        a[jj] = lij;
        if (jj + 1 < w && tid == jj + 1) panel[jj + 1] = a[jj + 1];  // the next pivot
        __syncthreads();
      }
    }
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj)
      if (own && jj < w && jj <= tid) A[i * n + j0 + jj] = a[jj];
    __syncthreads();
    // the trailing lower triangle: rows i >= j1, columns j1..i; lane l keeps
    // L[k][j0..j1) of its columns k = j1 + l + 32 q
    const int j1 = j0 + w;
    if (j1 < n) {
      float lk[4][kPanel];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = j1 + lane + 32 * q;
#pragma unroll
        for (int jj = 0; jj < kPanel; ++jj)
          lk[q][jj] = (k < n && jj < w) ? A[k * n + j0 + jj] : 0.f;
      }
      for (int r = j1 + warp; r < n; r += kBlockWarps) {
        float li[kPanel];
#pragma unroll
        for (int jj = 0; jj < kPanel; ++jj) li[jj] = jj < w ? A[r * n + j0 + jj] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = j1 + lane + 32 * q;
          if (k <= r) {
            float v = A[r * n + k];
#pragma unroll
            for (int jj = 0; jj < kPanel; ++jj) v = sub_prod(v, li[jj], lk[q][jj]);
            A[r * n + k] = v;
          }
        }
      }
      __syncthreads();
    }
  }
}

// K2w's and K5's (n > 32) solves, on a block of kBlockThreads: L L' x = b
// with L the lower triangle of A; v holds b on entry and x on exit. Forward
// by blocks of kSolveBlock columns from the first, back by blocks from the
// last: warp 0 solves the diagonal block (lane l holds row l
// of it, each solved entry broadcast by a shuffle), then every thread
// subtracts the block from one row outside it — two block barriers a block,
// not one a column. Each entry gets the terms of solve's column sweep, in
// its order (back: the later columns first) and rounded as it rounds
// them (a quotient by L[j][j], then each product and difference on its
// own), so for the same L the two agree bit for bit: in float32 the share
// of N40 lanes whose Mehrotra iteration stalls depends on that order (33 %
// with the back sweep's columns taken in ascending order, 43 % in the
// sweep's, 42 % for the plain version; PERF.md). Entry synchronised; exit
// too.
__device__ __forceinline__ void solve_blocked(const float* A, float* v, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int c0 = 0; c0 < n; c0 += kSolveBlock) {  // L y = b
    const int nb = min(kSolveBlock, n - c0);
    if (warp == 0) {
      const int i = c0 + lane;
      float b = lane < nb ? v[i] : 0.f, y = 0.f;
      for (int j = 0; j < nb; ++j) {
        const float yj = __fdiv_rn(__shfl_sync(kFull, b, j), A[(c0 + j) * n + c0 + j]);
        if (lane == j) y = yj;
        if (lane > j && lane < nb) b = sub_prod(b, A[i * n + c0 + j], yj);
      }
      if (lane < nb) v[i] = y;
    }
    __syncthreads();
    for (int i = c0 + nb + tid; i < n; i += kBlockThreads) {
      const float* row = A + i * n + c0;
      float b = v[i];
      for (int j = 0; j < nb; ++j) b = sub_prod(b, row[j], v[c0 + j]);
      v[i] = b;
    }
    __syncthreads();
  }
  for (int c1 = n; c1 > 0; c1 -= kSolveBlock) {  // L' x = y
    const int c0 = max(0, c1 - kSolveBlock), nb = c1 - c0;
    if (warp == 0) {
      const int i = c0 + lane;
      float b = lane < nb ? v[i] : 0.f, x = 0.f;
      for (int j = nb - 1; j >= 0; --j) {
        const float xj = __fdiv_rn(__shfl_sync(kFull, b, j), A[(c0 + j) * n + c0 + j]);
        if (lane == j) x = xj;
        if (lane < j) b = sub_prod(b, A[(c0 + j) * n + i], xj);
      }
      if (lane < nb) v[i] = x;
    }
    __syncthreads();
    for (int i = tid; i < c0; i += kBlockThreads) {
      float b = v[i];
      for (int j = nb - 1; j >= 0; --j) b = sub_prod(b, A[(c0 + j) * n + i], v[c0 + j]);
      v[i] = b;
    }
    __syncthreads();
  }
}

}  // namespace chol
