// mehrotra_wide.cuh — K2's Mehrotra loop for one lane on one 256-thread
// block, at 32 < nz <= 128 and mI <= 1024: the body of mehrotra_h_wide.cu
// (K2w).
//
//   min 1/2 x'H x + g'x  s.t.  G x <= h   (G shared by the batch)
//
// The iteration is mehrotra_body.cuh's (K2's), with its constants and its
// order of steps: d = min(z / max(s, 1e-25), d_cap), M = G' diag(d) G + H +
// 1e-6 I, symmetric Jacobi equilibration, Cholesky with the pivot floor, two
// triangular solves each for the predictor and the corrector, sigma =
// (mu_aff / max(mu, 1e-25))^3, ratio tests with the 1e6 sentinel, step
// fraction tau. What changes is where the data lives, because K2's layout
// stops at nz = 32:
// - G (mI x nz) does not fit a block's shared memory at the DMS flagship's
//   shape (1024 x 101 floats = 414 KB), so it stays in device memory, where
//   every block of the batch reads the same copy out of the L2 cache.
//   G x and G'v read it coalesced (a warp per row for G x; a thread per
//   column and row partition for G'v, kParts partitions added at the end),
//   and the assembly streams it through shared memory kChunk rows at a time.
// - The assembly of G' diag(d) G gives each of the block's 16 x 16 threads
//   an up-to-8 x 8 register tile of M (rows ty + 16a, columns tx + 16b), so a
//   staged row costs 16 shared loads for 64 multiply-adds. Each chunk's tile
//   is added into M in shared memory, so every entry sums mI / kChunk
//   partial sums of kChunk rows rather than one running sum of mI rows. The
//   tile covers the whole square; only the lower triangle is kept.
// - M is equilibrated and factored in place (H, M: 2 nz^2 floats, 81.6 KB at
//   nz=101, two blocks an SM), by chol_body.cuh's block-wide slab-blocked
//   factorization and column-sweep solves — K6's device code.
// One thread per constraint row keeps that row's s, z, d, rp and the
// predictor/corrector terms in registers (mehrotra_body.cuh's kRowsPerThread
// rows); step lengths and mu are K2's block reductions.
// The kernels that include this file (K2w, K3w) are built with -fmad=false
// (ops/_cuda.py), so the compiler fuses no multiply-add on its own, and
// fuses them alike in both; the dot products and the assembly's register
// tiles accumulate with explicit fused multiply-adds (__fmaf_rn).

#pragma once

#include <cuda_runtime.h>

#include "chol_body.cuh"
#include "mehrotra_body.cuh"

namespace mehrotra_wide {

using mehrotra::kBig;
using mehrotra::kMaxRows;
using mehrotra::kRidge;
using mehrotra::kRowsPerThread;
using mehrotra::kThreads;
using mehrotra::kWarps;

constexpr int kNzMin = mehrotra::kNzMax + 1;    // K2 takes nz <= 32
constexpr int kNzMax = 128;
constexpr int kChunk = 32;                      // G rows staged per assembly pass
constexpr int kTile = 16;                       // 16 x 16 threads over M
constexpr int kParts = 8;                       // row partitions of G'v

struct Shared {
  float* H;     // nz * nz
  float* A;     // nz * nz: M, equilibrated, factored in place into L
  float* Gc;    // kChunk * nz: the staged rows of G
  float* va;    // mI: z, then the KKT's t, then G x / G dx
  float* vb;    // mI: d
  float* part;  // kParts * nz: partial column sums of G'v
  float* x;     // kNzMax each from here on
  float* dx;
  float* rd;
  float* gt;
  float* sc;
  float* g;
  float* v;
  float* y;
  float* red;   // 2 * kWarps + 2
};

__host__ __device__ constexpr size_t shared_floats(int mI, int nz) {
  return 2 * (size_t)nz * nz + (size_t)kChunk * nz + 2 * (size_t)mI + (size_t)kParts * nz
         + 8 * kNzMax + 2 * kWarps + 2;
}

__device__ __forceinline__ Shared carve(float* smem, int mI, int nz) {
  Shared sh;
  sh.H = smem;
  sh.A = sh.H + nz * nz;
  sh.Gc = sh.A + nz * nz;
  sh.va = sh.Gc + kChunk * nz;
  sh.vb = sh.va + mI;
  sh.part = sh.vb + mI;
  sh.x = sh.part + kParts * nz;
  sh.dx = sh.x + kNzMax;
  sh.rd = sh.dx + kNzMax;
  sh.gt = sh.rd + kNzMax;
  sh.sc = sh.gt + kNzMax;
  sh.g = sh.sc + kNzMax;
  sh.v = sh.g + kNzMax;
  sh.y = sh.v + kNzMax;
  sh.red = sh.y + kNzMax;
  return sh;
}

// out[r] = sum_c G[r][c] vec[c] for every row: warp w takes rows w, w + 8,
// ..., its lanes across the row's columns. Entry synchronised; exit too.
__device__ __forceinline__ void g_times(const float* __restrict__ G, const float* vec,
                                        float* out, int mI, int nz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll 4
  for (int r = warp; r < mI; r += kWarps) {
    const float* row = G + (size_t)r * nz;
    float a = 0.f;
    for (int c = lane; c < nz; c += 32) a = __fmaf_rn(row[c], vec[c], a);
    a = mehrotra::warp_sum(a);
    if (lane == 0) out[r] = a;
  }
  __syncthreads();
}

// out[c] = sum_r G[r][c] v[r]: kParts row partitions, the pair p * nz + c
// (threads striding over the pairs) summing rows p, p + kParts, ...; the
// partials are added in p order. Entry synchronised; exit too.
__device__ __forceinline__ void gt_times(const Shared& sh, const float* __restrict__ G,
                                         const float* v, float* out, int mI, int nz) {
  const int tid = threadIdx.x;
  for (int q = tid; q < kParts * nz; q += kThreads) {
    const int c = q % nz, p = q / nz;
    float a = 0.f;
#pragma unroll 8
    for (int r = p; r < mI; r += kParts) a = __fmaf_rn(G[(size_t)r * nz + c], v[r], a);
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

// A's lower triangle = G' diag(d) G + H + 1e-6 I, d in sh.vb; kT = the
// register tile's side (16 kT >= nz). Entry synchronised; exit too.
template <int kT>
__device__ __forceinline__ void assemble(const Shared& sh, const float* __restrict__ G,
                                         int mI, int nz) {
  const int tid = threadIdx.x;
  const int ty = tid / kTile, tx = tid % kTile;
  for (int r0 = 0; r0 < mI; r0 += kChunk) {
    const int rows = min(kChunk, mI - r0);
    __syncthreads();  // the previous chunk is consumed
    for (int e = tid; e < rows * nz; e += kThreads) sh.Gc[e] = G[(size_t)r0 * nz + e];
    __syncthreads();
    float acc[kT][kT];
#pragma unroll
    for (int a = 0; a < kT; ++a)
#pragma unroll
      for (int b = 0; b < kT; ++b) acc[a][b] = 0.f;
    for (int rr = 0; rr < rows; ++rr) {
      const float* gr = sh.Gc + rr * nz;
      const float dr = sh.vb[r0 + rr];
      float gi[kT], gj[kT];
#pragma unroll
      for (int a = 0; a < kT; ++a) {
        const int i = ty + kTile * a, j = tx + kTile * a;
        gi[a] = i < nz ? gr[i] : 0.f;
        gj[a] = j < nz ? dr * gr[j] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < kT; ++a)
#pragma unroll
        for (int b = 0; b < kT; ++b) acc[a][b] = __fmaf_rn(gi[a], gj[b], acc[a][b]);
    }
    // this chunk's partial sums into M (each thread owns its tile's entries)
#pragma unroll
    for (int a = 0; a < kT; ++a) {
#pragma unroll
      for (int b = 0; b < kT; ++b) {
        const int i = ty + kTile * a, j = tx + kTile * b;
        if (i < nz && j <= i) sh.A[i * nz + j] = r0 == 0 ? acc[a][b] : sh.A[i * nz + j] + acc[a][b];
      }
    }
  }
  __syncthreads();  // every tile's last partial is in
  for (int e = tid; e < nz * nz; e += kThreads) {
    const int i = e / nz, j = e - i * nz;
    if (j <= i) sh.A[e] = sh.A[e] + sh.H[e] + (i == j ? kRidge : 0.f);
  }
  __syncthreads();
}

// One KKT solve for the complementarity right-hand side rc:
// dx = sc * L^-T L^-1 (-(rd + G' t) * sc), t = d rp - rc / s_safe, then
// dz = d (rp + G dx) - rc / s_safe and ds = -rp - G dx per row (K2's kkt).
__device__ __forceinline__ void kkt(const Shared& sh, const float* __restrict__ G, int mI,
                                    int nz, const float (&d)[kRowsPerThread],
                                    const float (&rp)[kRowsPerThread],
                                    const float (&ss)[kRowsPerThread],
                                    const float (&rc)[kRowsPerThread],
                                    float (&ds)[kRowsPerThread], float (&dz)[kRowsPerThread]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = tid + t * kThreads;
    if (r < mI) sh.va[r] = d[t] * rp[t] - rc[t] / ss[t];
  }
  __syncthreads();
  gt_times(sh, G, sh.va, sh.gt, mI, nz);
  if (tid < nz) sh.v[tid] = -(sh.rd[tid] + sh.gt[tid]) * sh.sc[tid];
  __syncthreads();
  chol::solve(sh.A, sh.v, sh.y, nz);
  if (tid < nz) sh.dx[tid] = sh.v[tid] * sh.sc[tid];
  __syncthreads();
  g_times(G, sh.dx, sh.va, mI, nz);
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = tid + t * kThreads;
    if (r < mI) {
      const float gdx = sh.va[r];
      dz[t] = d[t] * (rp[t] + gdx) - rc[t] / ss[t];
      ds[t] = -rp[t] - gdx;
    }
  }
}

// The iteration loop. On entry the caller has staged H (nz x nz, row-major;
// M reads its lower triangle) and g in shared memory, set sh.x to 0, put each
// row's s, z and h in the thread's registers, and synchronised. On exit sh.x
// holds the solution and s, z the final interior.
template <int kT>
__device__ __forceinline__ void solve(const Shared& sh, const float* __restrict__ G, int mI,
                                      int nz, int iters, float tau, float d_cap,
                                      float (&s)[kRowsPerThread], float (&z)[kRowsPerThread],
                                      const float (&hr)[kRowsPerThread]) {
  const int tid = threadIdx.x;
  const float inv_m = 1.f / (float)mI;
  for (int it = 0; it < iters; ++it) {
    g_times(G, sh.x, sh.va, mI, nz);  // G x
    float rp[kRowsPerThread], ss[kRowsPerThread], d[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      rp[t] = ss[t] = d[t] = 0.f;
      if (r < mI) {
        rp[t] = sh.va[r] + s[t] - hr[t];
        ss[t] = fmaxf(s[t], 1e-25f);
        d[t] = fminf(z[t] / ss[t], d_cap);
        sh.va[r] = z[t];
        sh.vb[r] = d[t];
      }
    }
    __syncthreads();
    gt_times(sh, G, sh.va, sh.gt, mI, nz);  // G'z
    if (tid < nz) {
      float hx = 0.f;
      for (int j = 0; j < nz; ++j) hx = __fmaf_rn(sh.H[tid * nz + j], sh.x[j], hx);
      sh.rd[tid] = hx + sh.g[tid] + sh.gt[tid];
    }
    assemble<kT>(sh, G, mI, nz);
    if (tid < nz) sh.sc[tid] = 1.f / sqrtf(fmaxf(sh.A[tid * nz + tid], 1e-30f));
    __syncthreads();
    for (int e = tid; e < nz * nz; e += kThreads) {
      const int i = e / nz, j = e - i * nz;
      if (j <= i) sh.A[e] = sh.A[e] * sh.sc[i] * sh.sc[j];
    }
    __syncthreads();
    chol::factor_blocked(sh.A, nz);

    // predictor
    float mu_part = 0.f, rc[kRowsPerThread], dsa[kRowsPerThread], dza[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      rc[t] = s[t] * z[t];
      dsa[t] = dza[t] = 0.f;
      if (r < mI) mu_part += rc[t];
    }
    kkt(sh, G, mI, nz, d, rp, ss, rc, dsa, dza);
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
    kkt(sh, G, mI, nz, d, rp, ss, rc, ds, dz);
    const float2 rs = mehrotra::ratio_min(mI, s, ds, z, dz, kBig, sh.red);
    const float ap = fminf(1.f, tau * rs.x), ad = fminf(1.f, tau * rs.y);
    if (tid < nz) sh.x[tid] += ap * sh.dx[tid];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      s[t] += ap * ds[t];
      z[t] += ad * dz[t];
    }
    __syncthreads();
  }
}

}  // namespace mehrotra_wide
