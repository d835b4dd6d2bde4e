// mehrotra_body.cuh — a fixed-iteration Mehrotra predictor-corrector loop
// for one lane on one 256-thread block: K4's (mehrotra.cu). K2 and K3 ran it
// too before they moved to one warp a lane (mehrotra_warp.cuh, which keeps
// this loop's order of operations); its phase clocks measured that split.
//
//   min 1/2 x'H x + g'x  s.t.  G x <= h   (G shared by the batch)
//
// by `iters` iterations: d = min(z / max(s, 1e-25), d_cap),
// M = G' diag(d) G + H + 1e-6 I, optionally symmetric Jacobi equilibration
// (scale = 1/sqrt(max(diag M, 1e-30)); K4 has none), Cholesky with the pivot
// floor sqrt(max(., 1e-30)), two triangular solves each for the predictor
// and the corrector, sigma = (mu_aff / max(mu, 1e-25))^3, ratio tests with
// the 1e6 sentinel, step fraction tau, and mu divided by the full row count.
// Rows >= mI are simply not there, with one exception: K4's reference pads
// mI to a multiple of 128 with rows G = 0, h = 1e6, s = 1e6, z = 1. Such a
// row keeps rp = ds = 0 and takes part only in the dual ratio tests, and
// all of them stay equal, so K4 carries them as one virtual row (z_pad).
//
// Layout: G (mI x nz) and H are staged once per block in shared memory. One
// thread per constraint row keeps that row's s, z, d, rp and the
// predictor/corrector terms in registers (up to 4 rows per thread for
// mI <= 1024). The assembly gives each thread whole entries of M (a dot
// product over the rows), so no atomics are needed; G'v products split the
// rows over the block's 8 warps and add the 8 partials. The nz x nz
// factorization and the solves run on one warp with a lane per row. Step
// lengths are block min-reductions and mu a block sum.

#pragma once

#include <cuda_runtime.h>

namespace mehrotra {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;                 // mI <= 1024
constexpr int kMaxRows = kThreads * kRowsPerThread;
constexpr int kNzMax = 32;                        // the factorization is one warp
constexpr int kPairsPerThread = (kNzMax * (kNzMax + 1) / 2 + kThreads - 1) / kThreads;
constexpr float kBig = 1e6f;                      // ratio-test sentinel
constexpr float kRidge = 1e-6f;
constexpr float kPadH = 1e6f;                     // K4's padded rows: h = s = 1e6
constexpr unsigned kFull = 0xffffffffu;

struct Shared {
  float* G;     // mI * nz
  float* H;     // nz * nz
  float* M;     // nz * nz
  float* L;     // nz * nz
  float* vrow;  // mI
  float* part;  // kWarps * 32
  float* x;     // 32
  float* dx;    // 32
  float* rd;    // 32
  float* gt;    // 32
  float* sc;    // 32
  float* g;     // 32
  float* red;   // 2 * kWarps + 2
};

__host__ __device__ constexpr size_t shared_floats(int mI, int nz) {
  return (size_t)mI * nz + 3 * nz * nz + mI + kWarps * 32 + 6 * 32 + 2 * kWarps + 2;
}

__device__ __forceinline__ Shared carve(float* smem, int mI, int nz) {
  Shared sh;
  sh.G = smem;
  sh.H = sh.G + mI * nz;
  sh.M = sh.H + nz * nz;
  sh.L = sh.M + nz * nz;
  sh.vrow = sh.L + nz * nz;
  sh.part = sh.vrow + mI;
  sh.x = sh.part + kWarps * 32;
  sh.dx = sh.x + 32;
  sh.rd = sh.dx + 32;
  sh.gt = sh.rd + 32;
  sh.sc = sh.gt + 32;
  sh.g = sh.sc + 32;
  sh.red = sh.g + 32;
  return sh;
}

// Phase clocks, for tools/k2_split.py only: built with K2_PHASE_CLOCKS,
// thread 0 of each block adds the clock64() cycles of every phase of every
// iteration into kClockSlots counters (each stamp is a block barrier in that
// build, so thread 0's clock is the block's, and the block is one lane) and
// solve() stores them in k2_clocks[lane * kClockSlots + phase]. The
// package's build never defines the macro, and then PhaseClock is empty.
enum ClockPhase { kClkGx, kClkGtz, kClkAssemble, kClkEquil, kClkFactor, kClkGtv, kClkSweep,
                  kClkGdx, kClkReduce, kClkTotal, kClockSlots };
#ifdef K2_PHASE_CLOCKS
constexpr int kClockLanes = 16384;
__device__ unsigned long long k2_clocks[kClockLanes * kClockSlots];
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
    if (threadIdx.x == 0 && blockIdx.x < kClockLanes) {
      acc[kClkTotal] = clock64() - first;
#pragma unroll
      for (int p = 0; p < kClockSlots; ++p) k2_clocks[blockIdx.x * kClockSlots + p] = acc[p];
    }
  }
};
// `<source>_clocks(out, lanes)`: the first `lanes` lanes' counters of the
// last launch, copied to the host array `out`
#define K2_CLOCKS_EXPORT(source)                                                         \
  extern "C" int source##_clocks(unsigned long long* out, int lanes) {                   \
    return (int)cudaMemcpyFromSymbol(                                                    \
        out, mehrotra::k2_clocks,                                                        \
        (size_t)lanes * mehrotra::kClockSlots * sizeof(unsigned long long));             \
  }
#else
#define K2_CLOCKS_EXPORT(source)
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void store() {}
};
#endif

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Block-wide (sum, sum) or (min, min) of two values; every thread gets both.
template <bool kMin>
__device__ __forceinline__ float2 block_reduce2(float a, float b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = kMin ? warp_min(a) : warp_sum(a);
  b = kMin ? warp_min(b) : warp_sum(b);
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const float ident = kMin ? kBig : 0.f;
    a = lane < kWarps ? red[2 * lane] : ident;
    b = lane < kWarps ? red[2 * lane + 1] : ident;
    a = kMin ? warp_min(a) : warp_sum(a);
    b = kMin ? warp_min(b) : warp_sum(b);
    if (lane == 0) {
      red[2 * kWarps] = a;
      red[2 * kWarps + 1] = b;
    }
  }
  __syncthreads();
  return make_float2(red[2 * kWarps], red[2 * kWarps + 1]);
}

// out[c] = sum_r G[r][c] * v[r]: warp w sums rows w, w + 8, ...; the 8
// partials are added by the first nz threads.
__device__ __forceinline__ void col_reduce(const Shared& sh, const float* v, float* out,
                                           int mI, int nz) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < nz) {
    float a = 0.f;
    for (int r = warp; r < mI; r += kWarps) a += sh.G[r * nz + lane] * v[r];
    sh.part[warp * 32 + lane] = a;
  }
  __syncthreads();
  if (threadIdx.x < nz) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sh.part[w * 32 + threadIdx.x];
    out[threadIdx.x] = a;
  }
  __syncthreads();
}

// Row r of G x.
__device__ __forceinline__ float row_dot(const Shared& sh, int r, int nz, const float* x) {
  float a = 0.f;
  for (int cc = 0; cc < nz; ++cc) a += sh.G[r * nz + cc] * x[cc];
  return a;
}

// One KKT solve for the complementarity right-hand side rc:
// dx = sc * L^-T L^-1 (-(rd + G' t) * sc), t = d rp - rc / s_safe, then
// dz = d (rp + G dx) - rc / s_safe and ds = -rp - G dx per row.
__device__ __forceinline__ void kkt(const Shared& sh, int mI, int nz,
                                    const float (&d)[kRowsPerThread],
                                    const float (&rp)[kRowsPerThread],
                                    const float (&ss)[kRowsPerThread],
                                    const float (&rc)[kRowsPerThread],
                                    float (&ds)[kRowsPerThread],
                                    float (&dz)[kRowsPerThread], PhaseClock& clk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = threadIdx.x + t * kThreads;
    if (r < mI) sh.vrow[r] = d[t] * rp[t] - rc[t] / ss[t];
  }
  __syncthreads();
  col_reduce(sh, sh.vrow, sh.gt, mI, nz);
  clk.mark(kClkGtv);
  if (warp == 0) {
    float b = lane < nz ? -(sh.rd[lane] + sh.gt[lane]) * sh.sc[lane] : 0.f;
    float y = 0.f;
    for (int j = 0; j < nz; ++j) {  // L y = b
      const float yj = __shfl_sync(kFull, b, j) / sh.L[j * nz + j];
      if (lane == j) y = yj;
      if (lane > j && lane < nz) b -= sh.L[lane * nz + j] * yj;
    }
    float u = 0.f;
    for (int j = nz - 1; j >= 0; --j) {  // L' u = y
      const float uj = __shfl_sync(kFull, y, j) / sh.L[j * nz + j];
      if (lane == j) u = uj;
      if (lane < j) y -= sh.L[j * nz + lane] * uj;
    }
    if (lane < nz) sh.dx[lane] = u * sh.sc[lane];
  }
  __syncthreads();
  clk.mark(kClkSweep);
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = threadIdx.x + t * kThreads;
    if (r < mI) {
      const float gdx = row_dot(sh, r, nz, sh.dx);
      dz[t] = d[t] * (rp[t] + gdx) - rc[t] / ss[t];
      ds[t] = -rp[t] - gdx;
    }
  }
  clk.mark(kClkGdx);
}

// Block min over the rows of the step ratio (-v / dv where dv < 0, else BIG)
// for the primal (s, ds) and dual (z, dz) pairs; `rz_extra` enters the dual
// minimum (the virtual padded row's ratio, or BIG).
__device__ __forceinline__ float2 ratio_min(int mI, const float (&s)[kRowsPerThread],
                                            const float (&ds)[kRowsPerThread],
                                            const float (&z)[kRowsPerThread],
                                            const float (&dz)[kRowsPerThread],
                                            float rz_extra, float* red) {
  float rs = kBig, rz = rz_extra;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = threadIdx.x + t * kThreads;
    if (r < mI) {
      rs = fminf(rs, ds[t] < 0.f ? -s[t] / ds[t] : kBig);
      rz = fminf(rz, dz[t] < 0.f ? -z[t] / dz[t] : kBig);
    }
  }
  return block_reduce2<true>(rs, rz, red);
}

// mu = sum_r s_r z_r / mI (block sum, every thread gets it).
__device__ __forceinline__ float block_mu(int mI, const float (&s)[kRowsPerThread],
                                          const float (&z)[kRowsPerThread], float* red) {
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    if (threadIdx.x + t * kThreads < mI) part += s[t] * z[t];
  }
  return block_reduce2<false>(part, 0.f, red).x * (1.f / (float)mI);
}

// The virtual padded row's dual step: dz = d (rp + G dx) - rc / s with
// rp = G dx = 0 and s = 1e6; its ratio -z / dz where dz < 0, else BIG.
__device__ __forceinline__ float pad_dz(float rc) { return -(rc / kPadH); }
__device__ __forceinline__ float pad_ratio(float z, float dz) {
  return dz < 0.f ? -z / dz : kBig;
}

// The iteration loop. On entry the caller has staged G, H (nz x nz,
// row-major; M reads its lower triangle) and g in shared memory, set sh.x
// to 0, put each row's s, z and h in the thread's registers, and
// synchronised. kPad carries K4's padded rows as one virtual row (every
// thread keeps its z, thread 0 enters its ratio). On exit sh.x holds the
// solution and s, z the final interior.
template <bool kEquilibrate, bool kPad>
__device__ __forceinline__ void solve(const Shared& sh, int mI, int nz, int iters, float tau,
                                      float d_cap, float (&s)[kRowsPerThread],
                                      float (&z)[kRowsPerThread],
                                      const float (&hr)[kRowsPerThread]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool pad_here = kPad && tid == 0;
  float z_pad = 1.f;

  // this thread's unique M entries (i <= j)
  const int npairs = nz * (nz + 1) / 2;
  int pi[kPairsPerThread], pj[kPairsPerThread];
#pragma unroll
  for (int p = 0; p < kPairsPerThread; ++p) {
    int q = tid + kThreads * p, i = -1, j = -1;
    if (q < npairs) {
      i = 0;
      while (q >= nz - i) { q -= nz - i; ++i; }
      j = i + q;
    }
    pi[p] = i;
    pj[p] = j;
  }

  const float inv_m = 1.f / (float)mI;
  PhaseClock clk;
  clk.start();
  for (int it = 0; it < iters; ++it) {
    float rp[kRowsPerThread], ss[kRowsPerThread], d[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      rp[t] = ss[t] = d[t] = 0.f;
      if (r < mI) {
        rp[t] = row_dot(sh, r, nz, sh.x) + s[t] - hr[t];
        ss[t] = fmaxf(s[t], 1e-25f);
        d[t] = fminf(z[t] / ss[t], d_cap);
        sh.vrow[r] = z[t];
      }
    }
    __syncthreads();
    clk.mark(kClkGx);
    col_reduce(sh, sh.vrow, sh.gt, mI, nz);  // G'z
    if (tid < nz) {
      float hx = 0.f;
      for (int j = 0; j < nz; ++j) hx += sh.H[tid * nz + j] * sh.x[j];
      sh.rd[tid] = hx + sh.g[tid] + sh.gt[tid];
    }
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      if (r < mI) sh.vrow[r] = d[t];
    }
    __syncthreads();
    clk.mark(kClkGtz);

    // M = G' diag(d) G + H + 1e-6 I (lower triangle of H)
#pragma unroll
    for (int p = 0; p < kPairsPerThread; ++p) {
      if (pi[p] >= 0) {
        const int i = pi[p], j = pj[p];
        float a = 0.f;
        for (int r = 0; r < mI; ++r) a += sh.G[r * nz + i] * (sh.vrow[r] * sh.G[r * nz + j]);
        const float v = a + sh.H[j * nz + i] + (i == j ? kRidge : 0.f);
        sh.M[i * nz + j] = v;
        sh.M[j * nz + i] = v;
      }
    }
    __syncthreads();
    clk.mark(kClkAssemble);
    if (tid < nz)
      sh.sc[tid] = kEquilibrate ? 1.f / sqrtf(fmaxf(sh.M[tid * nz + tid], 1e-30f)) : 1.f;
    __syncthreads();
    clk.mark(kClkEquil);

    // left-looking Cholesky of the (equilibrated) M, lane r = row r
    if (warp == 0) {
      for (int j = 0; j < nz; ++j) {
        float acc = 0.f;
        if (lane < nz) {
          acc = kEquilibrate ? sh.M[lane * nz + j] * sh.sc[lane] * sh.sc[j]
                             : sh.M[lane * nz + j];
          for (int k = 0; k < j; ++k) acc -= sh.L[j * nz + k] * sh.L[lane * nz + k];
        }
        const float djj = sqrtf(fmaxf(__shfl_sync(kFull, acc, j), 1e-30f));
        if (lane < nz) sh.L[lane * nz + j] = lane >= j ? acc / djj : 0.f;
        __syncwarp();
      }
    }
    __syncthreads();
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
    kkt(sh, mI, nz, d, rp, ss, rc, dsa, dza, clk);
    const float dza_pad = pad_dz(kPadH * z_pad);
    const float mu = block_reduce2<false>(mu_part, 0.f, sh.red).x * inv_m;
    const float2 ra = ratio_min(mI, s, dsa, z, dza,
                                pad_here ? pad_ratio(z_pad, dza_pad) : kBig, sh.red);
    const float ap_a = fminf(1.f, 1.f * ra.x), ad_a = fminf(1.f, 1.f * ra.y);
    float aff_part = 0.f;
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      if (r < mI) aff_part += (s[t] + ap_a * dsa[t]) * (z[t] + ad_a * dza[t]);
    }
    const float mu_aff = block_reduce2<false>(aff_part, 0.f, sh.red).x * inv_m;
    const float sr = mu_aff / fmaxf(mu, 1e-25f);
    const float sigma = sr * sr * sr;

    // corrector
    float ds[kRowsPerThread], dz[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      rc[t] = s[t] * z[t] + dsa[t] * dza[t] - sigma * mu;
      ds[t] = dz[t] = 0.f;
    }
    kkt(sh, mI, nz, d, rp, ss, rc, ds, dz, clk);
    const float dz_pad = pad_dz(kPadH * z_pad - sigma * mu);
    const float2 rs = ratio_min(mI, s, ds, z, dz,
                                pad_here ? pad_ratio(z_pad, dz_pad) : kBig, sh.red);
    const float ap = fminf(1.f, tau * rs.x), ad = fminf(1.f, tau * rs.y);
    if (tid < nz) sh.x[tid] += ap * sh.dx[tid];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      s[t] += ap * ds[t];
      z[t] += ad * dz[t];
    }
    if (kPad) z_pad += ad * dz_pad;
    __syncthreads();
    clk.mark(kClkReduce);
  }
  clk.store();
}

}  // namespace mehrotra
