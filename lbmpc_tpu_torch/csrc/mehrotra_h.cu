// mehrotra_h.cu — a fixed-iteration Mehrotra predictor-corrector QP with a
// Hessian per lane, one thread block per lane.
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_ipm.py,
// build_pallas_qp_solver_h -> kernel/_kernel_body: for each lane,
//   min 1/2 x'H_b x + g_b'x  s.t.  G x <= h_b   (G shared by the batch)
// by `iters` Mehrotra iterations: d = min(z / max(s, 1e-25), d_cap),
// M = G' diag(d) G + H_b + 1e-6 I, symmetric Jacobi equilibration
// (scale = 1/sqrt(max(diag M, 1e-30))), Cholesky with the pivot floor
// sqrt(max(., 1e-30)), two triangular solves each for the predictor and the
// corrector, sigma = (mu_aff / max(mu, 1e-25))^3, ratio tests with the 1e6
// sentinel, step fraction tau, and mu divided by the full row count mI.
// Start: cold s = max(h, 1), z = 1; or warm s = max(s0, eps), z = max(z0, eps)
// (the (B, mI) warm state is in G's row order). There are no padded rows or
// lanes: rows >= mI and lanes >= B are simply not there.
//
// What bounds it on an H100: operations. Each iteration assembles the
// nz(nz+1)/2 unique entries of G' diag(d) G over all mI rows (about
// nz^2 * mI multiply-adds per lane) — the float32 work dwarfs the bytes moved
// (H, g, h in; x, mu, s, z out).
//
// Design: G (mI x nz) is staged once per block in shared memory and every
// iteration reads it from there. One thread per constraint row keeps that
// row's s, z, d, rp and the predictor/corrector terms in registers (up to 4
// rows per thread for mI <= 1024). The assembly gives each thread whole
// entries of M (a dot product over the rows), so no atomics are needed;
// G'v products split the rows over the block's 8 warps and add the 8
// partials. The 21 x 21 factorization and the solves run on one warp with a
// lane per row. Step lengths are block min-reductions and mu a block sum.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;                 // mI <= 1024
constexpr int kNzMax = 32;                        // the factorization is one warp
constexpr int kPairsPerThread = (kNzMax * (kNzMax + 1) / 2 + kThreads - 1) / kThreads;
constexpr float kBig = 1e6f;                      // ratio-test sentinel
constexpr float kRidge = 1e-6f;
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

// One KKT solve for the complementarity right-hand side rc:
// dx = sc * L^-T L^-1 (-(rd + G' t) * sc), t = d rp - rc / s_safe, then
// dz = d (rp + G dx) - rc / s_safe and ds = -rp - G dx per row.
__device__ __forceinline__ void kkt(const Shared& sh, int mI, int nz,
                                    const float (&d)[kRowsPerThread],
                                    const float (&rp)[kRowsPerThread],
                                    const float (&ss)[kRowsPerThread],
                                    const float (&rc)[kRowsPerThread],
                                    float (&ds)[kRowsPerThread],
                                    float (&dz)[kRowsPerThread]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = threadIdx.x + t * kThreads;
    if (r < mI) sh.vrow[r] = d[t] * rp[t] - rc[t] / ss[t];
  }
  __syncthreads();
  col_reduce(sh, sh.vrow, sh.gt, mI, nz);
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
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = threadIdx.x + t * kThreads;
    if (r < mI) {
      float gdx = 0.f;
      for (int cc = 0; cc < nz; ++cc) gdx += sh.G[r * nz + cc] * sh.dx[cc];
      dz[t] = d[t] * (rp[t] + gdx) - rc[t] / ss[t];
      ds[t] = -rp[t] - gdx;
    }
  }
}

// Block min over the rows of the step ratio (-v / dv where dv < 0, else BIG)
// for the primal (s, ds) and dual (z, dz) pairs.
__device__ __forceinline__ float2 ratio_min(int mI, const float (&s)[kRowsPerThread],
                                            const float (&ds)[kRowsPerThread],
                                            const float (&z)[kRowsPerThread],
                                            const float (&dz)[kRowsPerThread],
                                            float* red) {
  float rs = kBig, rz = kBig;
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

__global__ void __launch_bounds__(kThreads)
mehrotra_h_kernel(const float* __restrict__ G, const float* __restrict__ H,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const float* __restrict__ s0, const float* __restrict__ z0,
                  float* __restrict__ x_out, float* __restrict__ mu_out,
                  float* __restrict__ s_out, float* __restrict__ z_out,
                  int mI, int nz, int iters, float tau, float d_cap, float warm_eps) {
  extern __shared__ float smem[];
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

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  for (int i = tid; i < mI * nz; i += kThreads) sh.G[i] = G[i];
  for (int i = tid; i < nz * nz; i += kThreads) sh.H[i] = H[b * nz * nz + i];
  if (tid < nz) {
    sh.g[tid] = g[b * nz + tid];
    sh.x[tid] = 0.f;
  }

  // this thread's unique M entries (i <= j)
  const int npairs = nz * (nz + 1) / 2;
  int pi[kPairsPerThread], pj[kPairsPerThread];
#pragma unroll
  for (int s = 0; s < kPairsPerThread; ++s) {
    int p = tid + kThreads * s, i = -1, j = -1;
    if (p < npairs) {
      i = 0;
      while (p >= nz - i) { p -= nz - i; ++i; }
      j = i + p;
    }
    pi[s] = i;
    pj[s] = j;
  }

  float s[kRowsPerThread], z[kRowsPerThread], hr[kRowsPerThread];
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = tid + t * kThreads;
    s[t] = z[t] = hr[t] = 0.f;
    if (r < mI) {
      hr[t] = h[b * mI + r];
      if (s0 != nullptr) {
        s[t] = fmaxf(s0[b * mI + r], warm_eps);
        z[t] = fmaxf(z0[b * mI + r], warm_eps);
      } else {
        s[t] = fmaxf(hr[t], 1.f);
        z[t] = 1.f;
      }
    }
  }
  __syncthreads();

  const float inv_m = 1.f / (float)mI;
  for (int it = 0; it < iters; ++it) {
    float rp[kRowsPerThread], ss[kRowsPerThread], d[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      rp[t] = ss[t] = d[t] = 0.f;
      if (r < mI) {
        float gx = 0.f;
        for (int cc = 0; cc < nz; ++cc) gx += sh.G[r * nz + cc] * sh.x[cc];
        rp[t] = gx + s[t] - hr[t];
        ss[t] = fmaxf(s[t], 1e-25f);
        d[t] = fminf(z[t] / ss[t], d_cap);
        sh.vrow[r] = z[t];
      }
    }
    __syncthreads();
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
    if (tid < nz) sh.sc[tid] = 1.f / sqrtf(fmaxf(sh.M[tid * nz + tid], 1e-30f));
    __syncthreads();

    // left-looking Cholesky of the equilibrated M, lane r = row r
    if (warp == 0) {
      for (int j = 0; j < nz; ++j) {
        float acc = 0.f;
        if (lane < nz) {
          acc = sh.M[lane * nz + j] * sh.sc[lane] * sh.sc[j];
          for (int k = 0; k < j; ++k) acc -= sh.L[j * nz + k] * sh.L[lane * nz + k];
        }
        const float djj = sqrtf(fmaxf(__shfl_sync(kFull, acc, j), 1e-30f));
        if (lane < nz) sh.L[lane * nz + j] = lane >= j ? acc / djj : 0.f;
        __syncwarp();
      }
    }
    __syncthreads();

    // predictor
    float mu_part = 0.f, rc[kRowsPerThread], dsa[kRowsPerThread], dza[kRowsPerThread];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      rc[t] = s[t] * z[t];
      dsa[t] = dza[t] = 0.f;
      if (r < mI) mu_part += rc[t];
    }
    kkt(sh, mI, nz, d, rp, ss, rc, dsa, dza);
    const float mu = block_reduce2<false>(mu_part, 0.f, sh.red).x * inv_m;
    const float2 ra = ratio_min(mI, s, dsa, z, dza, sh.red);
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
    kkt(sh, mI, nz, d, rp, ss, rc, ds, dz);
    const float2 rs = ratio_min(mI, s, ds, z, dz, sh.red);
    const float ap = fminf(1.f, tau * rs.x), ad = fminf(1.f, tau * rs.y);
    if (tid < nz) sh.x[tid] += ap * sh.dx[tid];
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      s[t] += ap * ds[t];
      z[t] += ad * dz[t];
    }
    __syncthreads();
  }

  float mu_part = 0.f;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = tid + t * kThreads;
    if (r < mI) {
      mu_part += s[t] * z[t];
      if (s_out != nullptr) {
        s_out[b * mI + r] = s[t];
        z_out[b * mI + r] = z[t];
      }
    }
  }
  const float mu = block_reduce2<false>(mu_part, 0.f, sh.red).x * inv_m;
  if (tid == 0) mu_out[b] = mu;
  if (tid < nz) x_out[b * nz + tid] = sh.x[tid];
}

}  // namespace

extern "C" int mehrotra_h_launch(const float* G, const float* H, const float* g,
                                 const float* h, const float* s0, const float* z0,
                                 float* x, float* mu, float* s_out, float* z_out,
                                 int B, int mI, int nz, int iters, float tau,
                                 float d_cap, float warm_eps, void* stream) {
  if (nz < 1 || nz > kNzMax || mI < 1 || mI > kThreads * kRowsPerThread || B < 0 ||
      iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t floats = (size_t)mI * nz + 3 * nz * nz + mI + kWarps * 32 + 6 * 32
                        + 2 * kWarps + 2;
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        mehrotra_h_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  mehrotra_h_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      G, H, g, h, s0, z0, x, mu, s_out, z_out, mI, nz, iters, tau, d_cap, warm_eps);
  return (int)cudaGetLastError();
}

extern "C" const char* mehrotra_h_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
