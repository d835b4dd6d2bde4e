// mehrotra_h.cu — a fixed-iteration Mehrotra predictor-corrector QP with a
// Hessian per lane, one thread block per lane.
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_ipm.py,
// build_pallas_qp_solver_h -> kernel/_kernel_body: for each lane,
//   min 1/2 x'H_b x + g_b'x  s.t.  G x <= h_b   (G shared by the batch)
// by `iters` Mehrotra iterations with d capped at d_cap and Jacobi
// equilibration (mehrotra_body.cuh). Start: cold s = max(h, 1), z = 1; or
// warm s = max(s0, eps), z = max(z0, eps) (the (B, mI) warm state is in G's
// row order).
//
// What bounds it on an H100: operations. Each iteration assembles the
// nz(nz+1)/2 unique entries of G' diag(d) G over all mI rows (about
// nz^2 * mI multiply-adds per lane) — the float32 work dwarfs the bytes moved
// (H, g, h in; x, mu, s, z out). In practice the serial parts — the one-warp
// factorization and triangular sweeps — set the time.
//
// Design: one 256-thread block per lane, G and H_b staged in shared memory,
// one thread per constraint row (mehrotra_body.cuh).

#include <cuda_runtime.h>

#include "mehrotra_body.cuh"

namespace {

using namespace mehrotra;

__global__ void __launch_bounds__(kThreads)
mehrotra_h_kernel(const float* __restrict__ G, const float* __restrict__ H,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const float* __restrict__ s0, const float* __restrict__ z0,
                  float* __restrict__ x_out, float* __restrict__ mu_out,
                  float* __restrict__ s_out, float* __restrict__ z_out,
                  int mI, int nz, int iters, float tau, float d_cap, float warm_eps) {
  extern __shared__ float smem[];
  const Shared sh = carve(smem, mI, nz);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int i = tid; i < mI * nz; i += kThreads) sh.G[i] = G[i];
  for (int i = tid; i < nz * nz; i += kThreads) sh.H[i] = H[b * nz * nz + i];
  if (tid < nz) {
    sh.g[tid] = g[b * nz + tid];
    sh.x[tid] = 0.f;
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

  solve<true, false>(sh, mI, nz, iters, tau, d_cap, s, z, hr);

  const float mu = block_mu(mI, s, z, sh.red);
  if (s_out != nullptr) {
#pragma unroll
    for (int t = 0; t < kRowsPerThread; ++t) {
      const int r = tid + t * kThreads;
      if (r < mI) {
        s_out[b * mI + r] = s[t];
        z_out[b * mI + r] = z[t];
      }
    }
  }
  if (tid == 0) mu_out[b] = mu;
  if (tid < nz) x_out[b * nz + tid] = sh.x[tid];
}

}  // namespace

extern "C" int mehrotra_h_launch(const float* G, const float* H, const float* g,
                                 const float* h, const float* s0, const float* z0,
                                 float* x, float* mu, float* s_out, float* z_out,
                                 int B, int mI, int nz, int iters, float tau,
                                 float d_cap, float warm_eps, void* stream) {
  if (nz < 1 || nz > kNzMax || mI < 1 || mI > kMaxRows || B < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = shared_floats(mI, nz) * sizeof(float);
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
