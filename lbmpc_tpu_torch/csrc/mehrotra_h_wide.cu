// mehrotra_h_wide.cu — a fixed-iteration Mehrotra predictor-corrector QP
// with a Hessian per lane at 32 < nz <= 128, one thread block per lane (K2w).
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_ipm.py,
// build_pallas_qp_solver_h -> kernel/_kernel_body, over the part of its
// domain that mehrotra_h.cu (K2: nz <= 32) does not take — the DMS
// flagship's nz=101, G (1024, 101) and LBMPC_N40's nz=41, G (414, 41). For
// each lane:
//   min 1/2 x'H_b x + g_b'x  s.t.  G x <= h_b   (G shared by the batch)
// by `iters` Mehrotra iterations with d capped at d_cap and Jacobi
// equilibration (mehrotra_wide.cuh: K2's iteration, constants and order of
// steps). Start: cold s = max(h, 1), z = 1; or warm s = max(s0, eps),
// z = max(z0, eps) (the (B, mI) warm state in G's row order) — K2's
// wrapper contract, warm in and out included.
//
// What bounds it on an H100: operations — each iteration's assembly of
// G' diag(d) G over the structural nonzeros of G (1.37 M multiply-adds a
// lane at the DMS shape against 5.2 M unique dense ones), against the bytes
// of H, g, h in and x, mu (and s, z) out; in practice the latency of each
// lane's serial chain (the factorization, the sweeps, the block barriers).
//
// Design (mehrotra_wide.cuh): one 256-thread block per lane, G read from
// device memory through the host plan of its structure (L2 resident, shared
// by every block), H and M in shared memory; the causal-suffix assembly over
// the lower tiles a chunk reaches, staged by cp.async into a ring; G x /
// G'v over each row's and column's extent; a panel Cholesky on every thread
// and blocked sweeps; for finite inputs the bits of the dense version it
// replaced. The register tile's side is a template parameter, the smallest
// of 3, 5, 7, 8 with 16 kT >= nz.

#include <cuda_runtime.h>

#include <type_traits>

#include "mehrotra_wide.cuh"

namespace {

using namespace mehrotra_wide;

template <int kT>
__global__ void __launch_bounds__(kThreads, 2)
mehrotra_h_wide_kernel(const float* __restrict__ Gp, const float* __restrict__ GpT,
                       const int* __restrict__ meta,
                       const float* __restrict__ H, const float* __restrict__ g,
                       const float* __restrict__ h, const float* __restrict__ s0,
                       const float* __restrict__ z0,
                       float* __restrict__ x_out, float* __restrict__ mu_out,
                       float* __restrict__ s_out, float* __restrict__ z_out, int mI, int nz,
                       int iters, float tau, float d_cap, float warm_eps) {
  extern __shared__ __align__(16) float smem[];
  const Shared sh = carve(smem, mI, nz);
  const Plan P = make_plan(Gp, GpT, meta, mI, nz);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int i = tid; i < nz * nz; i += kThreads) sh.H[i] = H[b * nz * nz + i];
  if (tid < nz) sh.g[tid] = g[b * nz + tid];
  if (tid < kNzMax) sh.x[tid] = sh.dx[tid] = 0.f;

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

  solve<kT>(sh, P, mI, nz, iters, tau, d_cap, s, z, hr);

  const float mu = mehrotra::block_mu(mI, s, z, sh.red);
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

template <int kT>
int launch(const float* Gp, const float* GpT, const int* meta, const float* H,
           const float* g, const float* h, const float* s0, const float* z0, float* x,
           float* mu, float* s_out, float* z_out, int B, int mI, int nz, int iters, float tau,
           float d_cap, float warm_eps, void* stream) {
  const size_t smem = shared_floats(mI, nz) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        mehrotra_h_wide_kernel<kT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  mehrotra_h_wide_kernel<kT><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      Gp, GpT, meta, H, g, h, s0, z0, x, mu, s_out, z_out, mI, nz, iters, tau, d_cap,
      warm_eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mehrotra_h_wide_launch(const float* Gp, const float* GpT, const int* meta,
                                      const float* H, const float* g, const float* h,
                                      const float* s0, const float* z0, float* x, float* mu,
                                      float* s_out, float* z_out, int B, int mI, int nz,
                                      int iters, float tau, float d_cap, float warm_eps,
                                      void* stream) {
  if (nz < kNzMin || nz > kNzMax || mI < 1 || mI > kMaxRows || B < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const auto run = [&](auto tile) {
    return launch<decltype(tile)::value>(Gp, GpT, meta, H, g, h, s0, z0, x, mu, s_out,
                                         z_out, B, mI, nz, iters, tau, d_cap, warm_eps,
                                         stream);
  };
  if (nz <= 3 * kTile) return run(std::integral_constant<int, 3>());
  if (nz <= 5 * kTile) return run(std::integral_constant<int, 5>());
  if (nz <= 7 * kTile) return run(std::integral_constant<int, 7>());
  return run(std::integral_constant<int, 8>());
}

K2W_CLOCKS_EXPORT(mehrotra_h_wide)

extern "C" const char* mehrotra_h_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
