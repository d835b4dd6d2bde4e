// mehrotra.cu — a fixed-iteration Mehrotra predictor-corrector QP with one H
// and one G shared by the batch, one thread block per lane.
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_ipm.py, build_pallas_qp_solver
// -> kernel: for each lane,
//   min 1/2 x'H x + g_b'x  s.t.  G x <= h_b   (H, G shared by the batch)
// by `iters` Mehrotra iterations from x = 0, s = max(h, 1), z = 1, with
// d = min(z / max(s, 1e-25), 1e7), M = G' diag(d) G + H + 1e-6 I and no
// equilibration (mehrotra_body.cuh). The reference pads mI to a multiple of
// 128 with rows h = 1e6, z = 1 that enter its dual ratio tests; they are
// carried here as one virtual row when mI is not such a multiple. Out: x,
// the converged flag mu < 2e-4 (1 + mu mI) and max_r |G x + s - h|_r
// < 2e-3 over the real rows (pallas_ipm.py:769-775), false where either
// side is NaN, and mu.
//
// What bounds it on an H100: operations — the assembly of G' diag(d) G over
// all mI rows each iteration, as in mehrotra_h.cu; at the LMPC shape (nz 21,
// mI 806) the serial one-warp factorization and sweeps weigh less than there.
//
// Design: mehrotra_h.cu's, with H staged once per block from the one (nz, nz)
// copy instead of a per-lane H.

#include <cuda_runtime.h>

#include "mehrotra_body.cuh"

namespace {

using namespace mehrotra;

template <bool kPad>
__global__ void __launch_bounds__(kThreads)
mehrotra_kernel(const float* __restrict__ G, const float* __restrict__ H,
                const float* __restrict__ g, const float* __restrict__ h,
                float* __restrict__ x_out, unsigned char* __restrict__ conv_out,
                float* __restrict__ mu_out, int mI, int nz, int iters, float tau,
                float d_cap) {
  extern __shared__ float smem[];
  const Shared sh = carve(smem, mI, nz);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  for (int i = tid; i < mI * nz; i += kThreads) sh.G[i] = G[i];
  for (int i = tid; i < nz * nz; i += kThreads) sh.H[i] = H[i];
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
      s[t] = fmaxf(hr[t], 1.f);
      z[t] = 1.f;
    }
  }
  __syncthreads();

  solve<false, kPad>(sh, mI, nz, iters, tau, d_cap, s, z, hr);

  // rows whose residual fails the test (NaN fails), counted over the block
  float bad = 0.f;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = tid + t * kThreads;
    if (r < mI && !(fabsf(row_dot(sh, r, nz, sh.x) + s[t] - hr[t]) < 2e-3f)) bad += 1.f;
  }
  const float mu = block_mu(mI, s, z, sh.red);
  bad = block_reduce2<false>(bad, 0.f, sh.red).x;
  if (tid == 0) {
    conv_out[b] = (mu < 2e-4f * (1.f + mu * (float)mI) && bad == 0.f) ? 1 : 0;
    mu_out[b] = mu;
  }
  if (tid < nz) x_out[b * nz + tid] = sh.x[tid];
}

template <bool kPad>
int launch(const float* G, const float* H, const float* g, const float* h, float* x,
           unsigned char* conv, float* mu, int B, int mI, int nz, int iters, float tau,
           float d_cap, cudaStream_t stream) {
  const size_t smem = shared_floats(mI, nz) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        mehrotra_kernel<kPad>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  mehrotra_kernel<kPad><<<B, kThreads, smem, stream>>>(G, H, g, h, x, conv, mu, mI, nz,
                                                       iters, tau, d_cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mehrotra_launch(const float* G, const float* H, const float* g, const float* h,
                               float* x, unsigned char* conv, float* mu, int B, int mI,
                               int nz, int iters, float tau, float d_cap, void* stream) {
  if (nz < 1 || nz > kNzMax || mI < 1 || mI > kMaxRows || B < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  return mI % 128 != 0
             ? launch<true>(G, H, g, h, x, conv, mu, B, mI, nz, iters, tau, d_cap, st)
             : launch<false>(G, H, g, h, x, conv, mu, B, mI, nz, iters, tau, d_cap, st);
}

extern "C" const char* mehrotra_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
