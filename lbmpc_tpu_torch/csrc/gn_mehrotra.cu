// gn_mehrotra.cu — one launch per Gauss-Newton iteration of the LBMPC SQP:
// the GN phase and the whole Mehrotra QP loop of each lane in one block.
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_gn.py, build_pallas_gn_kernel
// with ipm=dict(iters, d_cap) -> kernel_ipm/_ipm_body. For each lane:
// - the fmincon GN phase exactly as gn_phase.cu (K1): residual e,
//   H = 2 J'J + Hconst and g = 2 J'e (gn_body.cuh);
// - the QP's constraint right-hand side in step space,
//   h = (h0 + Hp dx0) - G z_bar, each row's terms rounded on their own and
//   added in index order, as ops/qp_kernel.step_rhs forms it for the
//   two-launch routes;
// - a cold Mehrotra loop on (H, g, G, h) exactly as mehrotra_h.cu (K2):
//   x = 0, s = max(h, 1), z = 1, d capped at d_cap, the 1e-6 ridge, Jacobi
//   equilibration, the pivot floor, the 1e6 ratio sentinel, tau, mu over mI
//   (mehrotra_body.cuh).
// Out: e (B, ne), the QP step d (B, nz), mu (B,) and g (B, nz); H never
// leaves the block. The reference's causal-suffix contraction (lo128) is an
// exact restatement that the assembly does not need: it contracts over all
// rows, as K2 does.
//
// What bounds it on an H100: operations in the QP's assembly by the
// roofline, and in practice the latency of the lane's serial chain: the N
// GN stages on one warp, then each Mehrotra iteration's one-warp
// factorization and triangular sweeps.
//
// Design: one 256-thread block per lane. All threads stage G and the lane's
// window; warp 0 runs the GN body and leaves H and g in the QP's shared
// memory (no round trip through device memory, no second launch); then the
// block runs K2's loop. The register count is the larger of the two phases'
// (the GN body alone wants ~200 a thread), so __launch_bounds__ asks for two
// blocks an SM: 128 registers a thread, the GN body's excess spilled.

#include <cuda_runtime.h>

#include "gn_body.cuh"
#include "mehrotra_body.cuh"

namespace {

using namespace mehrotra;

constexpr int kMinBlocksPerSM = 2;

__host__ __device__ constexpr size_t window_floats(int q) {
  return (size_t)q * 8 + gn::kStageRows * 32;
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
gn_mehrotra_kernel(const float* __restrict__ cst, const float* __restrict__ z,
                   const float* __restrict__ dx0, const float* __restrict__ X,
                   const float* __restrict__ Y, const float* __restrict__ valid,
                   const float* __restrict__ G, const float* __restrict__ h0,
                   const float* __restrict__ Hp, float* __restrict__ e_out,
                   float* __restrict__ d_out, float* __restrict__ mu_out,
                   float* __restrict__ g_out, int N, int q, int mI, int iters, float tau,
                   float d_cap) {
  extern __shared__ float smem[];
  const int nz = N + 1;
  const int ne = (N - 2) * gn::kStageRows + 2 * gn::kN;
  const Shared sh = carve(smem, mI, nz);
  float* win = smem + shared_floats(mI, nz);
  float* D = win + q * 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t b = blockIdx.x;
  const float* zb = z + b * nz;
  const float* dxb = dx0 + b * gn::kN;

  for (int i = tid; i < mI * nz; i += kThreads) sh.G[i] = G[i];
  gn::stage_window(win, X, Y, valid, b, q, tid, kThreads);
  if (tid < nz) sh.x[tid] = 0.f;
  __syncthreads();

  if (warp == 0) {
    const float gl = gn::lane(cst, zb, dxb, win, D, lane, N, q, e_out + b * ne, sh.H);
    if (lane < nz) {
      sh.g[lane] = gl;
      g_out[b * nz + lane] = gl;
    }
  }

  float s[kRowsPerThread], zr[kRowsPerThread], hr[kRowsPerThread];
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = tid + t * kThreads;
    s[t] = zr[t] = hr[t] = 0.f;
    if (r < mI) {
      // each product and sum rounded on its own, in index order: the
      // order of ops/qp_kernel.step_rhs, which the two-launch routes use
      float hv = h0[r], gz = 0.f;
#pragma unroll
      for (int j = 0; j < gn::kN; ++j) hv = __fadd_rn(hv, __fmul_rn(Hp[r * gn::kN + j], dxb[j]));
      for (int c = 0; c < nz; ++c) gz = __fadd_rn(gz, __fmul_rn(sh.G[r * nz + c], zb[c]));
      hr[t] = __fsub_rn(hv, gz);
      s[t] = fmaxf(hr[t], 1.f);
      zr[t] = 1.f;
    }
  }
  __syncthreads();

  solve<true, false>(sh, mI, nz, iters, tau, d_cap, s, zr, hr);

  const float mu = block_mu(mI, s, zr, sh.red);
  if (tid == 0) mu_out[b] = mu;
  if (tid < nz) d_out[b * nz + tid] = sh.x[tid];
}

}  // namespace

extern "C" int gn_mehrotra_launch(const float* cst, const float* z, const float* dx0,
                                  const float* X, const float* Y, const float* valid,
                                  const float* G, const float* h0, const float* Hp,
                                  float* e, float* d, float* mu, float* g, int B, int N,
                                  int q, int mI, int iters, float tau, float d_cap,
                                  void* stream) {
  if (N < 3 || N + 1 > gn::kNzMax || q < 1 || mI < 1 || mI > kMaxRows || B < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (shared_floats(mI, N + 1) + window_floats(q)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        gn_mehrotra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  gn_mehrotra_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      cst, z, dx0, X, Y, valid, G, h0, Hp, e, d, mu, g, N, q, mI, iters, tau, d_cap);
  return (int)cudaGetLastError();
}

extern "C" const char* gn_mehrotra_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
