// gn_wide.cu — the Gauss-Newton phase of the LBMPC SQP at any nz <= 128,
// both families, one thread block per lane (K1w).
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_gn.py, build_pallas_gn_kernel
// -> kernel/_body, over the part of its domain that gn_phase.cu (K1: the
// fmincon family at nz <= 32, one warp per lane) does not take: the casadi
// family (the DMS flagship, N=100, nz=101) and the fmincon family above
// nz 32 (LBMPC_N40 uncut, nz=41). For each lane: the N-step learned rollout
// through the Nadaraya-Watson oracle window, the sensitivities, the residual
// stack e and the Gauss-Newton normal terms H = 2 J'J + Hconst and
// g = 2 J'e. The per-lane body is gn_wide_body.cuh's gnw::lane.
//
// What bounds it on an H100: by its roofline, the float32 arithmetic of the
// NW sums (q exps and ~25 operations per window point per stage) and of
// the rank-5 updates of H; in practice the latency of the N sequential
// stages, each of which ends in 20 block-wide reductions and two barriers.
//
// Design: one block of 64 or 128 threads per lane, a thread per decision
// column; the window, H (nz^2 floats: 40.8 KB at nz=101) and the stage's
// Jacobian rows sit in shared memory, so several lanes share an SM and
// interleave their stage chains. H (B, nz, nz) is written row-major and
// exactly symmetric with Hconst added (read symmetrically), e and g once:
// the layout the Mehrotra kernels (mehrotra_h.cu, mehrotra_h_wide.cu) read
// as it is.

#include <cuda_runtime.h>

#include "gn_wide_body.cuh"

namespace {

template <bool kCasadi>
__global__ void __launch_bounds__(128)
gn_wide_kernel(const float* __restrict__ cst, const float* __restrict__ z,
               const float* __restrict__ dx0, const float* __restrict__ X,
               const float* __restrict__ Y, const float* __restrict__ valid,
               float* __restrict__ e_out, float* __restrict__ H_out,
               float* __restrict__ g_out, int N, int q) {
  extern __shared__ float smem[];
  const int c = threadIdx.x, T = blockDim.x;
  const size_t b = blockIdx.x;
  const int nz = N + 1;
  const int n_run = kCasadi ? N : N - 2;
  const int ne = n_run * (gnw::kN + 1) + 2 * gnw::kN;
  const gnw::Shared sh = gnw::carve(smem, q, nz);

  gn::stage_window(sh.win, X, Y, valid, b, q, c, T);
  __syncthreads();
  const float gacc = gnw::lane<kCasadi>(sh, cst, z + b * nz, dx0 + b * gnw::kN, N, q,
                                        e_out + b * ne, T);
  // H = 2 J'J + Hconst, Hconst read at (min, max) so H stays symmetric
  const float* Hc = cst + gnw::C_HCONST;
  float* Hb = H_out + b * nz * nz;
  for (int e = c; e < nz * nz; e += T) {
    const int i = e / nz, j = e - i * nz;
    Hb[e] = sh.H[e] + Hc[i <= j ? e : j * nz + i];
  }
  if (c < nz) g_out[b * nz + c] = gacc;
}

template <bool kCasadi>
int launch(const float* cst, const float* z, const float* dx0, const float* X,
           const float* Y, const float* valid, float* e, float* H, float* g, int B, int N,
           int q, void* stream) {
  const int nz = N + 1;
  if (N < (kCasadi ? 1 : 3) || nz > gnw::kNzMax || q < 1 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = gnw::shared_floats(q, nz) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        gn_wide_kernel<kCasadi>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  const int threads = gnw::threads(nz);
  gn_wide_kernel<kCasadi><<<B, threads, smem, (cudaStream_t)stream>>>(
      cst, z, dx0, X, Y, valid, e, H, g, N, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gn_wide_launch(const float* cst, const float* z, const float* dx0,
                              const float* X, const float* Y, const float* valid, float* e,
                              float* H, float* g, int B, int N, int q, int casadi,
                              void* stream) {
  return casadi ? launch<true>(cst, z, dx0, X, Y, valid, e, H, g, B, N, q, stream)
                : launch<false>(cst, z, dx0, X, Y, valid, e, H, g, B, N, q, stream);
}

extern "C" const char* gn_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
