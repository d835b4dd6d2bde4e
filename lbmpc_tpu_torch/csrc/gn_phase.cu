// gn_phase.cu — the Gauss-Newton phase of the LBMPC SQP, one warp per lane.
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_gn.py, build_pallas_gn_kernel
// -> kernel/_body: for each lane, the N-step learned rollout through the
// Nadaraya-Watson oracle window, the sensitivities, the residual stack e and
// the Gauss-Newton normal terms H = 2 J'J + Hconst and g = 2 J'e. The
// per-lane body is gn_body.cuh's gn::lane, which gn_mehrotra.cu (K3) runs
// too.
//
// What bounds it on an H100: by its roofline, the float32 arithmetic of the
// NW sums (q exps and ~20 FMAs per window point per stage); in practice the
// latency of the N sequential stages of each lane, every one of which ends
// in 20 warp reductions before the next stage can start.
//
// Design: one warp owns one lane, and several lanes share a block so the SM
// interleaves many independent rollouts to hide that latency. Each warp
// stages its lane's window in shared memory. H (B, nz, nz), row-major and
// symmetric, e and g are written once at the end; H is the layout
// ops/qp_kernel.py's Mehrotra kernel reads as it is.

#include <cuda_runtime.h>

#include "gn_body.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gn_phase_kernel(const float* __restrict__ cst, const float* __restrict__ z,
                const float* __restrict__ dx0, const float* __restrict__ X,
                const float* __restrict__ Y, const float* __restrict__ valid,
                float* __restrict__ e_out, float* __restrict__ H_out,
                float* __restrict__ g_out, int B, int N, int q) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int c = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps leave together; only __syncwarp below
  const int nz = N + 1;
  const int ne = (N - 2) * gn::kStageRows + 2 * gn::kN;
  float* win = smem + warp * (q * 8 + gn::kStageRows * 32);
  float* D = win + q * 8;

  gn::stage_window(win, X, Y, valid, b, q, c, 32);
  __syncwarp();
  const float gacc = gn::lane(cst, z + (size_t)b * nz, dx0 + (size_t)b * gn::kN, win, D,
                              c, N, q, e_out + (size_t)b * ne, H_out + (size_t)b * nz * nz, nz);
  if (c < nz) g_out[(size_t)b * nz + c] = gacc;
}

}  // namespace

extern "C" int gn_phase_launch(const float* cst, const float* z, const float* dx0,
                               const float* X, const float* Y, const float* valid,
                               float* e, float* H, float* g, int B, int N, int q,
                               void* stream) {
  if (N < 3 || N + 1 > gn::kNzMax || q < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = (size_t)kWarpsPerBlock * (q * 8 + gn::kStageRows * 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        gn_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  gn_phase_kernel<<<blocks, kWarpsPerBlock * 32, smem, (cudaStream_t)stream>>>(
      cst, z, dx0, X, Y, valid, e, H, g, B, N, q);
  return (int)cudaGetLastError();
}

extern "C" const char* gn_phase_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
