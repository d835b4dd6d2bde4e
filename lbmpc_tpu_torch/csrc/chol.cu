// chol.cu — batched Cholesky factor + solve for the IPM's KKT normal
// matrices, one thread block per lane (K5a, K5b, K5c).
//
// Replaces the TPU kernels of lbmpc_tpu/ops/pallas_chol.py with
// LBMPC_CHOL_BLOCKED unset:
//   chol_factor_solve_launch  <- _factor_solve_call.kernel (K5a): factor the
//       SPD M (B, n, n), solve M x = b, and store L;
//   chol_solve_launch         <- _solve_call.kernel (K5b): the same without
//       storing L (the refactor-per-solve route, LBMPC_CHOL_STORE=0);
//   chol_resolve_launch       <- _resolve_call.kernel (K5c): the two
//       triangular solves with a stored L (the Mehrotra corrector).
// The factorization is the TPU kernel's column recurrence (_chol_cols), run
// right-looking in place (chol_body.cuh factor_cols); the forward solve is
// the TPU kernel's column sweep (_tri_lower), the back solve the same sweep
// on L' (its sums run in another order than _tri_upper_t / _tri_upper_red:
// float32 roundoff). Every operation is rounded on its own in the order of
// the plain version ops/chol_kernel.py, so the kernel reproduces it bit for
// bit and the IPM on the card follows its plain route exactly, hard lanes
// included. The device code is chol_body.cuh's, which the slab-blocked K6
// (chol_blocked.cu) shares.
//
// Layout: M, L (B, n, n) row-major, b and x (B, n), float32, contiguous.
// L is written whole, lower triangle with the diagonal and zeros above, and
// K5c reads only its lower triangle. The TPU version's column-major
// (n_p^2, B) lane-batched pack and its identity padding to n_p = 8k exist
// for the TPU's (8, 128) tiles and have no counterpart: padded rows decouple
// and change nothing.
//
// What bounds it on an H100: bytes. K5a must read M's lower triangle and
// write L's, 2 n(n+1) bytes each way a lane (21.1 MB each way at n=101,
// B=1024: ~12.6 us at 3.35 TB/s), against n^3/3 operations (~6 us at
// 67 TFLOP/s float32); K5c reads L's lower triangle only. This version
// moves the whole squares (M in, L with its zeros out), twice those bytes.
//
// Design: the lane's matrix is staged in shared memory with coalesced loads
// (n^2 floats: 40.8 KB at n=101; above 48 KB the launch raises the dynamic
// shared-memory limit) and factored there, so device memory sees each byte
// once. n <= 32 runs one warp per lane; larger n runs 8 warps, which split
// the trailing update row by row with the warp's lanes across the row's
// contiguous entries. Each column costs two block barriers and each solve
// step one. This first version does not overlap the load with the
// factorization; the serial column chain (n steps) is what keeps it above
// the byte bound.

#include <cuda_runtime.h>

#include "chol_body.cuh"

namespace {

template <bool kFactor, bool kStore>
__global__ void chol_kernel(const float* __restrict__ Min, const float* __restrict__ b,
                            float* __restrict__ L_out, float* __restrict__ x_out, int n) {
  extern __shared__ float smem[];
  chol::lane<kFactor, kStore, false>(Min, b, L_out, x_out, n, smem);
}

template <bool kFactor, bool kStore>
int launch(const float* M, const float* b, float* L, float* x, int B, int n, void* stream) {
  if (n < 1 || n > chol::kNMax || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = chol::lane_shared_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        chol_kernel<kFactor, kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  const int threads = n <= 32 ? 32 : 256;
  chol_kernel<kFactor, kStore><<<B, threads, smem, (cudaStream_t)stream>>>(M, b, L, x, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chol_factor_solve_launch(const float* M, const float* b, float* L, float* x,
                                        int B, int n, void* stream) {
  return launch<true, true>(M, b, L, x, B, n, stream);
}

extern "C" int chol_solve_launch(const float* M, const float* b, float* x, int B, int n,
                                 void* stream) {
  return launch<true, false>(M, b, nullptr, x, B, n, stream);
}

extern "C" int chol_resolve_launch(const float* L, const float* b, float* x, int B, int n,
                                   void* stream) {
  return launch<false, false>(L, b, nullptr, x, B, n, stream);
}

extern "C" const char* chol_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
