// chol_blocked.cu — batched Cholesky factor + solve by a slab-blocked
// factorization, one thread block per lane (K6a, K6b).
//
// Replaces the TPU kernels of lbmpc_tpu/ops/pallas_chol.py with
// LBMPC_CHOL_BLOCKED=1 at n_p = 8 ceil(n / 8) >= 32:
//   chol_factor_solve_blocked_launch <- _factor_solve_call.kernel_blocked
//       (K6a): factor the SPD M (B, n, n), solve M x = b, and store L;
//   chol_solve_blocked_launch        <- _solve_call.kernel_blocked (K6b):
//       the same without storing L (LBMPC_CHOL_STORE=0).
// Both use _chol_blocked_inplace's slab form (slabs of 8 columns), whose
// claim is that each entry subtracts its terms in the same order k = 0..j-1
// as the column form. The TPU version replicates columns through the MXU
// with the TILE8 / BC8 constant matrices, a device of the TPU's with no
// counterpart here. On this card warp 0 factors each slab's panel and the
// block then updates the trailing matrix once (chol_body.cuh
// factor_blocked): n/8 trailing passes and two block barriers a slab, where
// K5 (chol.cu) makes n passes with two barriers each. Every operation is
// rounded on its own in the same order as K5, so K6a equals K5a (L and x)
// and K6b equals K5b bit for bit; the plain version of both is K5's
// (ops/chol_kernel.py cholesky_floor and its solves). L is written in K5's
// (B, n, n) row-major layout, so K5c (chol_resolve) resolves it as it is.
//
// What bounds it on an H100: bytes, as K5 (chol.cu): M's lower triangle in,
// L's out (K6a), against n^3/3 operations. The serial slab chain and the
// solves' n barriers keep it above that bound.
//
// Layout: M, L (B, n, n) row-major, b and x (B, n), float32, contiguous,
// n <= 128; one 256-thread block per lane with the matrix in shared memory
// (n^2 floats, 40.8 KB at n=101).

#include <cuda_runtime.h>

#include "chol_body.cuh"

namespace {

template <bool kStore>
__global__ void __launch_bounds__(256)
chol_blocked_kernel(const float* __restrict__ Min, const float* __restrict__ b,
                    float* __restrict__ L_out, float* __restrict__ x_out, int n) {
  extern __shared__ float smem[];
  chol::lane<true, kStore, true>(Min, b, L_out, x_out, n, smem);
}

template <bool kStore>
int launch(const float* M, const float* b, float* L, float* x, int B, int n, void* stream) {
  if (n < 1 || n > chol::kNMax || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = chol::lane_shared_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        chol_blocked_kernel<kStore>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  chol_blocked_kernel<kStore><<<B, 256, smem, (cudaStream_t)stream>>>(M, b, L, x, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chol_factor_solve_blocked_launch(const float* M, const float* b, float* L,
                                                float* x, int B, int n, void* stream) {
  return launch<true>(M, b, L, x, B, n, stream);
}

extern "C" int chol_solve_blocked_launch(const float* M, const float* b, float* x, int B,
                                         int n, void* stream) {
  return launch<false>(M, b, nullptr, x, B, n, stream);
}

extern "C" const char* chol_blocked_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
