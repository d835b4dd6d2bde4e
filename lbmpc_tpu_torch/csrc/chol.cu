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
// The factorization is the TPU kernel's column recurrence (_chol_cols):
// column j is acc = M[:, j] - sum_{k<j} L[j, k] L[:, k] with the terms taken
// in the order k = 0, 1, ..., j-1, L[j, j] = acc_j / sqrt(max(acc_j, 1e-30))
// and L[i, j] = acc_i / sqrt(max(acc_j, 1e-30)) below it — the pivot floor
// included. Here it runs right-looking in place: after column j is final,
// every entry (i, k) of the trailing lower triangle subtracts L[i, j] L[k, j],
// which gives each entry the same terms in the same order. The forward solve
// is the TPU kernel's column sweep (_tri_lower); the back solve is the same
// sweep on L' (its sums run in another order than _tri_upper_t /
// _tri_upper_red: float32 roundoff). Every product, difference, quotient
// and square root is rounded on its own (__fmul_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: no fused multiply-add), in the order of the plain version
// ops/chol_kernel.py, so the kernel reproduces it bit for bit and the IPM on
// the card follows its plain route exactly, hard lanes included.
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

namespace {

constexpr int kNMax = 128;
constexpr float kPivotFloor = 1e-30f;

template <bool kFactor, bool kStore>
__global__ void chol_kernel(const float* __restrict__ Min, const float* __restrict__ b,
                            float* __restrict__ L_out, float* __restrict__ x_out, int n) {
  extern __shared__ float smem[];
  float* A = smem;             // n * n: M, factored in place into L
  float* col = A + n * n;      // n: column j of L
  float* v = col + n;          // n: the running right-hand side
  float* y = v + n;            // n: the forward solve's result
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = T >> 5;
  const size_t lane_off = (size_t)blockIdx.x * n * n;

  for (int e = tid; e < n * n; e += T) A[e] = Min[lane_off + e];
  for (int i = tid; i < n; i += T) v[i] = b[(size_t)blockIdx.x * n + i];
  __syncthreads();

  if (kFactor) {
    for (int j = 0; j < n; ++j) {
      // the floor lets NaN through, as jnp.maximum and torch.clamp do
      // (fmaxf would turn a NaN pivot into the floor)
      const float acc = A[j * n + j];
      const float djj = __fsqrt_rn(acc < kPivotFloor ? kPivotFloor : acc);
      for (int i = j + tid; i < n; i += T) col[i] = __fdiv_rn(A[i * n + j], djj);
      __syncthreads();
      for (int i = j + tid; i < n; i += T) A[i * n + j] = col[i];
      for (int i = j + 1 + warp; i < n; i += nwarps) {
        const float lij = col[i];
        float* row = A + i * n;
        for (int k = j + 1 + lane; k <= i; k += 32)
          row[k] = __fsub_rn(row[k], __fmul_rn(lij, col[k]));
      }
      __syncthreads();
    }
    if (kStore) {
      for (int e = tid; e < n * n; e += T) {
        const int i = e / n, k = e - i * n;
        L_out[lane_off + e] = k <= i ? A[e] : 0.0f;
      }
    }
  }

  // forward: L y = b, column by column
  for (int j = 0; j < n; ++j) {
    const float yj = __fdiv_rn(v[j], A[j * n + j]);
    for (int i = j + 1 + tid; i < n; i += T)
      v[i] = __fsub_rn(v[i], __fmul_rn(A[i * n + j], yj));
    if (tid == 0) y[j] = yj;
    __syncthreads();
  }
  // back: L' x = y, column by column of L' (row j of L)
  for (int j = n - 1; j >= 0; --j) {
    const float xj = __fdiv_rn(y[j], A[j * n + j]);
    for (int i = tid; i < j; i += T) y[i] = __fsub_rn(y[i], __fmul_rn(A[j * n + i], xj));
    if (tid == 0) v[j] = xj;
    __syncthreads();
  }
  for (int i = tid; i < n; i += T) x_out[(size_t)blockIdx.x * n + i] = v[i];
}

template <bool kFactor, bool kStore>
int launch(const float* M, const float* b, float* L, float* x, int B, int n, void* stream) {
  if (n < 1 || n > kNMax || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = ((size_t)n * n + 3 * n) * sizeof(float);
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
