// chol.cu — batched Cholesky factor + solve for the IPM's KKT normal
// matrices (K5a, K5b, K5c): one warp a lane and several lanes a block up to
// n = 32, one 256-thread block a lane above.
//
// Replaces the TPU kernels of lbmpc_tpu/ops/pallas_chol.py with
// LBMPC_CHOL_BLOCKED unset:
//   chol_factor_solve_launch  <- _factor_solve_call.kernel (K5a): factor the
//       SPD M (B, n, n), solve M x = b, and store L;
//   chol_solve_launch         <- _solve_call.kernel (K5b): the same without
//       storing L (the refactor-per-solve route, LBMPC_CHOL_STORE=0);
//   chol_resolve_launch       <- _resolve_call.kernel (K5c): the two
//       triangular solves with a stored L (the Mehrotra corrector).
// The factorization is the TPU kernel's column recurrence (_chol_cols); the
// forward solve is its column sweep (_tri_lower), the back solve the same
// sweep on L' (its sums run in another order than _tri_upper_t /
// _tri_upper_red: float32 roundoff). Every operation is rounded on its own
// (chol::sub_prod, chol::pivot, __fdiv_rn) and each entry takes its terms in
// the order of the plain version ops/chol_kernel.py, so the kernel
// reproduces it bit for bit and the IPM on the card follows its plain route
// exactly, hard lanes included.
//
// Layout: M, L (B, n, n) row-major, b and x (B, n), float32, contiguous.
// Only M's lower triangle is read. L is written whole, lower triangle with
// the diagonal and zeros above, and K5c reads only its lower triangle. The
// TPU version's column-major (n_p^2, B) lane-batched pack and its identity
// padding to n_p = 8k exist for the TPU's (8, 128) tiles and have no
// counterpart.
//
// What bounds it on an H100: bytes. K5a must read M's lower triangle and
// write L's, 2 n(n+1) bytes each way a lane (21.1 MB each way at n=101,
// B=1024: ~12.6 us at 3.35 TB/s), against n^3/3 operations; K5c
// reads L's lower triangle only. In practice the serial column chain of
// each lane (a square root, a quotient and a broadcast a column, then a
// quotient and a broadcast a column of each sweep) sets the time, so the
// design keeps the chain free of block barriers and fills each SM with many
// independent chains.
//
// Design, n <= 32 (the fmincon bench, n = 21): a warp a lane, `lanes` lanes
// a block (the host's ops/chol_kernel.chol_launch picks them from n and B).
// Lane i of the warp holds row i of M in registers (template widths 8, 16,
// 24, 32, so every loop over the columns unrolls without a branch on n);
// column j's pivot and each L[k][j] are broadcast by __shfl_sync, and the
// forward sweep runs on the registers. The lane's shared copy of L (rows of
// odd stride) feeds the back sweep, which reads a column of L a step, and
// L's coalesced store. No block barrier: each warp runs on its own.
// Design, n > 32 (the DMS flagship, n = 101): a block of 256 threads a lane
// with the matrix in shared memory, factored by panels of 8 columns and
// solved by blocks of 32 columns (chol_body.cuh factor_panel and
// solve_blocked, which K2w runs too): two block barriers a column of the
// factorization and two a 32-column block of each sweep.

#include <cuda_runtime.h>

#include <type_traits>

#include "chol_body.cuh"

namespace {

using chol::kFull;
using chol::pivot;
using chol::sub_prod;

constexpr int kWarpNMax = 32;   // the warp form's largest n
constexpr int kMaxLanes = 8;    // lanes (warps) a block of the warp form

// The warp form's register width at n: 8 ceil(n / 8).
constexpr int width(int n) { return (n + 7) / 8 * 8; }

// Floats of one lane's shared memory: the warp form's copy of L (n rows of
// stride width + 1), or the block form's A (n x n), v (n) and panel.
constexpr size_t lane_floats(int n) {
  return n <= kWarpNMax ? (size_t)n * (width(n) + 1)
                        : (size_t)n * n + n + 2 * chol::kPanel;
}

size_t smem_bytes(int n, int lanes) { return lanes * lane_floats(n) * sizeof(float); }

// One lane a warp: factor (kFactor) rows held in registers, store L (kStore),
// then the two sweeps. Each entry gets chol_body.cuh factor_cols' and
// solve's terms in their order and rounding.
template <int W, bool kFactor, bool kStore>
__global__ void __launch_bounds__(kMaxLanes * 32)
chol_warp_kernel(const float* __restrict__ Min, const float* __restrict__ b,
                 float* __restrict__ L_out, float* __restrict__ x_out, int B, int n) {
  extern __shared__ float smem[];
  constexpr int S = W + 1;  // row stride: column j of the rows hits distinct banks
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lb = blockIdx.x * (blockDim.x >> 5) + warp;
  if (lb >= B) return;  // whole warps leave together
  float* Ls = smem + (size_t)warp * n * S;
  const float* Mb = Min + (size_t)lb * n * n;

  // M's (or L's) lower triangle, a row an instruction
#pragma unroll
  for (int i = 0; i < W; ++i)
    if (i < n && lane <= i) Ls[i * S + lane] = Mb[i * n + lane];
  float v = lane < n ? b[(size_t)lb * n + lane] : 0.f;
  __syncwarp();
  float a[W];  // row `lane`: a[k] = M[lane][k] for k <= lane, then L
#pragma unroll
  for (int k = 0; k < W; ++k) a[k] = (k <= lane && lane < n) ? Ls[lane * S + k] : 0.f;

  // Every lane divides at every column and sweep step, and __fdiv_rn takes a
  // slow path, for the whole warp, on a zero, subnormal or non-finite
  // operand: the lanes whose quotient goes unread divide 1, and lanes past
  // n hold L[i][i] = 1.
  float dg;  // L[lane][lane]
  if (kFactor) {
    // column j: L[i][j] = acc_i / sqrt(max(acc_j, 1e-30)), then every entry
    // (i, k) right of it subtracts L[i][j] L[k][j] (factor_cols' order)
    dg = 1.f;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < n) {
        const bool row = lane >= j && lane < n;
        const float lij = __fdiv_rn(row ? a[j] : 1.f, pivot(__shfl_sync(kFull, a[j], j)));
        a[j] = lij;
        if (lane == j) dg = lij;
#pragma unroll
        for (int k = j + 1; k < W; ++k) a[k] = sub_prod(a[k], lij, __shfl_sync(kFull, lij, k));
      }
    }
    // each lane overwrites only its own row, which only it has read
#pragma unroll
    for (int k = 0; k < W; ++k)
      if (k <= lane && lane < n) Ls[lane * S + k] = a[k];
    __syncwarp();
    if (kStore) {
      float* Lb = L_out + (size_t)lb * n * n;
#pragma unroll
      for (int i = 0; i < W; ++i)
        if (i < n && lane < n) Lb[i * n + lane] = lane <= i ? Ls[i * S + lane] : 0.f;
    }
  } else {
    dg = lane < n ? Ls[lane * S + lane] : 1.f;
  }

  // forward: L y = b, column by column; y[j] = v[j] / L[j][j] from lane j
  float y = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j < n) {
      const float yj = __shfl_sync(kFull, __fdiv_rn(lane == j ? v : 1.f, dg), j);
      if (lane == j) y = yj;
      if (lane > j && lane < n) v = sub_prod(v, a[j], yj);
    }
  }
  // back: L' x = y, column by column of L' (row j of L, from shared memory)
  float x = 0.f;
#pragma unroll
  for (int j = W - 1; j >= 0; --j) {
    if (j < n) {
      const float xj = __shfl_sync(kFull, __fdiv_rn(lane == j ? y : 1.f, dg), j);
      if (lane == j) x = xj;
      if (lane < j) y = sub_prod(y, Ls[j * S + lane], xj);
    }
  }
  if (lane < n) x_out[(size_t)lb * n + lane] = x;
}

// One lane a block of chol::kBlockThreads, n > 32.
template <bool kFactor, bool kStore>
__global__ void __launch_bounds__(chol::kBlockThreads)
chol_block_kernel(const float* __restrict__ Min, const float* __restrict__ b,
                  float* __restrict__ L_out, float* __restrict__ x_out, int n) {
  extern __shared__ float smem[];
  float* A = smem;           // n * n: M, factored in place into L
  float* v = A + n * n;      // n: b, then x
  float* panel = v + n;      // 2 * kPanel: factor_panel's broadcasts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)blockIdx.x * n * n;
  for (int i = warp; i < n; i += chol::kBlockWarps)
    for (int k = lane; k <= i; k += 32) A[i * n + k] = Min[off + i * n + k];
  for (int i = tid; i < n; i += chol::kBlockThreads) v[i] = b[(size_t)blockIdx.x * n + i];
  __syncthreads();
  if (kFactor) {
    chol::factor_panel(A, panel, n);
    if (kStore) {
      for (int i = warp; i < n; i += chol::kBlockWarps)
        for (int k = lane; k < n; k += 32) L_out[off + i * n + k] = k <= i ? A[i * n + k] : 0.f;
    }
  }
  chol::solve_blocked(A, v, n);
  for (int i = tid; i < n; i += chol::kBlockThreads) x_out[(size_t)blockIdx.x * n + i] = v[i];
}

// f(kernel, std::true_type) for the warp form's instance at n, f(kernel,
// std::false_type) for the block form.
template <bool kFactor, bool kStore, class F>
int by_shape(int n, F&& f) {
  switch (n > kWarpNMax ? 0 : width(n)) {
    case 8: return f(chol_warp_kernel<8, kFactor, kStore>, std::true_type{});
    case 16: return f(chol_warp_kernel<16, kFactor, kStore>, std::true_type{});
    case 24: return f(chol_warp_kernel<24, kFactor, kStore>, std::true_type{});
    case 32: return f(chol_warp_kernel<32, kFactor, kStore>, std::true_type{});
    default: return f(chol_block_kernel<kFactor, kStore>, std::false_type{});
  }
}

bool valid(int n, int lanes) {
  return n >= 1 && n <= chol::kNMax && lanes >= 1
         && lanes <= (n <= kWarpNMax ? kMaxLanes : 1);
}

template <bool kFactor, bool kStore>
int launch(const float* M, const float* b, float* L, float* x, int B, int n, int lanes,
           void* stream) {
  if (!valid(n, lanes) || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(n, lanes);
  return by_shape<kFactor, kStore>(n, [&](auto kernel, auto warp_form) {
    if (smem > 48 * 1024) {
      const cudaError_t st =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (st != cudaSuccess) return (int)st;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    if constexpr (decltype(warp_form)::value)
      kernel<<<(B + lanes - 1) / lanes, lanes * 32, smem, s>>>(M, b, L, x, B, n);
    else
      kernel<<<B, chol::kBlockThreads, smem, s>>>(M, b, L, x, n);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int chol_factor_solve_launch(const float* M, const float* b, float* L, float* x,
                                        int B, int n, int lanes, void* stream) {
  return launch<true, true>(M, b, L, x, B, n, lanes, stream);
}

extern "C" int chol_solve_launch(const float* M, const float* b, float* x, int B, int n,
                                 int lanes, void* stream) {
  return launch<true, false>(M, b, nullptr, x, B, n, lanes, stream);
}

extern "C" int chol_resolve_launch(const float* L, const float* b, float* x, int B, int n,
                                   int lanes, void* stream) {
  return launch<false, false>(L, b, nullptr, x, B, n, lanes, stream);
}

// The dynamic shared memory of a block of `lanes` lanes (bytes), -1 where
// the kernels do not take (n, lanes); ops/chol_kernel.chol_smem_bytes is
// held to it.
extern "C" long long chol_smem_bytes(int n, int lanes) {
  return valid(n, lanes) ? (long long)smem_bytes(n, lanes) : -1;
}

// The lanes one SM holds in blocks of `lanes` lanes (CUDA's occupancy
// calculator) for kind 0 (K5a), 1 (K5b) or 2 (K5c).
extern "C" int chol_resident_lanes(int kind, int n, int lanes) {
  if (!valid(n, lanes)) return -1;
  const size_t smem = smem_bytes(n, lanes);
  auto occ = [&](auto kernel, auto warp_form) {
    int blocks = 0;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, decltype(warp_form)::value ? lanes * 32 : chol::kBlockThreads, smem);
    return blocks * lanes;
  };
  switch (kind) {
    case 0: return by_shape<true, true>(n, occ);
    case 1: return by_shape<true, false>(n, occ);
    default: return by_shape<false, false>(n, occ);
  }
}

extern "C" const char* chol_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
