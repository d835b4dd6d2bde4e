// gn_phase.cu — the Gauss-Newton phase of the LBMPC SQP, one warp a lane,
// several lanes a block (K1).
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_gn.py, build_pallas_gn_kernel
// -> kernel/_body: for each lane, the N-step learned rollout through the
// Nadaraya-Watson oracle window, the sensitivities, the residual stack e and
// the Gauss-Newton normal terms H = 2 J'J + Hconst and g = 2 J'e. The
// per-lane body is gn_body.cuh's gn::lane, which gn_mehrotra.cu (K3) runs
// too. The fmincon family at nz <= 32.
//
// What bounds it on an H100: by its roofline, the float32 arithmetic of the
// NW sums (q exps and ~20 FMAs per window point per stage); in practice the
// latency of each lane's N sequential stages (the point loop, the closing
// of the 20 sums by shuffles, the quotients, the state update), and the
// lanes an SM holds to hide it.
//
// Design: a warp a lane, `lanes` lanes a block (the host's
// ops/gn_kernel.narrow_gn_launch picks them from nz, q and B: a block a lane
// up to the SM count, up to kMaxLanes above). Each warp stages its own
// lane's constants and window in its shared memory and meets no block
// barrier, so a lane's bits depend neither on its block nor on B. A stage
// closes its sums by a reduce-scatter (21 shuffles, not 100), divides each
// quotient once and broadcasts it, and updates only the causal entries of
// H's lower triangle (in the warp's shared memory, row stride nz); H (B, nz,
// nz), row-major and exactly symmetric, e and g are written once at the
// end. The registers a lane needs are few (no per-thread pair slots, the
// constants in shared memory), so kMinBlocks blocks of kMaxLanes lanes fit
// an SM.

#include <cuda_runtime.h>

#include "gn_body.cuh"

namespace {

constexpr int kMaxLanes = 8;   // lanes (warps) a block (ops/gn_kernel.NARROW_MAX_LANES)
// Blocks of kMaxLanes an SM the launch bounds ask for: 3 (<= 85 registers;
// 80 used, nothing spilled, 24 lanes an SM). 4 spill and run 4-10 %
// slower, 2 run no faster (tools/k1_k4_compare.py variants).
constexpr int kMinBlocks = 3;

// Floats of one lane's shared memory: gn::lane's working memory and H's
// accumulator (nz x nz), rounded to 4 so the next lane's float4s stay aligned.
__host__ __device__ constexpr size_t lane_floats(int nz, int q) {
  return ((size_t)gn::work_floats(q) + (size_t)nz * nz + 3) / 4 * 4;
}

size_t smem_bytes(int nz, int q, int lanes) {
  return (size_t)lanes * lane_floats(nz, q) * sizeof(float);
}

__global__ void __launch_bounds__(kMaxLanes * 32, kMinBlocks)
gn_phase_kernel(const float* __restrict__ cst, const float* __restrict__ z,
                const float* __restrict__ dx0, const float* __restrict__ X,
                const float* __restrict__ Y, const float* __restrict__ valid,
                float* __restrict__ e_out, float* __restrict__ H_out,
                float* __restrict__ g_out, int B, int N, int q) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps leave together; only __syncwarp below
  const int nz = N + 1;
  const int ne = (N - 2) * gn::kStageRows + 2 * gn::kN;
  float* base = smem + (size_t)warp * lane_floats(nz, q);
  const gn::LaneMem m = gn::carve(base, q);
  float* Ha = base + gn::work_floats(q);
  gn::stage(m, cst, X, Y, valid, b, q, lane);
  for (int i = lane; i < nz * nz; i += 32) Ha[i] = 0.f;
  __syncwarp();
  const float g = gn::lane(m, z + (size_t)b * nz, dx0 + (size_t)b * gn::kN, Ha, nz, lane, N, q,
                           e_out + (size_t)b * ne);
  gn::store_h(Ha, nz, cst + gn::C_HCONST, H_out + (size_t)b * nz * nz, nz, lane);
  if (lane < nz) g_out[(size_t)b * nz + lane] = g;
}

bool valid_shape(int N, int q, int lanes) {
  return N >= 3 && N + 1 <= gn::kNzMax && q >= 1 && lanes >= 1 && lanes <= kMaxLanes;
}

}  // namespace

extern "C" int gn_phase_launch(const float* cst, const float* z, const float* dx0,
                               const float* X, const float* Y, const float* valid,
                               float* e, float* H, float* g, int B, int N, int q, int lanes,
                               void* stream) {
  if (!valid_shape(N, q, lanes) || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(N + 1, q, lanes);
  const cudaError_t st =
      cudaFuncSetAttribute(gn_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (st != cudaSuccess) return (int)st;
  gn_phase_kernel<<<(B + lanes - 1) / lanes, lanes * 32, smem, (cudaStream_t)stream>>>(
      cst, z, dx0, X, Y, valid, e, H, g, B, N, q);
  return (int)cudaGetLastError();
}

// The dynamic shared memory of a block of `lanes` lanes (bytes);
// ops/gn_kernel.narrow_gn_smem_bytes is held to it.
extern "C" long long gn_phase_smem_bytes(int nz, int q, int lanes) {
  return (long long)smem_bytes(nz, q, lanes);
}

// The lanes one SM holds in blocks of `lanes` lanes (CUDA's occupancy
// calculator), -1 where the kernel does not take the shape.
extern "C" int gn_phase_resident_lanes(int nz, int q, int lanes) {
  if (!valid_shape(nz - 1, q, lanes)) return -1;
  const size_t smem = smem_bytes(nz, q, lanes);
  int blocks = 0;
  cudaFuncSetAttribute(gn_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gn_phase_kernel, lanes * 32, smem);
  return blocks * lanes;
}

extern "C" const char* gn_phase_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
