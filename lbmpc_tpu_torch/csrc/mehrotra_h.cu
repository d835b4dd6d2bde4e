// mehrotra_h.cu — a fixed-iteration Mehrotra predictor-corrector QP with a
// Hessian per lane, one warp per lane and several lanes a block.
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_ipm.py,
// build_pallas_qp_solver_h -> kernel/_kernel_body: for each lane,
//   min 1/2 x'H_b x + g_b'x  s.t.  G x <= h_b   (G shared by the batch)
// by `iters` Mehrotra iterations with d capped at d_cap and Jacobi
// equilibration (mehrotra_warp.cuh). Start: cold s = max(h, 1), z = 1; or
// warm s = max(s0, eps), z = max(z0, eps) (the (B, mI) warm state is in G's
// row order). nz <= 32, mI <= 1024.
//
// What bounds it on an H100: operations by the roofline (the assembly of
// G' diag(d) G, about nz^2 mI / 2 multiply-adds a lane and iteration,
// dwarfs the bytes moved: H, g, h in; x, mu, s, z out); in practice the
// issue slots of the assembly's shared-memory reads and FMAs, and the
// latency of each lane's serial chain (factorization, sweeps).
//
// Design: a block of `warps` warps (ops/qp_kernel.narrow_launch picks it from
// mI, nz and B) stages G once in shared memory; then each warp runs its own
// lane's loop with no block barrier (mehrotra_warp.cuh), so the SM interleaves
// many independent serial chains. The per-row state stays in registers at
// mI <= 256 and moves to the warp's shared memory above.

#include <cuda_runtime.h>

#include "mehrotra_warp.cuh"

namespace {

using namespace mwarp;

constexpr int kMinBlocksPerSM = 2;   // 16 warps an SM: 128 registers a thread

template <int kN, class R>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocksPerSM)
mehrotra_h_kernel(const float* __restrict__ G, const float* __restrict__ H,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const float* __restrict__ s0, const float* __restrict__ z0,
                  float* __restrict__ x_out, float* __restrict__ mu_out,
                  float* __restrict__ s_out, float* __restrict__ z_out, int B, int mI,
                  int nz, int iters, float tau, float d_cap, float warm_eps) {
  extern __shared__ __align__(16) float smem[];
  stage_g(smem, G, mI, nz);
  __syncthreads();  // the only block barrier: G is staged
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps leave together
  const WarpMem wm = carve(smem, mI, nz, warp, 0);
  stage_h<kN>(wm, H + (size_t)b * nz * nz, lane, nz);
  for (int i = lane; i < kVec; i += 32) wm.xs[i] = wm.dxs[i] = 0.f;
  const float gl = lane < nz ? g[(size_t)b * nz + lane] : 0.f;
  R rows(wm.rows, mI, lane);
  const size_t off = (size_t)b * mI;
  for_rows<R>(lane, mI, [&](int t, int r) {
    rows.h(t) = h[off + r];
    if (s0 != nullptr) {
      rows.s(t) = fmaxf(s0[off + r], warm_eps);
      rows.z(t) = fmaxf(z0[off + r], warm_eps);
    } else {
      rows.s(t) = fmaxf(rows.h(t), 1.f);
      rows.z(t) = 1.f;
    }
  });
  __syncwarp();

  const float x = solve<kN>(smem, wm, rows, mI, nz, iters, tau, d_cap, gl, b);

  const float mu = lane_mu(rows, lane, mI);
  if (s_out != nullptr) {
    for_rows<R>(lane, mI, [&](int t, int r) {
      s_out[off + r] = rows.s(t);
      z_out[off + r] = rows.z(t);
    });
  }
  if (lane == 0) mu_out[b] = mu;
  if (lane < nz) x_out[(size_t)b * nz + lane] = x;
}

// The kernel instance for (mI, nz): kN = 8 ceil(nz / 8), the row state in
// registers up to kRegRowsMax rows.
template <class F>
auto by_shape(int mI, int nz, F&& f) {
  const bool reg = mI <= kRegRowsMax;
  switch (padded_nz(nz)) {
    case 8: return reg ? f(mehrotra_h_kernel<8, RegRows>) : f(mehrotra_h_kernel<8, SmemRows>);
    case 16: return reg ? f(mehrotra_h_kernel<16, RegRows>) : f(mehrotra_h_kernel<16, SmemRows>);
    case 24: return reg ? f(mehrotra_h_kernel<24, RegRows>) : f(mehrotra_h_kernel<24, SmemRows>);
    default: return reg ? f(mehrotra_h_kernel<32, RegRows>) : f(mehrotra_h_kernel<32, SmemRows>);
  }
}

}  // namespace

extern "C" int mehrotra_h_launch(const float* G, const float* H, const float* g,
                                 const float* h, const float* s0, const float* z0,
                                 float* x, float* mu, float* s_out, float* z_out,
                                 int B, int mI, int nz, int iters, float tau,
                                 float d_cap, float warm_eps, int warps, void* stream) {
  if (nz < 1 || nz > kNzMax || mI < 1 || mI > kMaxRows || B < 0 || iters < 0 || warps < 1
      || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = block_floats(mI, nz, warps, 0) * sizeof(float);
  const int blocks = (B + warps - 1) / warps;
  return by_shape(mI, nz, [&](auto kernel) {
    const cudaError_t st =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
    kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
        G, H, g, h, s0, z0, x, mu, s_out, z_out, B, mI, nz, iters, tau, d_cap, warm_eps);
    return (int)cudaGetLastError();
  });
}

// The dynamic shared memory of a block of `warps` lanes (bytes), and the
// lanes one SM holds then (CUDA's occupancy calculator).
extern "C" long long mehrotra_h_smem_bytes(int mI, int nz, int q, int warps) {
  (void)q;
  return (long long)(block_floats(mI, nz, warps, 0) * sizeof(float));
}

extern "C" int mehrotra_h_resident_lanes(int mI, int nz, int q, int warps) {
  (void)q;
  const size_t smem = block_floats(mI, nz, warps, 0) * sizeof(float);
  return by_shape(mI, nz, [&](auto kernel) {
    int blocks = 0;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, warps * 32, smem);
    return blocks * warps;
  });
}

extern "C" const char* mehrotra_h_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

MWARP_CLOCKS_EXPORT(mehrotra_h)
