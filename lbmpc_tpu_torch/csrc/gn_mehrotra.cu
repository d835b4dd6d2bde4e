// gn_mehrotra.cu — one launch per Gauss-Newton iteration of the LBMPC SQP:
// the GN phase and the whole Mehrotra QP loop of each lane on one warp,
// several lanes a block.
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
//   (mehrotra_warp.cuh).
// Out: e (B, ne), the QP step d (B, nz), mu (B,) and g (B, nz); H never
// leaves the warp's shared memory. The reference's causal-suffix contraction
// (lo128) is an exact restatement that the assembly does not need: it
// contracts over all rows, as K2 does.
//
// What bounds it on an H100: operations in the QP's assembly by the
// roofline, and in practice the latency of each lane's serial chain: the N
// GN stages, then each Mehrotra iteration's factorization and sweeps.
//
// Design: K2's. A block of `warps` warps stages G once; each warp stages its
// own lane's constants and window, runs K1's GN body (gn::lane, a warp a
// lane) into the lower triangle of its own shared H, mirrors it with
// Hconst added (gn::mirror_h), forms h, and runs K2's loop on the same warp,
// with no block barrier after the staging. The register count is the larger of
// the two phases' (the GN body alone wants ~200 a thread); the launch bounds
// ask for K3_MIN_BLOCKS blocks of 8 warps an SM: 2, 128 registers and 16
// lanes an SM with the GN body's excess spilled, measured 1.5x faster than 1
// (210 registers, 8 lanes an SM; tools/k2_compare.py --k3-min-blocks 1,2).

#include <cuda_runtime.h>

#include "gn_body.cuh"
#include "mehrotra_warp.cuh"

#ifndef K3_MIN_BLOCKS
#define K3_MIN_BLOCKS 2
#endif

namespace {

using namespace mwarp;

// The lane's constants, window and Jacobian rows (gn_body.cuh), in the
// warp's memory.
__host__ __device__ constexpr int window_floats(int q) { return gn::work_floats(q); }

template <int kN, class R>
__global__ void __launch_bounds__(kMaxWarps * 32, K3_MIN_BLOCKS)
gn_mehrotra_kernel(const float* __restrict__ cst, const float* __restrict__ z,
                   const float* __restrict__ dx0, const float* __restrict__ X,
                   const float* __restrict__ Y, const float* __restrict__ valid,
                   const float* __restrict__ G, const float* __restrict__ h0,
                   const float* __restrict__ Hp, float* __restrict__ e_out,
                   float* __restrict__ d_out, float* __restrict__ mu_out,
                   float* __restrict__ g_out, int B, int N, int q, int mI, int iters,
                   float tau, float d_cap) {
  extern __shared__ __align__(16) float smem[];
  const int nz = N + 1;
  const int ne = (N - 2) * gn::kStageRows + 2 * gn::kN;
  stage_g(smem, G, mI, nz);
  __syncthreads();  // the only block barrier: G is staged
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps leave together
  const WarpMem wm = carve(smem, mI, nz, warp, window_floats(q));
  const gn::LaneMem lm = gn::carve(wm.extra, q);
  const float* zb = z + (size_t)b * nz;
  const float* dxb = dx0 + (size_t)b * gn::kN;

  gn::stage(lm, cst, X, Y, valid, b, q, lane);
  for (int i = lane; i < kVec; i += 32) wm.xs[i] = wm.dxs[i] = 0.f;
  for (int i = lane; i < kN * m_stride(nz); i += 32) wm.H[i] = 0.f;  // zero past nz
  __syncwarp();
  float gl = gn::lane(lm, zb, dxb, wm.H, m_stride(nz), lane, N, q, e_out + (size_t)b * ne);
  gn::mirror_h(wm.H, m_stride(nz), cst + gn::C_HCONST, nz, lane);
  if (lane < nz) g_out[(size_t)b * nz + lane] = gl;
  else gl = 0.f;

  R rows(wm.rows, mI, lane);
  const int S = g_stride(nz);
  for_rows<R>(lane, mI, [&](int t, int r) {
    // each product and sum rounded on its own, in index order: the order of
    // ops/qp_kernel.step_rhs, which the two-launch routes use
    float hv = h0[r], gz = 0.f;
#pragma unroll
    for (int j = 0; j < gn::kN; ++j)
      hv = __fadd_rn(hv, __fmul_rn(Hp[r * gn::kN + j], dxb[j]));
    for (int c = 0; c < nz; ++c) gz = __fadd_rn(gz, __fmul_rn(smem[r * S + c], zb[c]));
    rows.h(t) = __fsub_rn(hv, gz);
    rows.s(t) = fmaxf(rows.h(t), 1.f);
    rows.z(t) = 1.f;
  });
  __syncwarp();

  const float x = solve<kN>(smem, wm, rows, mI, nz, iters, tau, d_cap, gl, b);

  const float mu = lane_mu(rows, lane, mI);
  if (lane == 0) mu_out[b] = mu;
  if (lane < nz) d_out[(size_t)b * nz + lane] = x;
}

// The kernel instance for (mI, nz): kN = 8 ceil(nz / 8), the row state in
// registers up to kRegRowsMax rows.
template <class F>
auto by_shape(int mI, int nz, F&& f) {
  const bool reg = mI <= kRegRowsMax;
  switch (padded_nz(nz)) {
    case 8: return reg ? f(gn_mehrotra_kernel<8, RegRows>) : f(gn_mehrotra_kernel<8, SmemRows>);
    case 16:
      return reg ? f(gn_mehrotra_kernel<16, RegRows>) : f(gn_mehrotra_kernel<16, SmemRows>);
    case 24:
      return reg ? f(gn_mehrotra_kernel<24, RegRows>) : f(gn_mehrotra_kernel<24, SmemRows>);
    default:
      return reg ? f(gn_mehrotra_kernel<32, RegRows>) : f(gn_mehrotra_kernel<32, SmemRows>);
  }
}

}  // namespace

extern "C" int gn_mehrotra_launch(const float* cst, const float* z, const float* dx0,
                                  const float* X, const float* Y, const float* valid,
                                  const float* G, const float* h0, const float* Hp,
                                  float* e, float* d, float* mu, float* g, int B, int N,
                                  int q, int mI, int iters, float tau, float d_cap,
                                  int warps, void* stream) {
  if (N < 3 || N + 1 > gn::kNzMax || q < 1 || mI < 1 || mI > kMaxRows || B < 0 || iters < 0
      || warps < 1 || warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = block_floats(mI, N + 1, warps, window_floats(q)) * sizeof(float);
  const int blocks = (B + warps - 1) / warps;
  return by_shape(mI, N + 1, [&](auto kernel) {
    const cudaError_t st =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
    kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
        cst, z, dx0, X, Y, valid, G, h0, Hp, e, d, mu, g, B, N, q, mI, iters, tau, d_cap);
    return (int)cudaGetLastError();
  });
}

// The dynamic shared memory of a block of `warps` lanes (bytes), and the
// lanes one SM holds then (CUDA's occupancy calculator).
extern "C" long long gn_mehrotra_smem_bytes(int mI, int nz, int q, int warps) {
  return (long long)(block_floats(mI, nz, warps, window_floats(q)) * sizeof(float));
}

extern "C" int gn_mehrotra_resident_lanes(int mI, int nz, int q, int warps) {
  const size_t smem = block_floats(mI, nz, warps, window_floats(q)) * sizeof(float);
  return by_shape(mI, nz, [&](auto kernel) {
    int blocks = 0;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, warps * 32, smem);
    return blocks * warps;
  });
}

extern "C" const char* gn_mehrotra_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

MWARP_CLOCKS_EXPORT(gn_mehrotra)
