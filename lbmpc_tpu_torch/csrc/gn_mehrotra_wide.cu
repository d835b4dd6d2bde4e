// gn_mehrotra_wide.cu — one launch per Gauss-Newton iteration of the LBMPC
// SQP above nz 32 and for the casadi family: the GN phase and the whole
// Mehrotra QP loop of each lane in one block (K3w).
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_gn.py, build_pallas_gn_kernel
// with ipm=dict(iters, d_cap) -> kernel_ipm/_ipm_body, over the part of its
// domain that gn_mehrotra.cu (K3: the fmincon family at nz <= 32) does not
// take: the fmincon family at 32 < nz <= 128 (LBMPC_N40 uncut, nz=41;
// LBMPC_N50, nz=51) and the casadi family at nz <= 128, mI <= 1024, wherever
// the reference's own scoped-VMEM model lets its kernel launch
// (controllers/sqp_fused._check_route). For each lane:
// - the GN phase exactly as gn_wide.cu (K1w): residual e,
//   H = 2 J'J + Hconst and g = 2 J'e (gn_wide_body.cuh), run by the first
//   gnw::threads(nz) threads of the block, the others waiting at its
//   barriers, so its sums add in K1w's order;
// - the QP's constraint right-hand side in step space,
//   h = (h0 + Hp dx0) - G z_bar, each row's terms rounded on their own and
//   added in index order, as ops/qp_kernel.step_rhs forms it for the
//   two-launch routes (gn_mehrotra.cu's order);
// - a cold Mehrotra loop on (H, g, G, h) exactly as mehrotra_h_wide.cu
//   (K2w): x = 0, s = max(h, 1), z = 1 (mehrotra_wide.cuh).
// Out: e (B, ne), the QP step d (B, nz), mu (B,) and g (B, nz); H never
// leaves the block. So K3w equals K1w, then step_rhs, then K2w cold, bit for
// bit.
//
// What bounds it on an H100: by its roofline, operations — K2w's assembly
// of G' diag(d) G over G's structural nonzeros and K1w's NW sums; in
// practice the latency of each lane's serial chain: the N GN stages (two
// block barriers each), then each Mehrotra iteration's assembly, panel
// factorization and blocked sweeps (mehrotra_wide.cuh).
//
// Design: one 256-thread block per lane (K2w's block). The shared memory is
// K2w's carve (the G ring, H, M, the row vectors) followed by K1w's window,
// Jacobian rows and reduction slots; the GN body accumulates 2 J'J straight
// into K2w's H, which gets Hconst added in place, and g goes to K2w's g: no
// round trip through device memory, no second launch. G stays in device
// memory (L2-resident, shared by every block), read through K2w's host plan
// of its structure (ops/qp_kernel.WidePlan). The register tile of K2w's
// assembly is a template parameter chosen by nz (3, 5, 7, 8), and so is the
// family. __launch_bounds__ asks for two blocks an SM, as K2w does: 128
// registers a thread, where the GN body alone would take ~167, so some of it
// spills; at one block an SM (K3W_MIN_BLOCKS=1, no spill) the Mehrotra loop,
// which sets the time, runs at half the occupancy and takes ~1.7x as long
// (tools/k3w_launch_bounds.py). Like K1w and K2w it is built with
// -fmad=false (ops/_cuda.py WIDE_FLAGS), so the compiler contracts no
// multiply-add differently here than in those two kernels.

#include <cuda_runtime.h>

#include <type_traits>

#include "gn_wide_body.cuh"
#include "mehrotra_wide.cuh"

namespace {

using namespace mehrotra_wide;

#ifndef K3W_MIN_BLOCKS
#define K3W_MIN_BLOCKS 2
#endif

// K1w's scratch beyond H: the window, the stage's Jacobian rows, the NW
// partials (gn_wide_body.cuh carve)
__host__ __device__ constexpr size_t gn_floats(int q) {
  return (size_t)q * 8 + 2 * gnw::kMaxRows * gnw::kNzMax + 2 * gnw::kMaxWarps * gnw::kSums;
}

template <bool kCasadi, int kT>
__global__ void __launch_bounds__(kThreads, K3W_MIN_BLOCKS)
gn_mehrotra_wide_kernel(const float* __restrict__ cst, const float* __restrict__ z,
                        const float* __restrict__ dx0, const float* __restrict__ X,
                        const float* __restrict__ Y, const float* __restrict__ valid,
                        const float* __restrict__ Gp, const float* __restrict__ GpT,
                        const int* __restrict__ meta,
                        const float* __restrict__ h0,
                        const float* __restrict__ Hp, float* __restrict__ e_out,
                        float* __restrict__ d_out, float* __restrict__ mu_out,
                        float* __restrict__ g_out, int N, int q, int mI, int iters,
                        float tau, float d_cap) {
  extern __shared__ __align__(16) float smem[];
  const int nz = N + 1;
  const int n_run = kCasadi ? N : N - 2;
  const int ne = n_run * (gnw::kN + 1) + 2 * gnw::kN;
  const Shared sh = carve(smem, mI, nz);
  const Plan P = make_plan(Gp, GpT, meta, mI, nz);
  gnw::Shared gs;
  gs.win = smem + shared_floats(mI, nz);
  gs.H = sh.H;
  gs.D = gs.win + q * 8;
  gs.red = gs.D + 2 * gnw::kMaxRows * gnw::kNzMax;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const float* zb = z + b * nz;
  const float* dxb = dx0 + b * gnw::kN;

  gn::stage_window(gs.win, X, Y, valid, b, q, tid, kThreads);
  if (tid < kNzMax) sh.x[tid] = sh.dx[tid] = 0.f;
  __syncthreads();
  const float gacc = gnw::lane<kCasadi>(gs, cst, zb, dxb, N, q, e_out + b * ne,
                                        gnw::threads(nz));
  // H = 2 J'J + Hconst in place, Hconst read at (min, max) as gn_wide.cu
  // writes it: the H that K2w would read from device memory
  const float* Hc = cst + gnw::C_HCONST;
  for (int e = tid; e < nz * nz; e += kThreads) {
    const int i = e / nz, j = e - i * nz;
    sh.H[e] = sh.H[e] + Hc[i <= j ? e : j * nz + i];
  }
  if (tid < nz) {
    sh.g[tid] = gacc;
    g_out[b * nz + tid] = gacc;
  }

  float s[kRowsPerThread], zr[kRowsPerThread], hr[kRowsPerThread];
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = tid + t * kThreads;
    s[t] = zr[t] = hr[t] = 0.f;
    if (r < mI) {
      // each product and sum rounded on its own, in index order: the
      // order of ops/qp_kernel.step_rhs, which the two-launch routes use
      const float* gr = P.Gp + (size_t)r * P.ld;
      float hv = h0[r], gz = 0.f;
#pragma unroll
      for (int j = 0; j < gnw::kN; ++j)
        hv = __fadd_rn(hv, __fmul_rn(Hp[r * gnw::kN + j], dxb[j]));
      for (int c = 0; c < nz; ++c) gz = __fadd_rn(gz, __fmul_rn(gr[c], zb[c]));
      hr[t] = __fsub_rn(hv, gz);
      s[t] = fmaxf(hr[t], 1.f);
      zr[t] = 1.f;
    }
  }
  __syncthreads();

  solve<kT>(sh, P, mI, nz, iters, tau, d_cap, s, zr, hr);

  const float mu = mehrotra::block_mu(mI, s, zr, sh.red);
  if (tid == 0) mu_out[b] = mu;
  if (tid < nz) d_out[b * nz + tid] = sh.x[tid];
}

template <bool kCasadi, int kT>
int launch(const float* cst, const float* z, const float* dx0, const float* X, const float* Y,
           const float* valid, const float* Gp, const float* GpT, const int* meta,
           const float* h0, const float* Hp, float* e, float* d, float* mu, float* g, int B,
           int N, int q, int mI, int iters, float tau, float d_cap, void* stream) {
  const size_t smem = (shared_floats(mI, N + 1) + gn_floats(q)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(gn_mehrotra_wide_kernel<kCasadi, kT>,
                                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  gn_mehrotra_wide_kernel<kCasadi, kT><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      cst, z, dx0, X, Y, valid, Gp, GpT, meta, h0, Hp, e, d, mu, g, N, q, mI, iters, tau,
      d_cap);
  return (int)cudaGetLastError();
}

template <bool kCasadi>
int launch_tile(const float* cst, const float* z, const float* dx0, const float* X,
                const float* Y, const float* valid, const float* Gp, const float* GpT,
                const int* meta, const float* h0, const float* Hp, float* e, float* d,
                float* mu, float* g, int B, int N, int q, int mI, int iters, float tau,
                float d_cap, void* stream) {
  const int nz = N + 1;
  const auto run = [&](auto tile) {
    return launch<kCasadi, decltype(tile)::value>(cst, z, dx0, X, Y, valid, Gp, GpT, meta,
                                                  h0, Hp, e, d, mu, g, B, N, q, mI, iters,
                                                  tau, d_cap, stream);
  };
  if (nz <= 3 * kTile) return run(std::integral_constant<int, 3>());
  if (nz <= 5 * kTile) return run(std::integral_constant<int, 5>());
  if (nz <= 7 * kTile) return run(std::integral_constant<int, 7>());
  return run(std::integral_constant<int, 8>());
}

}  // namespace

extern "C" int gn_mehrotra_wide_launch(const float* cst, const float* z, const float* dx0,
                                       const float* X, const float* Y, const float* valid,
                                       const float* Gp, const float* GpT, const int* meta,
                                       const float* h0, const float* Hp, float* e, float* d,
                                       float* mu, float* g, int B, int N, int q, int mI,
                                       int iters, float tau, float d_cap, int casadi,
                                       void* stream) {
  if (N < (casadi ? 1 : 3) || N + 1 > kNzMax || q < 1 || mI < 1 || mI > kMaxRows || B < 0
      || iters < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  return casadi ? launch_tile<true>(cst, z, dx0, X, Y, valid, Gp, GpT, meta, h0, Hp, e, d,
                                    mu, g, B, N, q, mI, iters, tau, d_cap, stream)
                : launch_tile<false>(cst, z, dx0, X, Y, valid, Gp, GpT, meta, h0, Hp, e,
                                     d, mu, g, B, N, q, mI, iters, tau, d_cap, stream);
}

K2W_CLOCKS_EXPORT(gn_mehrotra_wide)

extern "C" const char* gn_mehrotra_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
