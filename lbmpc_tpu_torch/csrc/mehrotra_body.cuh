// mehrotra_body.cuh — the block-wide pieces of a Mehrotra iteration for one
// lane on one 256-thread block, which K2w and K3w (mehrotra_wide.cuh) run:
// the constants, the warp and block reductions, the step-length ratio test
// and mu. One thread per constraint row keeps that row's state in registers
// (up to kRowsPerThread rows a thread for mI <= 1024); step lengths are
// block min-reductions and mu a block sum (block_reduce2: each warp by a
// butterfly, then the 8 warp values by a butterfly on warp 0), the order
// mehrotra_warp.cuh's block_order_sum reproduces for K2 and K3.

#pragma once

#include <cuda_runtime.h>

namespace mehrotra {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 4;                 // mI <= 1024
constexpr int kMaxRows = kThreads * kRowsPerThread;
constexpr int kNzMax = 32;                        // the factorization is one warp
constexpr float kBig = 1e6f;                      // ratio-test sentinel
constexpr float kRidge = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Block-wide (sum, sum) or (min, min) of two values; every thread gets both.
template <bool kMin>
__device__ __forceinline__ float2 block_reduce2(float a, float b, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = kMin ? warp_min(a) : warp_sum(a);
  b = kMin ? warp_min(b) : warp_sum(b);
  if (lane == 0) {
    red[2 * warp] = a;
    red[2 * warp + 1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const float ident = kMin ? kBig : 0.f;
    a = lane < kWarps ? red[2 * lane] : ident;
    b = lane < kWarps ? red[2 * lane + 1] : ident;
    a = kMin ? warp_min(a) : warp_sum(a);
    b = kMin ? warp_min(b) : warp_sum(b);
    if (lane == 0) {
      red[2 * kWarps] = a;
      red[2 * kWarps + 1] = b;
    }
  }
  __syncthreads();
  return make_float2(red[2 * kWarps], red[2 * kWarps + 1]);
}

// Block min over the rows of the step ratio (-v / dv where dv < 0, else BIG)
// for the primal (s, ds) and dual (z, dz) pairs; `rz_extra` enters the dual
// minimum (BIG where no other row does).
__device__ __forceinline__ float2 ratio_min(int mI, const float (&s)[kRowsPerThread],
                                            const float (&ds)[kRowsPerThread],
                                            const float (&z)[kRowsPerThread],
                                            const float (&dz)[kRowsPerThread],
                                            float rz_extra, float* red) {
  float rs = kBig, rz = rz_extra;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    const int r = threadIdx.x + t * kThreads;
    if (r < mI) {
      rs = fminf(rs, ds[t] < 0.f ? -s[t] / ds[t] : kBig);
      rz = fminf(rz, dz[t] < 0.f ? -z[t] / dz[t] : kBig);
    }
  }
  return block_reduce2<true>(rs, rz, red);
}

// mu = sum_r s_r z_r / mI (block sum, every thread gets it).
__device__ __forceinline__ float block_mu(int mI, const float (&s)[kRowsPerThread],
                                          const float (&z)[kRowsPerThread], float* red) {
  float part = 0.f;
#pragma unroll
  for (int t = 0; t < kRowsPerThread; ++t) {
    if (threadIdx.x + t * kThreads < mI) part += s[t] * z[t];
  }
  return block_reduce2<false>(part, 0.f, red).x * (1.f / (float)mI);
}

}  // namespace mehrotra
