// gn_wide.cu — the Gauss-Newton phase of the LBMPC SQP at any nz <= 128,
// both families, one warp a lane and several lanes a block (K1w).
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_gn.py, build_pallas_gn_kernel
// -> kernel/_body, over the part of its domain that gn_phase.cu (K1: the
// fmincon family at nz <= 32) does not take: the casadi family (the DMS
// flagship, N=100, nz=101) and the fmincon family above nz 32 (LBMPC_N40
// uncut, nz=41). For each lane: the N-step learned rollout through the
// Nadaraya-Watson (NW) oracle window, the sensitivities S_k = dx_k/dz, the
// residual stack e and the Gauss-Newton normal terms H = 2 J'J + Hconst and
// g = 2 J'e. The function, the two families and the constant block are
// gn_wide_body.cuh's (gnw::lane, which K3w runs on a block); this kernel
// returns that function's bits on one warp: every sum takes its terms in
// gnw::lane's order, and the kernel is built, like K3w, with -fmad=false
// (ops/_cuda.py WIDE_FLAGS), so the compiler fuses no multiply-add in either.
//
// What bounds it on an H100: by its roofline, the float32 arithmetic of the
// NW sums (q exps and ~25 operations per window point per stage) and of the
// rank-5 updates of H; in practice the N sequential stages of each lane,
// and in each the H update's instructions (~28 an entry of the causal
// triangle: 40 % of a stage at LBMPC_N40, 70 % at the DMS flagship, by
// tools/k1w_k5_compare.py's phase clocks), then the NW sums. So the design
// keeps a stage free of block barriers and runs many lanes' chains on each
// SM.
//
// Design: a warp a lane, `lanes` lanes a block (the host's
// ops/gn_kernel.wide_launch picks them from nz, q and B); the block stages
// the constants once, the only block barrier. Lane l of the warp owns the
// decision columns c = l + 32 j (j < NC = ceil(nz / 32), a template width):
// S_k[:, c], du_k/dz[c] and g[c] sit in its registers. A stage's 20 NW sums
// keep gnw::lane's association on T = gnw::threads(nz) threads: lane l sums
// the points of each virtual warp w (p = l + 32 w + j T) apart, each virtual
// warp's 20 partials close with the butterfly's xor pairings run as a
// reduce-scatter (21 shuffles for 20 sums, gn_body.cuh's reduce_scatter), and the
// virtual warps add in order from 0.f. The stage's Jacobian rows go through
// the warp's shared buffer D; only H's lower triangle is accumulated, packed
// row by row in the warp's shared memory: at stage k the entries of the
// causal rows (a prefix of the packed triangle) spread evenly over the
// lanes, each from the same terms in the same order as gnw::lane. At the
// end H is mirrored into (B, nz, nz) row-major, exactly symmetric, with
// Hconst added as gn_wide_body.cuh reads it: the layout the Mehrotra kernels
// (mehrotra_h_wide.cu) read as it is.

#include <cuda_runtime.h>

#include "gn_wide_body.cuh"

namespace {

using gn::kFull;
using gn::reduce_scatter;   // the butterfly's pairings (gn_body.cuh)
using gn::rs_lane;
using gn::tri;
constexpr int kN = gnw::kN;
constexpr int kSums = gnw::kSums;
constexpr int kMaxLanes = 8;            // lanes (warps) a block
// Blocks of kMaxLanes an SM that the registers must allow, by the template
// width NC: 3 up to nz = 64 (24 lanes an SM, <= 85 registers: ~80, a few
// bytes spilled; the N40 fleet's 8192 lanes take 3 waves, not 4), 2 above
// (16 lanes an SM, <= 128 registers; shared memory holds the DMS flagship
// to 8 lanes an SM anyway). K1W_MIN_BLOCKS sets one value for every width
// (tools/k1w_k5_compare.py builds such variants).
__host__ __device__ constexpr int min_blocks(int nc) {
#ifdef K1W_MIN_BLOCKS
  return K1W_MIN_BLOCKS + 0 * nc;
#else
  return nc <= 2 ? 3 : 2;
#endif
}
constexpr int kConst = gnw::C_HCONST;   // the scalar constants, staged once a block

// Phase clocks, for tools/k1w_k5_compare.py only: built with
// K1W_PHASE_CLOCKS, lane 0 of each warp adds the clock64() cycles of every
// phase of every stage into kClockSlots counters (each stamp converges the
// warp first) and stores them in k1w_clocks[lane * kClockSlots + phase];
// `gn_wide_clocks(out, lanes)` copies the first `lanes` lanes' to the host.
// The package's build never defines the macro, and then Clock is empty.
enum ClockPhase { kClkNW, kClkSolve, kClkRows, kClkH, kClkState, kClkEnd, kClkTotal,
                  kClockSlots };
#ifdef K1W_PHASE_CLOCKS
constexpr int kClockLanes = 16384;
__device__ unsigned long long k1w_clocks[kClockLanes * kClockSlots];
struct Clock {
  long long last, first;
  unsigned long long acc[kClockSlots];
  __device__ __forceinline__ void start() {
    __syncwarp();
    last = first = clock64();
#pragma unroll
    for (int p = 0; p < kClockSlots; ++p) acc[p] = 0;
  }
  __device__ __forceinline__ void mark(int p) {
    __syncwarp();
    const long long t = clock64();
    acc[p] += t - last;
    last = t;
  }
  __device__ __forceinline__ void store(int b) {
    acc[kClkTotal] = clock64() - first;
    if ((threadIdx.x & 31) == 0 && b < kClockLanes) {
#pragma unroll
      for (int p = 0; p < kClockSlots; ++p) k1w_clocks[b * kClockSlots + p] = acc[p];
    }
  }
};
#else
struct Clock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void store(int) {}
};
#endif

// Floats of one lane's shared memory: D rows 0..3 (a float4 a column), the
// window (q points of 8 floats), D row 4, and H's packed lower triangle;
// rounded to 4 so the next lane's float4s stay aligned.
__host__ __device__ constexpr size_t lane_floats(int nz, int q) {
  return ((size_t)5 * nz + 8 * (size_t)q + tri(nz) + 3) / 4 * 4;
}

size_t smem_bytes(int nz, int q, int lanes) {
  return (kConst + lanes * lane_floats(nz, q)) * sizeof(float);
}

// H += 2 sum_r D_r D_r' over the packed lower triangle's first E entries,
// lane-strided; (i, c) is the row and column of the lane's first entry, and
// each step of 32 entries walks along the rows. Entry (i, c) takes a =
// sum_r D_r[i] D_r[c] from 0.f in r order, as gnw::add_outer takes it for
// (i, c) and (c, i).
template <int R>
__device__ __forceinline__ void add_rows(float* H, const float4* Dv, const float* D4, int E,
                                         int lane, int i, int c) {
  for (int e = lane; e < E; e += 32) {
    const float4 di = Dv[i], dc = Dv[c];
    float a = 0.f;
    a += di.x * dc.x;
    a += di.y * dc.y;
    a += di.z * dc.z;
    a += di.w * dc.w;
    if (R > kN) a += D4[i] * D4[c];
    H[e] += 2.f * a;
    c += 32;
    while (c > i) {
      c -= i + 1;
      ++i;
    }
  }
}

template <bool kCasadi, int NC>
__global__ void __launch_bounds__(kMaxLanes * 32, min_blocks(NC))
gn_wide_kernel(const float* __restrict__ cst, const float* __restrict__ z,
               const float* __restrict__ dx0, const float* __restrict__ X,
               const float* __restrict__ Y, const float* __restrict__ valid,
               float* __restrict__ e_out, float* __restrict__ H_out,
               float* __restrict__ g_out, int B, int N, int q) {
  constexpr int V = gnw::threads(32 * NC) / 32;  // gnw::lane's warps: the NW sums' order
  constexpr int T = 32 * V;
  constexpr int R = kCasadi ? kN : kN + 1;       // rows with a per-lane Jacobian
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < kConst; i += blockDim.x) smem[i] = cst[i];
  __syncthreads();  // the only block barrier: the constants are staged
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // whole warps leave together
  const float* cs = smem;
  const int nz = N + 1;
  const int n_run = kCasadi ? N : N - 2;
  const int ne = n_run * (kN + 1) + 2 * kN;
  float* lm = smem + kConst + (size_t)warp * lane_floats(nz, q);
  float4* Dv = reinterpret_cast<float4*>(lm);
  float* win = lm + 4 * nz;
  float* D4 = win + 8 * q;
  float* H = D4 + nz;
  const float4* win4 = reinterpret_cast<const float4*>(win);
  gn::stage_window(win, X, Y, valid, b, q, lane, 32);
  for (int e = lane; e < tri(nz); e += 32) H[e] = 0.f;
  const float* zb = z + (size_t)b * nz;
  float* eb = e_out + (size_t)b * ne;
  // the row and column of the lane's first entry of the packed triangle
  int i0 = 0;
  while (tri(i0 + 1) <= lane) ++i0;
  const int c0 = lane - tri(i0);
  __syncwarp();
  Clock clk;
  clk.start();

  const float Lr = cs[gnw::C_LR], PSI = cs[gnw::C_PSI], sqrtT = cs[gnw::C_SQRTT];
  const float inv_bw2 = cs[gnw::C_INVBW2], ridge = cs[gnw::C_RIDGE], sqd = cs[gnw::C_SQD];
  const float* A = cs + gnw::C_A;
  const float* Bv = cs + gnw::C_B;
  const float* Ks = cs + gnw::C_KS;
  const float* Lq = cs + gnw::C_LQ;
  const float* Lp = cs + gnw::C_LP;
  const float* LAM = cs + gnw::C_LAM;
  const float* xsr = cs + gnw::C_XSREF;

  const float theta = zb[N];
  float xa[kN], x[kN], S[NC][kN], gacc[NC], lam[NC];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    xa[i] = LAM[i] * theta;
    x[i] = dx0[(size_t)b * kN + i];
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int i = 0; i < kN; ++i) S[j][i] = 0.f;
    gacc[j] = 0.f;
    lam[j] = (lane + 32 * j == N) ? 1.f : 0.f;  // theta column indicator
  }
  const float ua = PSI * theta;

  for (int k = 0; k < N; ++k) {
    float u, dudz[NC];
    if (kCasadi) {
      u = zb[k];
#pragma unroll
      for (int j = 0; j < NC; ++j) dudz[j] = (lane + 32 * j == k) ? 1.f : 0.f;
    } else {
      u = Ks[0] * x[0] + Ks[1] * x[1] + Ks[2] * x[2] + Ks[3] * x[3] + zb[k];
#pragma unroll
      for (int j = 0; j < NC; ++j)
        dudz[j] = Ks[0] * S[j][0] + Ks[1] * S[j][1] + Ks[2] * S[j][2] + Ks[3] * S[j][3]
                  + ((lane + 32 * j == k) ? 1.f : 0.f);
    }

    // NW oracle at xi = (x0, x1, u): gnw::lane's 20 sums, its thread l + 32 w
    // (virtual warp w) summing the points l + 32 w + j T
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < V; ++w) {
      float acc[kSums];
#pragma unroll
      for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
      for (int p = lane + 32 * w; p < q; p += T) {
        const float4 w0 = win4[2 * p], w1 = win4[2 * p + 1];
        const float yv[kN] = {w0.w, w1.x, w1.y, w1.z};
        const float d0 = w0.x - x[0], d1 = w0.y - x[1], d2 = w0.z - u;
        const float sq = d0 * d0 + d1 * d1 + d2 * d2;
        const float kv = expf(-sq * inv_bw2) * w1.w;
        acc[0] += kv;
        acc[5] += kv * d0;
        acc[6] += kv * d1;
        acc[7] += kv * d2;
#pragma unroll
        for (int o = 0; o < kN; ++o) {
          const float ky = kv * yv[o];
          acc[1 + o] += ky;
          acc[8 + 3 * o] += ky * d0;
          acc[9 + 3 * o] += ky * d1;
          acc[10 + 3 * o] += ky * d2;
        }
      }
      tot += reduce_scatter(acc, lane);
    }
    clk.mark(kClkNW);
    const float denom = ridge + __shfl_sync(kFull, tot, rs_lane(0));
    const float quot = tot / denom;  // sum rs_lane^-1(lane) / denom
    float yhat[kN], s1[3], Jg[kN][3];
#pragma unroll
    for (int d = 0; d < 3; ++d) s1[d] = __shfl_sync(kFull, quot, rs_lane(5 + d));
#pragma unroll
    for (int o = 0; o < kN; ++o) {
      yhat[o] = __shfl_sync(kFull, quot, rs_lane(1 + o));
#pragma unroll
      for (int d = 0; d < 3; ++d)
        Jg[o][d] = 2.f * inv_bw2
                   * (__shfl_sync(kFull, quot, rs_lane(8 + 3 * o + d)) - yhat[o] * s1[d]);
    }
    clk.mark(kClkSolve);

    // residual + Jacobian rows at stage k use the pre-update state
    if (k < n_run) {
      float er[kN + 1];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        float ev = 0.f;
#pragma unroll
        for (int j = 0; j < kN; ++j) ev += Lq[i * kN + j] * (x[j] - xa[j]);
        er[i] = kCasadi ? sqd * ev : ev;
      }
      er[kN] = Lr * (u - ua);
      if (kCasadi) er[kN] = sqd * er[kN];
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kN; ++i) eb[k * kN + i] = er[i];
        eb[n_run * kN + k] = er[kN];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float Dr[kN + 1];
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          float dv = 0.f;
#pragma unroll
          for (int jj = 0; jj < kN; ++jj) dv += Lq[i * kN + jj] * (S[j][jj] - LAM[jj] * lam[j]);
          Dr[i] = kCasadi ? sqd * dv : dv;
        }
        Dr[kN] = Lr * (dudz[j] - PSI * lam[j]);
        if (kCasadi) Dr[kN] = sqd * Dr[kN];
        const int c = lane + 32 * j;
        if (c < nz) {
#pragma unroll
          for (int r = 0; r <= kN; ++r) gacc[j] += 2.f * er[r] * Dr[r];
          Dv[c] = make_float4(Dr[0], Dr[1], Dr[2], Dr[3]);
          if (!kCasadi) D4[c] = Dr[kN];
        }
      }
      clk.mark(kClkRows);
      __syncwarp();
      // causal entries of this stage's rows: columns c <= hi (fmincon: du/dz
      // has column k; casadi: S_k only) and theta; rows 0..hi, then row N
      const int hi = kCasadi ? k - 1 : k;
      add_rows<R>(H, Dv, D4, tri(hi + 1), lane, i0, c0);
      const float4 dn = Dv[N];
      for (int t = lane; t <= hi + 1; t += 32) {
        const int c = t <= hi ? t : N;
        const float4 dc = Dv[c];
        float a = 0.f;
        a += dn.x * dc.x;
        a += dn.y * dc.y;
        a += dn.z * dc.z;
        a += dn.w * dc.w;
        if (R > kN) a += D4[N] * D4[c];
        H[tri(N) + c] += 2.f * a;
      }
      __syncwarp();
      clk.mark(kClkH);
    }

    // state + sensitivity update (dxi/dz = [S_0, S_1, du/dz])
    float xn[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float xv = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) xv += A[i * kN + j] * x[j];
      xn[i] = xv + Bv[i] * u + yhat[i];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float Sn[kN];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        float sv = 0.f;
#pragma unroll
        for (int jj = 0; jj < kN; ++jj) sv += A[i * kN + jj] * S[j][jj];
        Sn[i] = sv + Bv[i] * dudz[j] + Jg[i][0] * S[j][0] + Jg[i][1] * S[j][1]
                + Jg[i][2] * dudz[j];
      }
#pragma unroll
      for (int i = 0; i < kN; ++i) S[j][i] = Sn[i];
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) x[i] = xn[i];
    clk.mark(kClkState);
  }

  // terminal rows: rP = Lp (x_N - xa), every column; rT = sqrtT (xa -
  // xs_ref), whose constant Jacobian rows live in Hconst (g term only)
  const int base = n_run * (kN + 1);
  float er[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float ev = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) ev += Lp[i * kN + j] * (x[j] - xa[j]);
    er[i] = ev;
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float Dr[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float dv = 0.f;
#pragma unroll
      for (int jj = 0; jj < kN; ++jj) dv += Lp[i * kN + jj] * (S[j][jj] - LAM[jj] * lam[j]);
      Dr[i] = dv;
    }
    const int c = lane + 32 * j;
    if (c < nz) {
      Dv[c] = make_float4(Dr[0], Dr[1], Dr[2], Dr[3]);
#pragma unroll
      for (int r = 0; r < kN; ++r) gacc[j] += 2.f * er[r] * Dr[r];
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float rT = sqrtT * (xa[i] - xsr[i]);
    if (lane == 0) {
      eb[base + i] = er[i];
      eb[base + kN + i] = rT;
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) gacc[j] += 2.f * rT * (sqrtT * LAM[i] * lam[j]);
  }
  __syncwarp();
  add_rows<kN>(H, Dv, D4, tri(nz), lane, i0, c0);
  __syncwarp();

  // H = 2 J'J + Hconst, mirrored; Hconst read at (min, max) as gn_wide_body.cuh
  // reads it, so H stays symmetric
  const float* Hc = cst + gnw::C_HCONST;
  float* Hb = H_out + (size_t)b * nz * nz;
#pragma unroll 4
  for (int i = 0; i < nz; ++i) {  // unrolled: several rows' Hconst loads in flight
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int j = lane + 32 * jj;
      if (j < nz) {
        const int lo = min(i, j), hi = max(i, j);
        Hb[i * nz + j] = H[tri(hi) + lo] + __ldg(Hc + lo * nz + hi);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j)
    if (lane + 32 * j < nz) g_out[(size_t)b * nz + lane + 32 * j] = gacc[j];
  clk.mark(kClkEnd);
  clk.store(b);
}

// f(kernel) for the instance at (family, nz).
template <bool kCasadi, class F>
int by_width(int nz, F&& f) {
  switch ((nz + 31) / 32) {
    case 1: return f(gn_wide_kernel<kCasadi, 1>);
    case 2: return f(gn_wide_kernel<kCasadi, 2>);
    case 3: return f(gn_wide_kernel<kCasadi, 3>);
    default: return f(gn_wide_kernel<kCasadi, 4>);
  }
}

template <class F>
int by_shape(int nz, bool casadi, F&& f) {
  return casadi ? by_width<true>(nz, f) : by_width<false>(nz, f);
}

bool valid(int N, int q, int casadi, int lanes) {
  return N >= (casadi ? 1 : 3) && N + 1 <= gnw::kNzMax && q >= 1 && lanes >= 1
         && lanes <= kMaxLanes;
}

}  // namespace

extern "C" int gn_wide_launch(const float* cst, const float* z, const float* dx0,
                              const float* X, const float* Y, const float* valid_,
                              float* e, float* H, float* g, int B, int N, int q, int casadi,
                              int lanes, void* stream) {
  if (!valid(N, q, casadi, lanes) || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(N + 1, q, lanes);
  return by_shape(N + 1, casadi, [&](auto kernel) {
    const cudaError_t st =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
    kernel<<<(B + lanes - 1) / lanes, lanes * 32, smem, (cudaStream_t)stream>>>(
        cst, z, dx0, X, Y, valid_, e, H, g, B, N, q);
    return (int)cudaGetLastError();
  });
}

// The dynamic shared memory of a block of `lanes` lanes (bytes);
// ops/gn_kernel.wide_smem_bytes is held to it.
extern "C" long long gn_wide_smem_bytes(int nz, int q, int lanes) {
  return (long long)smem_bytes(nz, q, lanes);
}

// The lanes one SM holds in blocks of `lanes` lanes (CUDA's occupancy
// calculator), -1 where the kernel does not take the shape.
extern "C" int gn_wide_resident_lanes(int nz, int q, int lanes, int casadi) {
  if (!valid(nz - 1, q, casadi, lanes)) return -1;
  const size_t smem = smem_bytes(nz, q, lanes);
  return by_shape(nz, casadi, [&](auto kernel) {
    int blocks = 0;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, lanes * 32, smem);
    return blocks * lanes;
  });
}

extern "C" const char* gn_wide_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef K1W_PHASE_CLOCKS
extern "C" int gn_wide_clocks(unsigned long long* out, int lanes) {
  if (lanes < 0 || lanes > kClockLanes) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, k1w_clocks,
                                   (size_t)lanes * kClockSlots * sizeof(unsigned long long));
}
#endif
