// mehrotra.cu — a fixed-iteration Mehrotra predictor-corrector QP with one H
// and one G shared by the batch (K4): four warps a lane, several lanes a
// block.
//
// Replaces the TPU kernel lbmpc_tpu/ops/pallas_ipm.py, build_pallas_qp_solver
// -> kernel: for each lane,
//   min 1/2 x'H x + g_b'x  s.t.  G x <= h_b   (H, G shared by the batch)
// by `iters` Mehrotra iterations from x = 0, s = max(h, 1), z = 1, with
// d = min(z / max(s, 1e-25), d_cap), M = G' diag(d) G + H + 1e-6 I and no
// equilibration, Cholesky with the pivot floor sqrt(max(., 1e-30)), two
// triangular solves each for the predictor and the corrector, sigma =
// (mu_aff / max(mu, 1e-25))^3, ratio tests with the 1e6 sentinel, the step
// fraction tau and mu over the mI rows. The reference pads mI to a multiple
// of 128 with rows G = 0, h = 1e6, s = 1e6, z = 1 that enter its dual ratio
// tests: all of them stay equal, so they are carried as one virtual row
// when mI is not such a multiple. Out: x, the converged flag mu < 2e-4 (1 +
// mu mI) and max_r |G x + s - h|_r < 2e-3 over the real rows
// (pallas_ipm.py:769-775), false where either side is NaN, and mu. nz <= 32,
// mI <= 1024.
//
// What bounds it on an H100: operations by the roofline (the assembly of
// G' diag(d) G, ~nz^2 mI / 2 multiply-adds a lane and iteration, and six
// G / G' products); in practice the shared-memory reads and FMAs of the
// assembly, and each lane's serial chain (the nz x nz factorization and four
// triangular sweeps on one warp), which the lanes an SM holds must hide.
//
// Design: a block of `lanes` lanes (ops/qp_kernel.shared_launch picks them
// from mI, nz and B) stages G (rows padded to the stride kN + 4, by
// cp.async) and H once: the block's one barrier. A lane runs on a group of
// four warps that synchronise by their own named barrier (bar.sync 1 +
// group, 128 threads), so one lane's serial parts never hold up another
// lane's warps, and a lane's bits depend neither on its block nor on B.
// One warp of the group leads (it owns the columns: x, g, rd, dx, and runs
// the factorization and the sweeps); it is warp `group mod 4` of the group,
// so the leaders of a block's lanes sit on the SM's four schedulers, not on
// one. Thread t of the group owns the rows t, t + 128, ... (at most 8): s,
// z and the predictor's steps in registers, d, rp and the KKT weights in
// the lane's shared memory (so that more lanes fit an SM's registers). The
// columns are padded to kN = 8 ceil(nz / 8) (a template width), with the
// identity in M past nz.
// - G x and G dx: a thread a row, float4 reads of the row and of x;
// - G'v: eight partial sums, rows r = w mod 8, spread over (w, column), then
//   added in order;
// - the assembly, on the three other warps: thread (task, k) sums the
//   4 x 4 block `task` of M's lower block triangle over the k-th of
//   96 / tasks row ranges (84 of 96 threads busy at nz = 21); the ranges'
//   partials are then added in order, with H and the ridge, by the group.
//   Meanwhile the leader sums the predictor's G't (its t needs no factor);
// - the factorization (right-looking, a row a lane, shuffles) and the sweeps
//   on the leader, the other warps waiting at the group's barrier (and other
//   lanes' warps running); a sweep step's division is a product with the
//   pivot's reciprocal (taken once a factorization) and Markstein's
//   correction, which gives __fdiv_rn's quotient at a third of its latency;
// - mu, mu_aff and the ratio minima: warp shuffles, then the warps' values
//   through shared memory.
// Rounding: every operation is written out (__fmaf_rn, __fmul_rn, ...) as the
// one-block-a-lane loop this kernel replaced rounded under nvcc's
// contraction (mehrotra_warp.cuh writes K2's so), so the compiler fuses
// nothing on its own: a*b + c is one fma except in t = d rp - rc / s and
// dz = d (rp + G dx) - rc / s, each a rounded product and a difference, and
// mu's rows are summed in that loop's block order. The share of lanes whose
// float32 iteration stalls is what phase 15 of chip_smoke.py holds to the
// plain version's, within half a point; t and dz fused into FMAs converge
// more lanes than the plain version, beyond that.

#include <cuda_runtime.h>

#include "mehrotra_warp.cuh"

namespace {

using mwarp::g_stride;
using mwarp::kFull;
using mwarp::kVec;
using mwarp::m_stride;
using mwarp::padded_nz;
using mwarp::round4;

constexpr int kGroup = 128;                       // a lane's threads: four warps
constexpr int kAsm = 96;                          // the assembly's threads: three warps
// Lanes a block at most (ops/qp_kernel.SHARED_MAX_LANES): four fill an
// SM's registers at 128 a thread (one block of 512 threads an SM) and most
// of its shared memory at the LMPC shape (G alone is 90 KB); five, at 102
// registers, spill and run slower.
constexpr int kMaxLanes = 4;
constexpr int kRows = mwarp::kMaxRows / kGroup;   // rows a thread: 8 at mI <= 1024
constexpr int kParts = 8;                         // G'v's row partials
constexpr int kRed = 48;                          // reduction slots a lane: 3 x 16
constexpr float kBig = 1e6f;                      // ratio-test sentinel
constexpr float kRidge = 1e-6f;
constexpr float kPadH = 1e6f;                     // the padded rows: h = s = 1e6

// The assembly's split at width kN: 4 x 4 blocks of the lower block
// triangle, each over kAsm / tasks row ranges.
__host__ __device__ constexpr int tasks(int kn) { return (kn / 4) * (kn / 4 + 1) / 2; }
__host__ __device__ constexpr int asm_ranges(int kn) { return kAsm / tasks(kn); }
__host__ __device__ constexpr int asm_floats(int kn) { return asm_ranges(kn) * tasks(kn) * 16; }

// Floats of one lane's shared memory: x, dx, L's reciprocal pivots, M (then L), three
// mI-vectors (d, rp, and z or the KKT weights t), the assembly's partials,
// G'v's partials, the reduction slots. ops/qp_kernel.shared_smem_bytes is
// the same formula.
__host__ __device__ constexpr size_t lane_floats(int mI, int nz) {
  return (size_t)3 * kVec + round4(padded_nz(nz) * m_stride(nz)) + 3 * round4(mI)
         + asm_floats(padded_nz(nz)) + kParts * padded_nz(nz) + kRed;
}
// A block's: G (rows of g_stride), H (kN x m_stride), and its lanes'.
__host__ __device__ constexpr size_t block_floats(int mI, int nz, int lanes) {
  return (size_t)mI * g_stride(nz) + round4(padded_nz(nz) * m_stride(nz))
         + (size_t)lanes * lane_floats(mI, nz);
}

struct LaneMem {
  float* xs;    // kVec: x, zero past nz
  float* dxs;   // kVec: dx, zero past nz
  float* ri;    // kVec: the reciprocals of L's diagonal
  float* M;     // kN x m_stride: M's lower triangle, then L; the identity past nz
  float* d;     // mI
  float* rp;    // mI
  float* t;     // mI: z (for G'z), then the KKT weights t
  float* apart; // asm_floats: the assembly's range partials
  float* part;  // kParts x kN: G'v's row partials
  float* red;   // kRed: the warps' reduction values
};

__device__ __forceinline__ LaneMem carve(float* smem, int mI, int nz, int group) {
  float* base = smem + block_floats(mI, nz, 0) + (size_t)group * lane_floats(mI, nz);
  LaneMem m;
  m.xs = base;
  m.dxs = m.xs + kVec;
  m.ri = m.dxs + kVec;
  m.M = m.ri + kVec;
  m.d = m.M + round4(padded_nz(nz) * m_stride(nz));
  m.rp = m.d + round4(mI);
  m.t = m.rp + round4(mI);
  m.apart = m.t + round4(mI);
  m.part = m.apart + asm_floats(padded_nz(nz));
  m.red = m.part + kParts * padded_nz(nz);
  return m;
}

// The group's barrier: its four warps only.
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(kGroup) : "memory");
}

// Phase clocks, for tools/k1_k4_compare.py only: built with K4_PHASE_CLOCKS,
// the group's thread 0 adds the clock64() cycles of every phase of every
// iteration (each stamp after a group barrier, so its clock is the lane's)
// into the slots of tools/k2w_split.py's phases and stores them in
// k4_clocks[lane * kClockSlots + phase]; `mehrotra_clocks(out, lanes)`
// copies the first `lanes` lanes' to the host. The package's build never
// defines the macro, and then PhaseClock is empty.
using mwarp::kClkAssemble;
using mwarp::kClkFactor;
using mwarp::kClkGdx;
using mwarp::kClkGtv;
using mwarp::kClkGtz;
using mwarp::kClkGx;
using mwarp::kClkReduce;
using mwarp::kClkSweep;
using mwarp::kClkTotal;
using mwarp::kClockSlots;
#ifdef K4_PHASE_CLOCKS
constexpr int kClockLanes = 16384;
__device__ unsigned long long k4_clocks[kClockLanes * kClockSlots];
struct PhaseClock {
  int id;
  bool first_thread;
  long long last, first;
  unsigned long long acc[kClockSlots];
  __device__ __forceinline__ PhaseClock(int id_, bool t0) : id(id_), first_thread(t0) {}
  __device__ __forceinline__ void start() {
    group_sync(id);
    last = first = clock64();
#pragma unroll
    for (int p = 0; p < kClockSlots; ++p) acc[p] = 0;
  }
  __device__ __forceinline__ void mark(int p) {
    group_sync(id);
    const long long t = clock64();
    acc[p] += t - last;
    last = t;
  }
  __device__ __forceinline__ void store(int b) {
    if (first_thread && b < kClockLanes) {
      acc[kClkTotal] = clock64() - first;
#pragma unroll
      for (int p = 0; p < kClockSlots; ++p) k4_clocks[b * kClockSlots + p] = acc[p];
    }
  }
};
#else
struct PhaseClock {
  __device__ __forceinline__ PhaseClock(int, bool) {}
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void store(int) {}
};
#endif

// Group sum in the replaced block loop's order, and two group minima; every
// thread gets all three; w is the thread's warp in the group. `even` and
// `odd` are the thread's partial sums of
// its rows t + 128 k for even and odd k: the rows of that loop's threads t
// and t + 128 of 256, which its warps w and w + 4 summed by a butterfly,
// and its warp 0 the 8 warp values by a butterfly (zeros above lane 8).
__device__ __forceinline__ float3 group_reduce(float even, float odd, float rs, float rz,
                                               float* red, int id, int w) {
  const int lane = threadIdx.x & 31;
  even = mwarp::warp_sum(even);
  odd = mwarp::warp_sum(odd);
  rs = mwarp::warp_min(rs);
  rz = mwarp::warp_min(rz);
  if (lane == 0) {
    red[w] = even;
    red[4 + w] = odd;
    red[8 + w] = rs;
    red[12 + w] = rz;
  }
  group_sync(id);
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = __fadd_rn(__fadd_rn(red[i], 0.f), 0.f);
  return make_float3(__fadd_rn(__fadd_rn(__fadd_rn(s[0], s[4]), __fadd_rn(s[2], s[6])),
                               __fadd_rn(__fadd_rn(s[1], s[5]), __fadd_rn(s[3], s[7]))),
                     fminf(fminf(red[8], red[9]), fminf(red[10], red[11])),
                     fminf(fminf(red[12], red[13]), fminf(red[14], red[15])));
}

// G'v's row partials: part[w kN + c] = sum over rows r = w mod 8, in row
// order, of G[r][c] v[r], for the items (w, c), c < nz, that thread `i` of
// `n` takes.
template <int kN>
__device__ __forceinline__ void col_partials(const float* Gs, const float* v, float* part,
                                             int i, int n, int mI, int nz) {
  constexpr int S = kN + 4;
  for (int item = i; item < kParts * nz; item += n) {
    const int w = item / nz, c = item - w * nz;
    float a = 0.f;
    for (int r = w; r < mI; r += kParts) a = __fmaf_rn(Gs[(size_t)r * S + c], v[r], a);
    part[w * kN + c] = a;
  }
}

// (G'v)[c] for c < nz: the eight partials in order.
template <int kN>
__device__ __forceinline__ float col_total(const float* part, int c) {
  float a = 0.f;
#pragma unroll
  for (int w = 0; w < kParts; ++w) a = __fadd_rn(a, part[w * kN + c]);
  return a;
}

// The assembly's partials, by thread `i` of the kAsm: task `i mod tasks`
// (the 4 x 4 block (P, Q), Q <= P, of M's lower block triangle) over the
// row range `i / tasks`, each term G[r][q] (d[r] G[r][p]) in row order.
template <int kN>
__device__ __forceinline__ void assemble_partials(const float* Gs, const LaneMem& m, int i,
                                                  int mI) {
  constexpr int S = kN + 4, T = tasks(kN), K = asm_ranges(kN);
  const int task = i % T, k = i / T;
  if (k >= K) return;
  int P = 0;
  while ((P + 1) * (P + 2) / 2 <= task) ++P;
  const int Q = task - P * (P + 1) / 2;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  const int len = (mI + K - 1) / K;
  const int r0 = k * len, r1 = min(mI, r0 + len);
  const float* gp = Gs + 4 * P;
  const float* gq = Gs + 4 * Q;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const float4 p4 = *reinterpret_cast<const float4*>(gp + (size_t)r * S);
    const float4 q4 = *reinterpret_cast<const float4*>(gq + (size_t)r * S);
    const float dr = m.d[r];
    const float dp[4] = {__fmul_rn(dr, p4.x), __fmul_rn(dr, p4.y), __fmul_rn(dr, p4.z),
                         __fmul_rn(dr, p4.w)};
    const float gqv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = __fmaf_rn(gqv[b], dp[a], acc[a][b]);
  }
  float4* out = reinterpret_cast<float4*>(m.apart + (size_t)(k * T + task) * 16);
#pragma unroll
  for (int a = 0; a < 4; ++a) out[a] = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
}

// M = G' diag(d) G + H + 1e-6 I into m.M's lower triangle at rows p < nz:
// the ranges' partials added in order, then H and the ridge; by the
// group's thread t.
template <int kN>
__device__ __forceinline__ void assemble_total(const float* Hs, const LaneMem& m, int t,
                                               int nz) {
  constexpr int HS = kN + 1, T = tasks(kN), K = asm_ranges(kN);
  const int E = nz * (nz + 1) / 2;
  for (int e = t; e < E; e += kGroup) {
    int p = (int)((__fsqrt_rn(8.f * e + 1.f) - 1.f) * 0.5f);  // entry e -> (p, q), row by row
    while ((p + 1) * (p + 2) / 2 <= e) ++p;
    while (p * (p + 1) / 2 > e) --p;
    const int q = e - p * (p + 1) / 2;
    const int P = p >> 2, Q = q >> 2;
    const float* src = m.apart + (size_t)(P * (P + 1) / 2 + Q) * 16 + (p & 3) * 4 + (q & 3);
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) a = __fadd_rn(a, src[(size_t)k * T * 16]);
    m.M[p * HS + q] = __fadd_rn(__fadd_rn(a, Hs[p * HS + q]), p == q ? kRidge : 0.f);
  }
}

// Right-looking Cholesky of M (lower triangle in m.M) with the pivot floor,
// on one warp: lane p holds row p in registers, the pivot and each column's
// entries come by shuffle; L's rows go back to m.M. Each entry takes column
// 0's update, then column 1's, ..., as the replaced loop's left-looking
// factorization did. A lane outside the column divides 1 (its quotient is
// unused). Ri[p] = RN(1 / L[p][p]) for the sweeps.
template <int kN>
__device__ __forceinline__ void factor(float* M, float* Ri, int lane) {
  constexpr int HS = kN + 1;
  float A[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) A[q] = (lane < kN && q <= lane) ? M[lane * HS + q] : 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float djj = __fsqrt_rn(fmaxf(__shfl_sync(kFull, A[j], j), 1e-30f));
    const bool live = lane >= j && lane < kN;
    const float l = __fdiv_rn(live ? A[j] : 1.f, djj);
    if (live) A[j] = l;
#pragma unroll
    for (int k = j + 1; k < kN; ++k) A[k] = __fmaf_rn(-__shfl_sync(kFull, l, k), l, A[k]);
  }
  if (lane < kN) {
#pragma unroll
    for (int q = 0; q < kN; ++q)
      if (q <= lane) M[lane * HS + q] = A[q];
    Ri[lane] = __frcp_rn(A[lane]);
  }
}

// a / l, correctly rounded, from ri = RN(1 / l) (__frcp_rn): one product
// and Markstein's correction, the quotient RN(a / l) in the operands' normal
// range (0 / l gives +0); off the sweeps' chain only the reciprocal is a
// division. K4_IEEE_SWEEPS builds the sweeps on __fdiv_rn instead
// (tools/k1_k4_compare.py holds the two builds' bits equal).
__device__ __forceinline__ float div_by(float a, float l, float ri) {
#ifdef K4_IEEE_SWEEPS
  return __fdiv_rn(a, l);
#else
  const float q = __fmul_rn(a, ri);
  return __fmaf_rn(__fmaf_rn(-q, l, a), ri, q);
#endif
}

// dx = L^-T L^-1 b on one warp (lane c holds b[c], 0 past nz; Ri[j] =
// RN(1 / L[j][j])); each solved entry broadcast by shuffle. Returns dx[c] in
// lane c (0 past nz).
template <int kN>
__device__ __forceinline__ float sweeps(const float* L, const float* Ri, float b, int lane,
                                        int nz) {
  constexpr int HS = kN + 1;
  float y = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {  // L y = b
    const float yj = div_by(__shfl_sync(kFull, b, j), L[j * HS + j], Ri[j]);
    if (lane == j) y = yj;
    if (lane > j && lane < kN) b = __fmaf_rn(-L[lane * HS + j], yj, b);
  }
  float u = 0.f;
#pragma unroll
  for (int j = kN - 1; j >= 0; --j) {  // L' u = y
    const float uj = div_by(__shfl_sync(kFull, y, j), L[j * HS + j], Ri[j]);
    if (lane == j) u = uj;
    if (lane < j) y = __fmaf_rn(-L[j * HS + lane], uj, y);
  }
  return lane < nz ? u : 0.f;
}

// The virtual padded row's dual step: dz = d (rp + G dx) - rc / s with
// rp = G dx = 0 and s = 1e6; its ratio -z / dz where dz < 0, else BIG.
__device__ __forceinline__ float pad_dz(float rc) { return -__fdiv_rn(rc, kPadH); }
__device__ __forceinline__ float pad_ratio(float z, float dz) {
  return dz < 0.f ? __fdiv_rn(-z, dz) : kBig;
}

template <int kN>
__global__ void __launch_bounds__(kMaxLanes * kGroup, 1)
mehrotra_kernel(const float* __restrict__ G, const float* __restrict__ H,
                const float* __restrict__ g, const float* __restrict__ h,
                float* __restrict__ x_out, unsigned char* __restrict__ conv_out,
                float* __restrict__ mu_out, int B, int mI, int nz, int iters, float tau,
                float d_cap) {
  const bool pad = mI % 128 != 0;  // the reference's padded rows, as one virtual row
  constexpr int HS = kN + 1;
  extern __shared__ __align__(16) float smem[];
  float* Gs = smem;
  float* Hs = smem + (size_t)mI * g_stride(nz);
  mwarp::stage_g(Gs, G, mI, nz);
  for (int i = threadIdx.x; i < kN * HS; i += blockDim.x) {
    const int p = i / HS, q = i - p * HS;
    Hs[i] = (p < nz && q < nz) ? H[p * nz + q] : 0.f;
  }
  __syncthreads();  // the only block barrier: G and H are staged
  const int group = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int lane = t & 31;
  const int b = blockIdx.x * (blockDim.x / kGroup) + group;
  if (b >= B) return;  // whole groups leave together
  const int id = 1 + group;
  // the leading warp, and this thread's place among the other three
  const int rel = ((t >> 5) - group) & 3;
  const bool lead = rel == 0;
  const int other = (rel - 1) * 32 + lane;
  const LaneMem m = carve(smem, mI, nz, group);
  const float* hb = h + (size_t)b * mI;
  for (int i = t; i < 2 * kVec; i += kGroup) m.xs[i] = 0.f;  // xs, dxs
  for (int i = t; i < kN * HS; i += kGroup) {                // M: the identity past nz
    const int p = i / HS, q = i - p * HS;
    if (p >= nz) m.M[i] = p == q ? 1.f : 0.f;
  }
  float s[kRows], z[kRows], dsa[kRows], dza[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int r = t + kGroup * k;
    s[k] = z[k] = dsa[k] = dza[k] = 0.f;
    if (r < mI) {
      s[k] = fmaxf(hb[r], 1.f);
      z[k] = 1.f;
    }
  }
  const float gl = (lead && lane < nz) ? g[(size_t)b * nz + lane] : 0.f;
  float x = 0.f;
  float z_pad = 1.f;
  const bool pad_here = pad && t == 0;
  const float inv_m = __fdiv_rn(1.f, (float)mI);
  group_sync(id);

  // the KKT rows for the right-hand side rc(k) of each row (d, rp and dx in
  // shared memory): ds = -rp - G dx, dz = d (rp + G dx) - rc / s_safe
  auto kkt_rows = [&](auto&& rc, float (&ds)[kRows], float (&dz)[kRows]) {
    float4 dv[kN / 4];
    mwarp::load_vec<kN>(m.dxs, dv);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = t + kGroup * k;
      if (r < mI) {
        const float gdx = mwarp::row_dot<kN>(Gs, r, dv);
        const float q = __fdiv_rn(rc(k), fmaxf(s[k], 1e-25f));
        const float rpr = m.rp[r];
        ds[k] = __fsub_rn(-rpr, gdx);
        dz[k] = __fsub_rn(__fmul_rn(m.d[r], __fadd_rn(rpr, gdx)), q);
      }
    }
  };
  // this thread's part of min over the rows of (-v / dv where dv < 0, else
  // BIG) for (s, ds) and (z, dz)
  auto ratios = [&](const float (&ds)[kRows], const float (&dz)[kRows], float rz0) {
    float rs = kBig, rz = rz0;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (t + kGroup * k < mI) {
        rs = fminf(rs, ds[k] < 0.f ? __fdiv_rn(-s[k], ds[k]) : kBig);
        rz = fminf(rz, dz[k] < 0.f ? __fdiv_rn(-z[k], dz[k]) : kBig);
      }
    }
    return make_float2(rs, rz);
  };
  // the KKT weights t = d rp - rc / s_safe of this thread's rows into m.t
  auto weights = [&](auto&& rc) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = t + kGroup * k;
      if (r < mI)
        m.t[r] = __fsub_rn(__fmul_rn(m.d[r], m.rp[r]), __fdiv_rn(rc(k), fmaxf(s[k], 1e-25f)));
    }
  };
  // the leader's sweeps for rhs -(rd + G't) (G't from m.part), dx into m.dxs
  auto solve_dx = [&](float rd) {
    const float rhs = lane < nz ? -__fadd_rn(rd, col_total<kN>(m.part, lane)) : 0.f;
    const float dx = sweeps<kN>(m.M, m.ri, rhs, lane, nz);
    if (lane < kN) m.dxs[lane] = dx;
    return dx;
  };

  PhaseClock clk(id, t == 0);
  clk.start();
  for (int it = 0; it < iters; ++it) {
    {  // rp = G x + s - h, d, and z for G'z
      float4 xv[kN / 4];
      mwarp::load_vec<kN>(m.xs, xv);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = t + kGroup * k;
        if (r < mI) {
          m.rp[r] = __fsub_rn(__fadd_rn(mwarp::row_dot<kN>(Gs, r, xv), s[k]), __ldg(hb + r));
          m.d[r] = fminf(__fdiv_rn(z[k], fmaxf(s[k], 1e-25f)), d_cap);
          m.t[r] = z[k];
        }
      }
    }
    group_sync(id);
    clk.mark(kClkGx);
    col_partials<kN>(Gs, m.t, m.part, t, kGroup, mI, nz);  // G'z
    group_sync(id);
    float rd = 0.f;
    if (lead && lane < nz) {
      float hx = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) hx = __fmaf_rn(Hs[lane * HS + j], m.xs[j], hx);
      rd = __fadd_rn(__fadd_rn(hx, gl), col_total<kN>(m.part, lane));
    }
    const auto rc_pred = [&](int k) { return __fmul_rn(s[k], z[k]); };
    weights(rc_pred);
    group_sync(id);
    clk.mark(kClkGtz);
    if (lead) col_partials<kN>(Gs, m.t, m.part, lane, 32, mI, nz);  // the predictor's G't
    else assemble_partials<kN>(Gs, m, other, mI);
    group_sync(id);
    assemble_total<kN>(Hs, m, t, nz);
    group_sync(id);
    clk.mark(kClkAssemble);
    if (lead) factor<kN>(m.M, m.ri, lane);
    clk.mark(kClkFactor);
    float dx = 0.f;
    if (lead) {
      __syncwarp();
      dx = solve_dx(rd);
    }
    group_sync(id);
    clk.mark(kClkSweep);

    // predictor
    kkt_rows(rc_pred, dsa, dza);
    clk.mark(kClkGdx);
    float mu_e = 0.f, mu_o = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (t + kGroup * k < mI) {
        if (k % 2 == 0) mu_e = __fmaf_rn(s[k], z[k], mu_e);
        else mu_o = __fmaf_rn(s[k], z[k], mu_o);
      }
    }
    const float dza_pad = pad_dz(__fmul_rn(kPadH, z_pad));
    const float2 pa = ratios(dsa, dza, pad_here ? pad_ratio(z_pad, dza_pad) : kBig);
    const float3 ra = group_reduce(mu_e, mu_o, pa.x, pa.y, m.red, id, t >> 5);
    const float mu = __fmul_rn(ra.x, inv_m);
    const float ap_a = fminf(1.f, ra.y), ad_a = fminf(1.f, ra.z);
    float aff_e = 0.f, aff_o = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      if (t + kGroup * k < mI) {
        const float sa = __fmaf_rn(ap_a, dsa[k], s[k]), za = __fmaf_rn(ad_a, dza[k], z[k]);
        if (k % 2 == 0) aff_e = __fmaf_rn(sa, za, aff_e);
        else aff_o = __fmaf_rn(sa, za, aff_o);
      }
    }
    const float mu_aff =
        __fmul_rn(group_reduce(aff_e, aff_o, kBig, kBig, m.red + 16, id, t >> 5).x, inv_m);
    const float sr = __fdiv_rn(mu_aff, fmaxf(mu, 1e-25f));
    const float sigma = __fmul_rn(__fmul_rn(sr, sr), sr);
    clk.mark(kClkReduce);

    // corrector: its steps overwrite the predictor's once rc has used them
    const auto rc_cor = [&](int k) {
      return __fmaf_rn(-sigma, mu, __fmaf_rn(dsa[k], dza[k], __fmul_rn(s[k], z[k])));
    };
    weights(rc_cor);
    group_sync(id);
    col_partials<kN>(Gs, m.t, m.part, t, kGroup, mI, nz);
    group_sync(id);
    clk.mark(kClkGtv);
    if (lead) dx = solve_dx(rd);
    group_sync(id);
    clk.mark(kClkSweep);
    kkt_rows(rc_cor, dsa, dza);
    clk.mark(kClkGdx);
    const float dz_pad = pad_dz(__fmaf_rn(-sigma, mu, __fmul_rn(kPadH, z_pad)));
    const float2 pc = ratios(dsa, dza, pad_here ? pad_ratio(z_pad, dz_pad) : kBig);
    const float3 rcor = group_reduce(0.f, 0.f, pc.x, pc.y, m.red + 32, id, t >> 5);
    const float ap = fminf(1.f, __fmul_rn(tau, rcor.y)), ad = fminf(1.f, __fmul_rn(tau, rcor.z));
    if (lead && lane < nz) {
      x = __fmaf_rn(ap, dx, x);
      m.xs[lane] = x;
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      s[k] = __fmaf_rn(ap, dsa[k], s[k]);
      z[k] = __fmaf_rn(ad, dza[k], z[k]);
    }
    if (pad) z_pad = __fmaf_rn(ad, dz_pad, z_pad);
    group_sync(id);
    clk.mark(kClkReduce);
  }
  clk.store(b);

  // rows whose residual fails the test (NaN fails), and mu
  float bad = 0.f, mu_e = 0.f, mu_o = 0.f;
  {
    float4 xv[kN / 4];
    mwarp::load_vec<kN>(m.xs, xv);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = t + kGroup * k;
      if (r < mI) {
        const float res = __fsub_rn(__fadd_rn(mwarp::row_dot<kN>(Gs, r, xv), s[k]), hb[r]);
        if (!(fabsf(res) < 2e-3f)) bad += 1.f;
        if (k % 2 == 0) mu_e = __fmaf_rn(s[k], z[k], mu_e);
        else mu_o = __fmaf_rn(s[k], z[k], mu_o);
      }
    }
  }
  const float mu = __fmul_rn(group_reduce(mu_e, mu_o, kBig, kBig, m.red, id, t >> 5).x, inv_m);
  const float n_bad = group_reduce(bad, 0.f, kBig, kBig, m.red + 16, id, t >> 5).x;
  if (t == 0) {
    conv_out[b] = (mu < 2e-4f * (1.f + mu * (float)mI) && n_bad == 0.f) ? 1 : 0;
    mu_out[b] = mu;
  }
  if (lead && lane < nz) x_out[(size_t)b * nz + lane] = x;
}

// f(kernel) for the instance at nz.
template <class F>
auto by_shape(int nz, F&& f) {
  switch (padded_nz(nz)) {
    case 8: return f(mehrotra_kernel<8>);
    case 16: return f(mehrotra_kernel<16>);
    case 24: return f(mehrotra_kernel<24>);
    default: return f(mehrotra_kernel<32>);
  }
}

bool valid_shape(int mI, int nz, int lanes) {
  return nz >= 1 && nz <= mwarp::kNzMax && mI >= 1 && mI <= mwarp::kMaxRows && lanes >= 1
         && lanes <= kMaxLanes;
}

}  // namespace

extern "C" int mehrotra_launch(const float* G, const float* H, const float* g, const float* h,
                               float* x, unsigned char* conv, float* mu, int B, int mI,
                               int nz, int iters, float tau, float d_cap, int lanes,
                               void* stream) {
  if (!valid_shape(mI, nz, lanes) || B < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = block_floats(mI, nz, lanes) * sizeof(float);
  return by_shape(nz, [&](auto kernel) {
    const cudaError_t st =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (st != cudaSuccess) return (int)st;
    kernel<<<(B + lanes - 1) / lanes, lanes * kGroup, smem, (cudaStream_t)stream>>>(
        G, H, g, h, x, conv, mu, B, mI, nz, iters, tau, d_cap);
    return (int)cudaGetLastError();
  });
}

// The dynamic shared memory of a block of `lanes` lanes (bytes);
// ops/qp_kernel.shared_smem_bytes is held to it.
extern "C" long long mehrotra_smem_bytes(int mI, int nz, int lanes) {
  return (long long)(block_floats(mI, nz, lanes) * sizeof(float));
}

// The lanes one SM holds in blocks of `lanes` lanes (CUDA's occupancy
// calculator), -1 where the kernel does not take the shape.
extern "C" int mehrotra_resident_lanes(int mI, int nz, int lanes) {
  if (!valid_shape(mI, nz, lanes)) return -1;
  const size_t smem = block_floats(mI, nz, lanes) * sizeof(float);
  return by_shape(nz, [&](auto kernel) {
    int blocks = 0;
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, lanes * kGroup, smem);
    return blocks * lanes;
  });
}

extern "C" const char* mehrotra_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef K4_PHASE_CLOCKS
extern "C" int mehrotra_clocks(unsigned long long* out, int lanes) {
  if (lanes < 0 || lanes > kClockLanes) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(out, k4_clocks,
                                   (size_t)lanes * kClockSlots * sizeof(unsigned long long));
}
#endif
