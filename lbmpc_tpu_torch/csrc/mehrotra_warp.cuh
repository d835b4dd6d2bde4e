// mehrotra_warp.cuh — K2's and K3's fixed-iteration Mehrotra predictor-
// corrector loop, built for how an H100 hides latency: one warp owns one
// lane, several lanes share a block, and inside an iteration the warp meets
// no block barrier. Shared by mehrotra_h.cu (K2) and gn_mehrotra.cu (K3);
// K4 (mehrotra.cu) runs its own loop on four warps a lane with this file's
// staging of G and row products.
//
//   min 1/2 x'H x + g'x  s.t.  G x <= h   (G shared by the batch)
//
// Semantics are the reference's K2's (pallas_ipm.py:138-176), as the
// one-block-a-lane loop these kernels replaced ran them (the "block loop"
// below: mehrotra_body.cuh's solve up to commit c22a8d5): d = min(z / max(s, 1e-25), d_cap),
// M = G' diag(d) G + H + 1e-6 I, Jacobi equilibration with
// sc = 1/sqrt(max(diag M, 1e-30)), Cholesky with the pivot floor
// sqrt(max(., 1e-30)), two triangular solves each for the predictor and the
// corrector, sigma = (mu_aff / max(mu, 1e-25))^3, ratio tests with the 1e6
// sentinel, the step fraction tau, and mu over the mI rows.
//
// Layout. A lane's columns are padded to kN = 8 ceil(nz / 8), a template
// parameter, with the identity in M and zeros in G, H, x and g, so that every
// loop over columns is unrolled without a branch. A block stages G once for
// all its warps (cp.async, each row padded with zeros to a stride kN + 4 =
// 4 mod 8, so that a thread reads four columns of its own row in one
// conflict-free 16-byte load); after that one barrier every datum is the
// warp's own, so a lane's bits depend neither on its block, nor on its place
// in the batch, nor on B, and a NaN stays in its lane. Thread c of a warp owns column c (x, dx, g, rd, sc and
// the KKT right-hand side) in registers, and the rows c, c + 32, ... of the
// per-row state (s, z, h, d, rp and the predictor's steps): in registers at
// mI <= 256 (RegRows), in the warp's shared memory above (SmemRows). The
// warp's shared memory also holds H, M (then L), x and dx for broadcast
// reads, and one mI-vector (z, d or the KKT weights t) that every thread
// reads.
// - G x and G dx: a thread a row, float4 reads of the row and of x;
// - G'v: thread c sums column c over all rows with eight running partial
//   sums (row r into partial r mod 8), then adds them in order;
// - the assembly: thread k owns 4 x 4 block k of M's lower block triangle
//   in registers and streams G's rows: two float4 reads and d[r] a row for
//   16 FMAs;
// - the factorization: right-looking, thread p holds row p of the
//   equilibrated M in registers, and the pivot and each column's entries
//   come by shuffle; L goes to the warp's shared memory for the sweeps;
// - the sweeps: each solved entry broadcast by shuffle;
// - mu, mu_aff and the two ratio minima: warp shuffles.
// Only __syncwarp orders the warp's shared memory.
//
// Rounding. Every operation is written out (__fmaf_rn, __fmul_rn, ...) so
// that K2 and K3, which inline this loop, round alike whatever the compiler
// would fuse, and as the block loop rounds under nvcc's
// contraction, so that at mI <= 256 K2 and K3 return that loop's bits
// (tools/k2_numerics.py, tools/k2_compare.py check it against an earlier
// tree; above 256 rows, where a thread of that loop held several, they
// part on a few lanes, the cause not found): G'v in its
// col_reduce's order (eight row partials, added in order), mu and mu_aff in
// its block_reduce2's (the rows of each of 256 threads, a butterfly over 32
// lanes, then over 8 warps), the factorization's updates in its
// left-looking order, and a*b + c as one fma except in the KKT's
// t = d rp - rc / s and dz = d (rp + G dx) - rc / s, which that loop rounds
// as a product and a difference.

#pragma once

#include <cuda_runtime.h>

namespace mwarp {

constexpr int kNzMax = 32;             // a lane's columns are the warp's lanes
constexpr int kMaxRows = 1024;
constexpr int kRegRowsMax = 256;       // per-row state in registers up to here
constexpr int kMaxWarps = 8;           // lanes a block (ops/qp_kernel.NARROW_MAX_WARPS)
constexpr int kVec = 36;               // x, dx: the largest G stride
constexpr int kStateVecs = 7;          // s, z, h, d, rp, dsa, dza (SmemRows)
constexpr float kBig = 1e6f;           // ratio-test sentinel
constexpr float kRidge = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

// A lane's columns, padded to kN = 8 ceil(nz / 8) (the kernels are built for
// kN = 8, 16, 24, 32): the padded part of M is the identity and of G, H, x
// and g zero, so every loop over columns has a fixed length and no branch,
// and the padded steps leave the real entries as they are.
__host__ __device__ constexpr int padded_nz(int nz) { return (nz + 7) / 8 * 8; }
// G's row stride in shared memory: kN + 4 (= 4 mod 8: eight threads reading
// 16 bytes of eight rows hit 32 distinct banks).
__host__ __device__ constexpr int g_stride(int nz) { return padded_nz(nz) + 4; }
// H's and M's row stride: kN + 1, odd, so a thread a row (or a column) reads
// conflict-free.
__host__ __device__ constexpr int m_stride(int nz) { return padded_nz(nz) + 1; }
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of one warp's shared memory; `extra` is the caller's (K3: its
// lane's window and Jacobian rows). ops/qp_kernel.narrow_warp_floats is the
// same formula.
__host__ __device__ constexpr size_t warp_floats(int mI, int nz, int extra) {
  return (size_t)2 * kVec + 2 * round4(padded_nz(nz) * m_stride(nz)) + round4(mI)
         + (mI > kRegRowsMax ? (size_t)kStateVecs * round4(mI) : 0) + extra;
}
__host__ __device__ constexpr size_t block_floats(int mI, int nz, int warps, int extra) {
  return (size_t)mI * g_stride(nz) + (size_t)warps * warp_floats(mI, nz, extra);
}

struct WarpMem {
  float* xs;    // kVec: x, zero past nz
  float* dxs;   // kVec: dx, zero past nz
  float* H;     // kN x m_stride, zero past nz
  float* M;     // kN x m_stride: M's lower triangle, then L
  float* v;     // mI: z, d or t
  float* rows;  // kStateVecs x round4(mI) (SmemRows only)
  float* extra; // the caller's
};

__device__ __forceinline__ WarpMem carve(float* smem, int mI, int nz, int warp, int extra) {
  float* base = smem + (size_t)mI * g_stride(nz) + (size_t)warp * warp_floats(mI, nz, extra);
  const int hm = round4(padded_nz(nz) * m_stride(nz));
  WarpMem w;
  w.xs = base;
  w.dxs = w.xs + kVec;
  w.H = w.dxs + kVec;
  w.M = w.H + hm;
  w.v = w.M + hm;
  w.rows = w.v + round4(mI);
  w.extra = w.rows + (mI > kRegRowsMax ? kStateVecs * round4(mI) : 0);
  return w;
}

// Stage G (mI x nz, row-major in device memory) into smem rows of stride S,
// zero past nz, by all threads of the block; the caller then synchronises.
__device__ __forceinline__ void stage_g(float* Gs, const float* __restrict__ G, int mI, int nz) {
  const int S = g_stride(nz);
  const int n = mI * S;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / S, c = i - r * S;
    if (c < nz) {
      const unsigned dst = (unsigned)__cvta_generic_to_shared(Gs + i);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(G + (size_t)r * nz + c));
    } else {
      Gs[i] = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// Phase clocks, for tools/k2_split.py only: built with K2_PHASE_CLOCKS, each
// warp adds the clock64() cycles of every phase of every iteration of its
// lane into kClockSlots counters (each stamp a __syncwarp) and solve()
// stores them in k2_clocks[lane * kClockSlots + phase]. The package's build
// never defines the macro, and then PhaseClock is empty.
enum ClockPhase { kClkGx, kClkGtz, kClkAssemble, kClkEquil, kClkFactor, kClkGtv, kClkSweep,
                  kClkGdx, kClkReduce, kClkTotal, kClockSlots };
#ifdef K2_PHASE_CLOCKS
constexpr int kClockLanes = 16384;
__device__ unsigned long long k2_clocks[kClockLanes * kClockSlots];
struct PhaseClock {
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
    if ((threadIdx.x & 31) == 0 && b < kClockLanes) {
      acc[kClkTotal] = clock64() - first;
#pragma unroll
      for (int p = 0; p < kClockSlots; ++p) k2_clocks[b * kClockSlots + p] = acc[p];
    }
  }
};
// `<source>_clocks(out, lanes)`: the first `lanes` lanes' counters of the
// last launch, copied to the host array `out`
#define MWARP_CLOCKS_EXPORT(source)                                                      \
  extern "C" int source##_clocks(unsigned long long* out, int lanes) {                   \
    return (int)cudaMemcpyFromSymbol(                                                    \
        out, mwarp::k2_clocks,                                                           \
        (size_t)lanes * mwarp::kClockSlots * sizeof(unsigned long long));                \
  }
#else
#define MWARP_CLOCKS_EXPORT(source)
struct PhaseClock {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void store(int) {}
};
#endif

// The per-row state of one lane: thread `lane` holds rows lane + 32 t.
struct RegRows {
  static constexpr bool kSmem = false;
  static constexpr int kR = kRegRowsMax / 32;
  float s_[kR], z_[kR], h_[kR], d_[kR], rp_[kR], dsa_[kR], dza_[kR];
  __device__ __forceinline__ RegRows(float*, int, int) {}
  __device__ __forceinline__ float& s(int t) { return s_[t]; }
  __device__ __forceinline__ float& z(int t) { return z_[t]; }
  __device__ __forceinline__ float& h(int t) { return h_[t]; }
  __device__ __forceinline__ float& d(int t) { return d_[t]; }
  __device__ __forceinline__ float& rp(int t) { return rp_[t]; }
  __device__ __forceinline__ float& dsa(int t) { return dsa_[t]; }
  __device__ __forceinline__ float& dza(int t) { return dza_[t]; }
};

struct SmemRows {
  static constexpr bool kSmem = true;
  static constexpr int kR = kMaxRows / 32;
  float* p;
  int m4;
  __device__ __forceinline__ SmemRows(float* rows, int mI, int lane)
      : p(rows + lane), m4(round4(mI)) {}
  __device__ __forceinline__ float& at(int k, int t) { return p[k * m4 + 32 * t]; }
  __device__ __forceinline__ float& s(int t) { return at(0, t); }
  __device__ __forceinline__ float& z(int t) { return at(1, t); }
  __device__ __forceinline__ float& h(int t) { return at(2, t); }
  __device__ __forceinline__ float& d(int t) { return at(3, t); }
  __device__ __forceinline__ float& rp(int t) { return at(4, t); }
  __device__ __forceinline__ float& dsa(int t) { return at(5, t); }
  __device__ __forceinline__ float& dza(int t) { return at(6, t); }
};

// f(t, r) for each of this thread's rows r = lane + 32 t < mI.
template <class R, class F>
__device__ __forceinline__ void for_rows(int lane, int mI, F&& f) {
  if constexpr (R::kSmem) {
    for (int t = 0, r = lane; r < mI; ++t, r += 32) f(t, r);
  } else {
#pragma unroll
    for (int t = 0; t < R::kR; ++t) {
      const int r = lane + 32 * t;
      if (r < mI) f(t, r);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// sum over rows of f(t) in the block loop's order: a thread of that
// 256-thread block summed rows tid + 256 k (fma chain), each warp's lanes by
// a butterfly, then warp 0 the 8 warp totals by a butterfly (zeros above
// lane 8). Row r = lane + 32 t was thread (t mod 8) * 32 + lane's there.
template <class R, class F>
__device__ __forceinline__ float block_order_sum(int lane, int mI, F&& f) {
  float w[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float p = 0.f;
    if constexpr (R::kSmem) {
      for (int t = k, r = lane + 32 * k; r < mI; t += 8, r += 256) p = f(t, p);
    } else {
#pragma unroll
      for (int t = k; t < R::kR; t += 8)
        if (lane + 32 * t < mI) p = f(t, p);
    }
    // lanes >= 8 of the second butterfly held 0: its first two steps add 0
    w[k] = __fadd_rn(__fadd_rn(warp_sum(p), 0.f), 0.f);
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(w[0], w[4]), __fadd_rn(w[2], w[6])),
                   __fadd_rn(__fadd_rn(w[1], w[5]), __fadd_rn(w[3], w[7])));
}


// The warp's vector v (kVec floats, zero past nz) in registers, four at a time.
template <int kN>
__device__ __forceinline__ void load_vec(const float* v, float4 (&out)[kN / 4]) {
#pragma unroll
  for (int k = 0; k < kN / 4; ++k) out[k] = reinterpret_cast<const float4*>(v)[k];
}

// Row r of G times v (in registers): from column 0 up, one fma each.
template <int kN>
__device__ __forceinline__ float row_dot(const float* Gs, int r, const float4 (&v)[kN / 4]) {
  const float4* g4 = reinterpret_cast<const float4*>(Gs + (size_t)r * (kN + 4));
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < kN / 4; ++k) {
    const float4 gk = g4[k];
    a = __fmaf_rn(gk.x, v[k].x, a);
    a = __fmaf_rn(gk.y, v[k].y, a);
    a = __fmaf_rn(gk.z, v[k].z, a);
    a = __fmaf_rn(gk.w, v[k].w, a);
  }
  return a;
}

// (G'v)[c] for thread c < nz (0 above): the block loop's col_reduce order,
// warp w's partial over rows w, w + 8, ..., then the 8 partials in order.
template <int kN>
__device__ __forceinline__ float col_sum(const float* Gs, const float* v, int c, int mI,
                                         int nz) {
  if (c >= nz) return 0.f;
  constexpr int S = kN + 4;
  float p[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) p[k] = 0.f;
  int r = 0;
  for (; r + 8 <= mI; r += 8) {
    const float4 va = *reinterpret_cast<const float4*>(v + r);
    const float4 vb = *reinterpret_cast<const float4*>(v + r + 4);
    const float* g = Gs + (size_t)r * S + c;
    p[0] = __fmaf_rn(g[0], va.x, p[0]);
    p[1] = __fmaf_rn(g[S], va.y, p[1]);
    p[2] = __fmaf_rn(g[2 * S], va.z, p[2]);
    p[3] = __fmaf_rn(g[3 * S], va.w, p[3]);
    p[4] = __fmaf_rn(g[4 * S], vb.x, p[4]);
    p[5] = __fmaf_rn(g[5 * S], vb.y, p[5]);
    p[6] = __fmaf_rn(g[6 * S], vb.z, p[6]);
    p[7] = __fmaf_rn(g[7 * S], vb.w, p[7]);
  }
#pragma unroll
  for (int k = 0; k < 7; ++k)
    if (r + k < mI) p[k] = __fmaf_rn(Gs[(size_t)(r + k) * S + c], v[r + k], p[k]);
  float a = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) a = __fadd_rn(a, p[k]);
  return a;
}

// M = G' diag(d) G + H + 1e-6 I into wm.M's lower triangle (d in wm.v), the
// identity past nz: thread k owns the 4 x 4 block (P, Q), P >= Q, of the
// lower block triangle; entry (p, q), q <= p < nz, sums G[r][q] (d[r] G[r][p])
// over the rows in order, then adds H[p][q] and the ridge: the block loop's
// assembly.
template <int kN>
__device__ __forceinline__ void assemble(const float* Gs, const WarpMem& wm, int lane, int mI,
                                         int nz) {
  constexpr int S = kN + 4, HS = kN + 1, nb = kN / 4, tasks = nb * (nb + 1) / 2;
  for (int task = lane; task < tasks; task += 32) {
    int P = 0;
    while ((P + 1) * (P + 2) / 2 <= task) ++P;
    const int Q = task - P * (P + 1) / 2;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    const float* gp = Gs + 4 * P;
    const float* gq = Gs + 4 * Q;
#pragma unroll 4
    for (int r = 0; r < mI; ++r) {
      const float4 p4 = *reinterpret_cast<const float4*>(gp + (size_t)r * S);
      const float4 q4 = *reinterpret_cast<const float4*>(gq + (size_t)r * S);
      const float dr = wm.v[r];
      const float dp[4] = {__fmul_rn(dr, p4.x), __fmul_rn(dr, p4.y), __fmul_rn(dr, p4.z),
                           __fmul_rn(dr, p4.w)};
      const float gqv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = __fmaf_rn(gqv[b], dp[a], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int p = 4 * P + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int q = 4 * Q + b;
        if (q <= p)
          wm.M[p * HS + q] = p < nz ? __fadd_rn(__fadd_rn(acc[a][b], wm.H[p * HS + q]),
                                                p == q ? kRidge : 0.f)
                                    : (p == q ? 1.f : 0.f);
      }
    }
  }
}

// Right-looking Cholesky of the equilibrated M (lower triangle in wm.M, scale
// sc in thread c) with the pivot floor; thread p holds row p in registers and
// leaves L's row p in wm.M. Each entry sees the updates of columns 0, 1, ...
// in turn, as in the block loop's left-looking factorization.
template <int kN>
__device__ __forceinline__ void factor(const WarpMem& wm, int lane, float sc) {
  constexpr int HS = kN + 1;
  float A[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) {
    const float scq = __shfl_sync(kFull, sc, q);
    A[q] = (lane < kN && q <= lane) ? __fmul_rn(__fmul_rn(wm.M[lane * HS + q], sc), scq) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float piv = __shfl_sync(kFull, A[j], j);
    const float djj = __fsqrt_rn(fmaxf(piv, 1e-30f));
    const float l = __fdiv_rn(A[j], djj);
    A[j] = l;
#pragma unroll
    for (int k = j + 1; k < kN; ++k) {
      const float lk = __shfl_sync(kFull, l, k);
      A[k] = __fmaf_rn(-lk, l, A[k]);
    }
  }
  __syncwarp();
  if (lane < kN) {
#pragma unroll
    for (int q = 0; q < kN; ++q)
      if (q <= lane) wm.M[lane * HS + q] = A[q];
  }
  __syncwarp();
}

// One KKT solve for the complementarity right-hand side rc(t) of each row:
// dx = sc L^-T L^-1 (-(rd + G' t) sc), t = d rp - rc / s_safe, then per row
// dz = d (rp + G dx) - rc / s_safe and ds = -rp - G dx, handed to out(t, ds,
// dz). Returns dx in thread c (0 past nz).
template <int kN, class R, class RC, class OUT>
__device__ __forceinline__ float kkt(const float* Gs, const WarpMem& wm, R& rows, int lane,
                                     int mI, int nz, float rd, float sc, RC&& rc, OUT&& out,
                                     PhaseClock& clk) {
  constexpr int HS = kN + 1;
  for_rows<R>(lane, mI, [&](int t, int r) {
    const float ss = fmaxf(rows.s(t), 1e-25f);
    wm.v[r] = __fsub_rn(__fmul_rn(rows.d(t), rows.rp(t)), __fdiv_rn(rc(t), ss));
  });
  __syncwarp();
  const float gt = col_sum<kN>(Gs, wm.v, lane, mI, nz);
  clk.mark(kClkGtv);
  float b = lane < nz ? __fmul_rn(-__fadd_rn(rd, gt), sc) : 0.f;
  float y = 0.f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {  // L y = b
    const float yj = __fdiv_rn(__shfl_sync(kFull, b, j), wm.M[j * HS + j]);
    if (lane == j) y = yj;
    if (lane > j && lane < kN) b = __fmaf_rn(-wm.M[lane * HS + j], yj, b);
  }
  float u = 0.f;
#pragma unroll
  for (int j = kN - 1; j >= 0; --j) {  // L' u = y
    const float uj = __fdiv_rn(__shfl_sync(kFull, y, j), wm.M[j * HS + j]);
    if (lane == j) u = uj;
    if (lane < j) y = __fmaf_rn(-wm.M[j * HS + lane], uj, y);
  }
  const float dx = lane < nz ? __fmul_rn(u, sc) : 0.f;
  if (lane < nz) wm.dxs[lane] = dx;
  __syncwarp();
  clk.mark(kClkSweep);
  float4 dxv[kN / 4];
  load_vec<kN>(wm.dxs, dxv);
  for_rows<R>(lane, mI, [&](int t, int r) {
    const float gdx = row_dot<kN>(Gs, r, dxv);
    const float ss = fmaxf(rows.s(t), 1e-25f);
    const float q = __fdiv_rn(rc(t), ss);
    out(t, __fsub_rn(-rows.rp(t), gdx),
        __fsub_rn(__fmul_rn(rows.d(t), __fadd_rn(rows.rp(t), gdx)), q));
  });
  __syncwarp();
  clk.mark(kClkGdx);
  return dx;
}

// min over the rows of (-v / dv where dv < 0, else BIG), for (s, ds) and
// (z, dz); every thread gets both.
template <class R, class DS, class DZ>
__device__ __forceinline__ float2 ratio_min(R& rows, int lane, int mI, DS&& ds, DZ&& dz) {
  float rs = kBig, rz = kBig;
  for_rows<R>(lane, mI, [&](int t, int) {
    const float a = ds(t), b = dz(t);
    rs = fminf(rs, a < 0.f ? __fdiv_rn(-rows.s(t), a) : kBig);
    rz = fminf(rz, b < 0.f ? __fdiv_rn(-rows.z(t), b) : kBig);
  });
  return make_float2(warp_min(rs), warp_min(rz));
}

// mu = sum_r s_r z_r / mI in the block order; every thread gets it.
template <class R>
__device__ __forceinline__ float lane_mu(R& rows, int lane, int mI) {
  const float inv_m = __fdiv_rn(1.f, (float)mI);
  return __fmul_rn(block_order_sum<R>(lane, mI, [&](int t, float p) {
                     return __fmaf_rn(rows.s(t), rows.z(t), p);
                   }),
                   inv_m);
}

// The iteration loop of one lane on one warp, for nz <= kN. On entry the
// caller has staged G (block-wide, synchronised), filled wm.H (kN x
// m_stride, row-major, zero past nz; M reads its lower triangle), zeroed
// wm.xs and wm.dxs, set each row's s, z and h in `rows`, and synchronised the
// warp; thread c holds g[c] (0 at c >= nz). Returns x[c] in thread c (0 at
// c >= nz); s, z are final. b is the lane's index (phase clocks).
template <int kN, class R>
__device__ __forceinline__ float solve(const float* Gs, const WarpMem& wm, R& rows, int mI,
                                       int nz, int iters, float tau, float d_cap, float g,
                                       int b) {
  constexpr int HS = kN + 1;
  const int lane = threadIdx.x & 31;
  const float inv_m = __fdiv_rn(1.f, (float)mI);
  float x = 0.f;
  PhaseClock clk;
  clk.start();
  for (int it = 0; it < iters; ++it) {
    float4 xv[kN / 4];
    load_vec<kN>(wm.xs, xv);
    for_rows<R>(lane, mI, [&](int t, int r) {
      const float gx = row_dot<kN>(Gs, r, xv);
      rows.rp(t) = __fsub_rn(__fadd_rn(gx, rows.s(t)), rows.h(t));
      const float ss = fmaxf(rows.s(t), 1e-25f);
      rows.d(t) = fminf(__fdiv_rn(rows.z(t), ss), d_cap);
      wm.v[r] = rows.z(t);
    });
    __syncwarp();
    clk.mark(kClkGx);
    const float gz = col_sum<kN>(Gs, wm.v, lane, mI, nz);  // G'z
    float rd = 0.f;
    if (lane < nz) {
      float hx = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) hx = __fmaf_rn(wm.H[lane * HS + j], wm.xs[j], hx);
      rd = __fadd_rn(__fadd_rn(hx, g), gz);
    }
    __syncwarp();
    for_rows<R>(lane, mI, [&](int t, int r) { wm.v[r] = rows.d(t); });
    __syncwarp();
    clk.mark(kClkGtz);
    assemble<kN>(Gs, wm, lane, mI, nz);
    __syncwarp();
    clk.mark(kClkAssemble);
    const float sc = lane < kN
                         ? __fdiv_rn(1.f, __fsqrt_rn(fmaxf(wm.M[lane * HS + lane], 1e-30f)))
                         : 1.f;
    clk.mark(kClkEquil);
    factor<kN>(wm, lane, sc);
    clk.mark(kClkFactor);

    // predictor
    const float mu = __fmul_rn(block_order_sum<R>(lane, mI, [&](int t, float p) {
                                 return __fmaf_rn(rows.s(t), rows.z(t), p);
                               }),
                               inv_m);
    kkt<kN>(Gs, wm, rows, lane, mI, nz, rd, sc,
            [&](int t) { return __fmul_rn(rows.s(t), rows.z(t)); },
            [&](int t, float ds, float dz) {
              rows.dsa(t) = ds;
              rows.dza(t) = dz;
            },
            clk);
    const float2 ra = ratio_min(rows, lane, mI, [&](int t) { return rows.dsa(t); },
                                [&](int t) { return rows.dza(t); });
    const float ap_a = fminf(1.f, ra.x), ad_a = fminf(1.f, ra.y);
    const float mu_aff = __fmul_rn(block_order_sum<R>(lane, mI, [&](int t, float p) {
                                     return __fmaf_rn(__fmaf_rn(ap_a, rows.dsa(t), rows.s(t)),
                                                      __fmaf_rn(ad_a, rows.dza(t), rows.z(t)),
                                                      p);
                                   }),
                                   inv_m);
    const float sr = __fdiv_rn(mu_aff, fmaxf(mu, 1e-25f));
    const float sigma = __fmul_rn(__fmul_rn(sr, sr), sr);
    clk.mark(kClkReduce);

    // corrector: its steps overwrite the predictor's once rc has used them
    const float dx = kkt<kN>(
        Gs, wm, rows, lane, mI, nz, rd, sc,
        [&](int t) {
          return __fmaf_rn(-sigma, mu, __fmaf_rn(rows.dsa(t), rows.dza(t),
                                                 __fmul_rn(rows.s(t), rows.z(t))));
        },
        [&](int t, float ds, float dz) {
          rows.dsa(t) = ds;
          rows.dza(t) = dz;
        },
        clk);
    const float2 rs = ratio_min(rows, lane, mI, [&](int t) { return rows.dsa(t); },
                                [&](int t) { return rows.dza(t); });
    const float ap = fminf(1.f, __fmul_rn(tau, rs.x)), ad = fminf(1.f, __fmul_rn(tau, rs.y));
    if (lane < nz) {
      x = __fmaf_rn(ap, dx, x);
      wm.xs[lane] = x;
    }
    for_rows<R>(lane, mI, [&](int t, int) {
      rows.s(t) = __fmaf_rn(ap, rows.dsa(t), rows.s(t));
      rows.z(t) = __fmaf_rn(ad, rows.dza(t), rows.z(t));
    });
    __syncwarp();
    clk.mark(kClkReduce);
  }
  clk.store(b);
  return x;
}

// Fill the warp's H (kN x m_stride, zero past nz) from a row-major nz x nz
// H_b in device memory.
template <int kN>
__device__ __forceinline__ void stage_h(const WarpMem& wm, const float* __restrict__ Hb,
                                        int lane, int nz) {
  constexpr int HS = kN + 1;
  for (int i = lane; i < kN * HS; i += 32) {
    const int p = i / HS, q = i - p * HS;
    wm.H[i] = (p < nz && q < nz) ? Hb[p * nz + q] : 0.f;
  }
}

}  // namespace mwarp
