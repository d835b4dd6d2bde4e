// gn_body.cuh — the Gauss-Newton phase of one lane on one warp, shared by
// gn_phase.cu (K1) and gn_mehrotra.cu (K3).
//
// For the lane: the N-step learned rollout with u_k = Ks x_k + c_k through
// the Nadaraya-Watson (NW) oracle window, the closed-form NW Jacobian, the
// sensitivities S_k = dx_k/dz, the residual stack e (fmincon family: running
// stages 0..N-3, then rP and rT), and the Gauss-Newton normal terms
// H = 2 J'J + Hconst and g = 2 J'e. Hconst (built on the host,
// ops/gn_kernel.py) folds the 1e-6 ridge and the constant rT rows of J.
//
// Layout: the warp's own shared memory holds the constants (up to Hconst),
// the lane's window (X, Y, valid: q * 8 floats) and the stage's Jacobian
// rows D (a float4 of rows 0..3 and row 4, a column each). Lane l walks the
// window points l, l + 32, ... and the stage's 20 NW sums close with the
// butterfly's own xor pairings run as a reduce-scatter (21 shuffles for 20
// sums, the butterfly's sums bit for bit); each sum's owner divides it by
// the denominator once and broadcasts the quotient. Lane c owns column c of
// S and of du/dz in registers, so the sensitivity update needs no
// communication. Only H's lower triangle is accumulated, in shared memory at
// a row stride the caller gives: at stage k only the causal entries (rows
// and columns 0..k, and row N's) can be nonzero, and they spread evenly over
// the lanes, each entry from the same terms in the same order as a full
// update would take them. store_h (K1) and mirror_h (K3) add Hconst and
// mirror the triangle.
//
// Rounding: the kernels that include this file are built with nvcc's
// default contraction, and every expression here is the one the body it
// replaced (H's pairs in registers, 20 full butterflies a stage) wrote, so
// they fuse the same multiply-adds and K1 and K3 return that body's bits
// (tools/k1_k4_compare.py checks it against an earlier tree).

#pragma once

#include <cuda_runtime.h>

namespace gn {

constexpr int kNzMax = 32;                                   // nz <= one warp
constexpr int kN = 4;                                        // state dimension
constexpr int kStageRows = kN + 1;                           // rx (n) + ru (m=1)
constexpr int kSums = 20;                                    // the NW sums of a stage
constexpr unsigned kFull = 0xffffffffu;

// Constant block layout; ops/gn_kernel.py writes the same offsets.
enum {
  C_A = 0, C_B = 16, C_KS = 20, C_LQ = 24, C_LP = 40, C_LAM = 56,
  C_XSREF = 60, C_LR = 64, C_PSI = 65, C_SQRTT = 66, C_INVBW2 = 67,
  C_RIDGE = 68, C_HCONST = 72
};

// Floats of a lane's working memory around gn::lane (work_floats(q)): the
// constants before Hconst, the window, and D (32 float4s, then 32 floats).
// ops/gn_kernel.py and ops/qp_kernel.py size shared memory by the same sum.
constexpr int kDFloats = 5 * 32;
__host__ __device__ constexpr int work_floats(int q) { return C_HCONST + 8 * q + kDFloats; }

__host__ __device__ constexpr int tri(int i) { return i * (i + 1) / 2; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The lane that holds sum i after reduce_scatter.
__host__ __device__ constexpr int rs_lane(int i) {
  return 16 * (i / 10) + 8 * (i % 10 / 5)
         + (i % 5 == 1 ? 2 : i % 5 == 2 ? 1 : i % 5 == 3 ? 4 : i % 5 == 4 ? 6 : 0);
}

// The lanes whose quotient a stage reads: the owners of sums 1..19.
__host__ __device__ constexpr unsigned quotient_lanes() {
  unsigned m = 0;
  for (int i = 1; i < kSums; ++i) m |= 1u << rs_lane(i);
  return m;
}
constexpr unsigned kQuotientLanes = quotient_lanes();

// warp_sum of 20 values at once: at each xor offset 16, 8, 4, 2, 1 a lane
// adds its partner's value to its own (the butterfly's sums, bit for bit),
// but keeps only the sums its half of the pair needs from then on. Returns,
// in lane l, the butterfly's sum of value i for the i whose rs_lane(i) is l
// (lanes 1 apart with equal bits 1..4 hold the sum of value 2 + 5 b3 +
// 10 b4 both); v is clobbered.
__device__ __forceinline__ float reduce_scatter(float (&v)[kSums], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2, b0 = lane & 1;
#pragma unroll
  for (int j = 0; j < 10; ++j) {  // 20 -> 10: value j + 10 b4
    const float keep = b4 ? v[j + 10] : v[j], send = b4 ? v[j] : v[j + 10];
    v[j] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) {  // 10 -> 5: value j + 5 b3 + 10 b4
    const float keep = b3 ? v[j + 5] : v[j], send = b3 ? v[j] : v[j + 5];
    v[j] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {  // 5 -> 3: (j + 3 b2), and 2 in both halves
    const float keep = b2 ? v[j + 3] : v[j], send = b2 ? v[j] : v[j + 3];
    v[j] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  v[2] = v[2] + __shfl_xor_sync(kFull, v[2], 4);
  {  // 3 -> 2: (b1 ? 1 : 0) + 3 b2, and 2
    const float keep = b1 ? v[1] : v[0], send = b1 ? v[0] : v[1];
    v[0] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  v[2] = v[2] + __shfl_xor_sync(kFull, v[2], 2);
  const float keep = b0 ? v[2] : v[0], send = b0 ? v[0] : v[2];  // 2 -> 1
  return keep + __shfl_xor_sync(kFull, send, 1);
}

// Stage lane b's window into win: point p -> win[p*8 + {0..2: X, 3..6: Y,
// 7: valid}]. Thread `t` of `nthreads` cooperating threads.
__device__ __forceinline__ void stage_window(float* win, const float* __restrict__ X,
                                             const float* __restrict__ Y,
                                             const float* __restrict__ valid, size_t b,
                                             int q, int t, int nthreads) {
  const float* Xb = X + b * q * 3;
  const float* Yb = Y + b * q * kN;
  const float* vb = valid + b * q;
  for (int i = t; i < q * 3; i += nthreads) win[(i / 3) * 8 + (i % 3)] = Xb[i];
  for (int i = t; i < q * kN; i += nthreads) win[(i / kN) * 8 + 3 + (i % kN)] = Yb[i];
  for (int i = t; i < q; i += nthreads) win[i * 8 + 7] = vb[i];
}

// A lane's working memory (work_floats(q) floats from `base`, which must be
// 16-byte aligned): the constants, the window, the Jacobian rows.
struct LaneMem {
  float* cs;    // C_HCONST: the constant block before Hconst
  float* win;   // q * 8
  float4* Dv;   // 32: rows 0..3 of D, a column each
  float* D4;    // 32: row 4 of D
};

__device__ __forceinline__ LaneMem carve(float* base, int q) {
  LaneMem m;
  m.cs = base;
  m.win = base + C_HCONST;
  m.Dv = reinterpret_cast<float4*>(m.win + 8 * q);
  m.D4 = m.win + 8 * q + 4 * 32;
  return m;
}

// Lane b's constants and window into m, by the warp's lanes (the caller
// then synchronises the warp).
__device__ __forceinline__ void stage(const LaneMem& m, const float* __restrict__ cst,
                                      const float* __restrict__ X, const float* __restrict__ Y,
                                      const float* __restrict__ valid, size_t b, int q,
                                      int lane) {
  for (int i = lane; i < C_HCONST; i += 32) m.cs[i] = cst[i];
  stage_window(m.win, X, Y, valid, b, q, lane, 32);
}

// Ha[i hs + j] += 2 sum_r D_r[i] D_r[j] over the first E entries (i, j),
// j <= i, of the lower triangle taken row by row, lane-strided: (i, j) is
// the lane's first entry, and each step of 32 entries walks along the rows.
// Entry (i, j) takes a = sum_r D_r[i] D_r[j] from 0.f in r order, as the
// replaced body took it for (j, i).
template <int R>
__device__ __forceinline__ void add_rows(float* Ha, int hs, const float4* Dv, const float* D4,
                                         int E, int lane, int i, int j) {
  for (int e = lane; e < E; e += 32) {
    const float4 di = Dv[i], dj = Dv[j];
    float a = 0.f;
    a += di.x * dj.x;
    a += di.y * dj.y;
    a += di.z * dj.z;
    a += di.w * dj.w;
    if (R > kN) a += D4[i] * D4[j];
    Ha[i * hs + j] += 2.f * a;
    j += 32;
    while (j > i) {
      j -= i + 1;
      ++i;
    }
  }
}

// The GN phase of one lane, run by one whole warp (lane c): reads the
// constants, the window (both staged in m and synchronised by the caller),
// the lane's z (nz = N + 1) and dx0 (kN); uses m's D; writes e (ne floats)
// to eb; adds 2 J'J's lower triangle (rows and columns < nz, row stride hs)
// into Ha, which the caller zeroed. Returns g[c] in lane c < nz. Ends with
// the warp synchronised.
__device__ __forceinline__ float lane(const LaneMem& m, const float* __restrict__ zb,
                                      const float* __restrict__ dx0b, float* Ha, int hs,
                                      int c, int N, int q, float* eb) {
  const int nz = N + 1;
  const int n_run = N - 2;
  const float* cs = m.cs;
  const float* A = cs + C_A;
  const float* Bv = cs + C_B;
  const float* Ks = cs + C_KS;
  const float* Lq = cs + C_LQ;
  const float* Lp = cs + C_LP;
  const float* LAM = cs + C_LAM;
  const float* xsr = cs + C_XSREF;
  const float Lr = cs[C_LR], PSI = cs[C_PSI], sqrtT = cs[C_SQRTT];
  const float inv_bw2 = cs[C_INVBW2], ridge = cs[C_RIDGE];
  const float4* win4 = reinterpret_cast<const float4*>(m.win);
  const bool quotient = (kQuotientLanes >> c) & 1u;

  // the row and column of the lane's first entry of the lower triangle
  int i0 = 0;
  while (tri(i0 + 1) <= c) ++i0;
  const int j0 = c - tri(i0);
  float gacc = 0.f;

  const float theta = zb[N];
  const float lam_c = (c == N) ? 1.f : 0.f;  // theta column indicator
  float xa[kN], x[kN], S[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    xa[i] = LAM[i] * theta;
    x[i] = dx0b[i];
    S[i] = 0.f;
  }
  const float ua = PSI * theta;

  for (int k = 0; k < N; ++k) {
    const float u = Ks[0] * x[0] + Ks[1] * x[1] + Ks[2] * x[2] + Ks[3] * x[3] + zb[k];
    const float dudz = Ks[0] * S[0] + Ks[1] * S[1] + Ks[2] * S[2] + Ks[3] * S[3]
                       + ((c == k) ? 1.f : 0.f);

    // NW oracle at xi = (x0, x1, u): value and closed-form Jacobian from
    // 20 sums — [0] sum k, [1..4] sum k Y, [5..7] sum k diff,
    // [8..19] sum k Y_o diff_d (o-major)
    float acc[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
    for (int p = c; p < q; p += 32) {
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
    const float tot = reduce_scatter(acc, c);
    const float denom = ridge + __shfl_sync(kFull, tot, rs_lane(0));
    // each quotient divided once, by its sum's owner; a lane whose quotient
    // nobody reads divides 1 (a zero or tiny operand would send the whole
    // warp down the division's slow path)
    const float quot = (quotient ? tot : 1.f) / denom;
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

    // residual + Jacobian rows at stage k use the pre-update state
    if (k < n_run) {
      float er[kStageRows], Dr[kStageRows];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        float ev = 0.f, dv = 0.f;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          ev += Lq[i * kN + j] * (x[j] - xa[j]);
          dv += Lq[i * kN + j] * (S[j] - LAM[j] * lam_c);
        }
        er[i] = ev;
        Dr[i] = dv;
      }
      er[kN] = Lr * (u - ua);
      Dr[kN] = Lr * (dudz - PSI * lam_c);
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < kN; ++i) eb[k * kN + i] = er[i];
        eb[n_run * kN + k] = er[kN];
      }
      if (c < nz) {
        m.Dv[c] = make_float4(Dr[0], Dr[1], Dr[2], Dr[3]);
        m.D4[c] = Dr[kN];
#pragma unroll
        for (int r = 0; r < kStageRows; ++r) gacc += 2.f * er[r] * Dr[r];
      }
      __syncwarp();
      // the causal entries: D's columns 0..k (S_k reaches z_0..z_{k-1},
      // du_k/dz also z_k) and theta; rows 0..k, then row N
      add_rows<kStageRows>(Ha, hs, m.Dv, m.D4, tri(k + 1), c, i0, j0);
      if (c <= k + 1) {
        const int j = c <= k ? c : N;
        const float4 dn = m.Dv[N], dj = m.Dv[j];
        float a = 0.f;
        a += dn.x * dj.x;
        a += dn.y * dj.y;
        a += dn.z * dj.z;
        a += dn.w * dj.w;
        a += m.D4[N] * m.D4[j];
        Ha[N * hs + j] += 2.f * a;
      }
      __syncwarp();
    }

    // state + sensitivity update (dxi/dz = [S_0, S_1, du/dz])
    float xn[kN], Sn[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      float xv = 0.f, sv = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        xv += A[i * kN + j] * x[j];
        sv += A[i * kN + j] * S[j];
      }
      xn[i] = xv + Bv[i] * u + yhat[i];
      Sn[i] = sv + Bv[i] * dudz + Jg[i][0] * S[0] + Jg[i][1] * S[1] + Jg[i][2] * dudz;
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      x[i] = xn[i];
      S[i] = Sn[i];
    }
  }

  // terminal rows: rP = Lp (x_N - xa), every column; rT = sqrtT (xa -
  // xs_ref), whose constant Jacobian rows live in Hconst (g term only)
  const int base = n_run * kStageRows;
  float er[kN], Dr[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float ev = 0.f, dv = 0.f;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      ev += Lp[i * kN + j] * (x[j] - xa[j]);
      dv += Lp[i * kN + j] * (S[j] - LAM[j] * lam_c);
    }
    er[i] = ev;
    Dr[i] = dv;
  }
  if (c == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) eb[base + i] = er[i];
  }
  if (c < nz) {
    m.Dv[c] = make_float4(Dr[0], Dr[1], Dr[2], Dr[3]);
#pragma unroll
    for (int r = 0; r < kN; ++r) gacc += 2.f * er[r] * Dr[r];
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float rT = sqrtT * (xa[i] - xsr[i]);
    if (c == 0) eb[base + kN + i] = rT;
    gacc += 2.f * rT * (sqrtT * LAM[i] * lam_c);
  }
  __syncwarp();
  add_rows<kN>(Ha, hs, m.Dv, m.D4, tri(nz), c, i0, j0);
  __syncwarp();
  return gacc;
}

// K1's store: H (nz x nz, row-major, exactly symmetric) = the accumulated
// lower triangle (row stride hs) + Hconst, read at (min, max) as the
// replaced body read it; lane c writes column c.
__device__ __forceinline__ void store_h(const float* Ha, int hs, const float* __restrict__ Hc,
                                        float* __restrict__ Hb, int nz, int c) {
  if (c >= nz) return;
#pragma unroll 4
  for (int i = 0; i < nz; ++i) {  // unrolled: several rows' Hconst loads in flight
    const int lo = min(i, c), hi = max(i, c);
    Hb[i * nz + c] = Ha[hi * hs + lo] + __ldg(Hc + lo * nz + hi);
  }
}

// K3's finish in place: each lower entry (i, j) becomes Ha + Hconst[j][i],
// copied to (j, i). A lane finishes the entries of its own walk (every
// entry is read and written by one lane; upper entries are only written).
__device__ __forceinline__ void mirror_h(float* Ha, int hs, const float* __restrict__ Hc,
                                         int nz, int lane) {
  int i = 0;
  while (tri(i + 1) <= lane) ++i;
  int j = lane - tri(i);
  for (int e = lane; e < tri(nz); e += 32) {
    const float v = Ha[i * hs + j] + __ldg(Hc + j * nz + i);
    Ha[i * hs + j] = v;
    Ha[j * hs + i] = v;
    j += 32;
    while (j > i) {
      j -= i + 1;
      ++i;
    }
  }
}

}  // namespace gn
