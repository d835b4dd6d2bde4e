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
// Layout: the lane's window (X, Y, valid: q * 8 floats) sits in shared
// memory; each thread walks every 32nd window point and the 20 NW sums close
// with butterfly shuffles, so every thread holds the stage's scalars. Thread
// c owns column c of S and of du/dz in registers, so the sensitivity update
// needs no communication. The Jacobian rows of a stage go through a small
// shared buffer D (kStageRows * 32 floats), and each thread accumulates a
// fixed set of the nz(nz+1)/2 unique entries of H in registers across all
// stages. H (nz x nz, row-major, symmetric) and e are written once at the
// end; g stays in the threads (thread c holds g[c]).

#pragma once

#include <cuda_runtime.h>

namespace gn {

constexpr int kNzMax = 32;                                   // nz <= one warp
constexpr int kPairSlots = (kNzMax * (kNzMax + 1) / 2 + 31) / 32;
constexpr int kN = 4;                                        // state dimension
constexpr int kStageRows = kN + 1;                           // rx (n) + ru (m=1)
constexpr unsigned kFull = 0xffffffffu;

// Constant block layout; ops/gn_kernel.py writes the same offsets.
enum {
  C_A = 0, C_B = 16, C_KS = 20, C_LQ = 24, C_LP = 40, C_LAM = 56,
  C_XSREF = 60, C_LR = 64, C_PSI = 65, C_SQRTT = 66, C_INVBW2 = 67,
  C_RIDGE = 68, C_HCONST = 72
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
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

// H += 2 sum_r D_r D_r', g += 2 sum_r e_r D_r for R Jacobian rows; thread c
// holds entry c of each row in Dr and the residuals in er.
template <int R>
__device__ __forceinline__ void accumulate(const float (&Dr)[R], const float (&er)[R],
                                           float* D, int c, int nz,
                                           const int (&pi)[kPairSlots],
                                           const int (&pj)[kPairSlots],
                                           float (&hacc)[kPairSlots], float& gacc) {
#pragma unroll
  for (int r = 0; r < R; ++r) D[r * 32 + c] = (c < nz) ? Dr[r] : 0.f;
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kPairSlots; ++s) {
    if (pi[s] >= 0) {
      float a = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) a += D[r * 32 + pi[s]] * D[r * 32 + pj[s]];
      hacc[s] += 2.f * a;
    }
  }
  if (c < nz) {
#pragma unroll
    for (int r = 0; r < R; ++r) gacc += 2.f * er[r] * Dr[r];
  }
  __syncwarp();
}

// The GN phase of one lane, run by one whole warp (thread c = lane c):
// reads the constant block cst, the lane's z (nz = N + 1) and dx0 (kN), and
// its window staged in win (synchronised by the caller); uses D as scratch;
// writes e (ne floats) to eb and H (nz x nz) to Hb, which may point to
// global or shared memory, with row stride hs. Returns g[c] in thread c < nz.
__device__ __forceinline__ float lane(const float* __restrict__ cst,
                                      const float* __restrict__ zb,
                                      const float* __restrict__ dx0b, const float* win,
                                      float* D, int c, int N, int q, float* eb,
                                      float* Hb, int hs) {
  const int nz = N + 1;
  const int n_run = N - 2;

  float A[16], Bv[kN], Ks[kN], Lq[16], Lp[16], LAM[kN], xsr[kN];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    A[i] = cst[C_A + i];
    Lq[i] = cst[C_LQ + i];
    Lp[i] = cst[C_LP + i];
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    Bv[i] = cst[C_B + i];
    Ks[i] = cst[C_KS + i];
    LAM[i] = cst[C_LAM + i];
    xsr[i] = cst[C_XSREF + i];
  }
  const float Lr = cst[C_LR], PSI = cst[C_PSI], sqrtT = cst[C_SQRTT];
  const float inv_bw2 = cst[C_INVBW2], ridge = cst[C_RIDGE];
  const float* Hc = cst + C_HCONST;

  // this thread's unique H entries (i <= j), enumerated row by row
  const int npairs = nz * (nz + 1) / 2;
  int pi[kPairSlots], pj[kPairSlots];
  float hacc[kPairSlots];
#pragma unroll
  for (int s = 0; s < kPairSlots; ++s) {
    int p = c + 32 * s, i = -1, j = -1;
    if (p < npairs) {
      i = 0;
      while (p >= nz - i) { p -= nz - i; ++i; }
      j = i + p;
    }
    pi[s] = i;
    pj[s] = j;
    hacc[s] = 0.f;
  }
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
    float acc[20];
#pragma unroll
    for (int i = 0; i < 20; ++i) acc[i] = 0.f;
    for (int p = c; p < q; p += 32) {
      const float* w = win + p * 8;
      const float d0 = w[0] - x[0], d1 = w[1] - x[1], d2 = w[2] - u;
      const float sq = d0 * d0 + d1 * d1 + d2 * d2;
      const float kv = expf(-sq * inv_bw2) * w[7];
      acc[0] += kv;
      acc[5] += kv * d0;
      acc[6] += kv * d1;
      acc[7] += kv * d2;
#pragma unroll
      for (int o = 0; o < kN; ++o) {
        const float ky = kv * w[3 + o];
        acc[1 + o] += ky;
        acc[8 + 3 * o] += ky * d0;
        acc[9 + 3 * o] += ky * d1;
        acc[10 + 3 * o] += ky * d2;
      }
    }
#pragma unroll
    for (int i = 0; i < 20; ++i) acc[i] = warp_sum(acc[i]);
    const float denom = ridge + acc[0];
    float yhat[kN], s1[3], Jg[kN][3];
#pragma unroll
    for (int d = 0; d < 3; ++d) s1[d] = acc[5 + d] / denom;
#pragma unroll
    for (int o = 0; o < kN; ++o) {
      yhat[o] = acc[1 + o] / denom;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        Jg[o][d] = 2.f * inv_bw2 * (acc[8 + 3 * o + d] / denom - yhat[o] * s1[d]);
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
      accumulate<kStageRows>(Dr, er, D, c, nz, pi, pj, hacc, gacc);
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

  // terminal rows: rP = Lp (x_N - xa); rT = sqrtT (xa - xs_ref), whose
  // constant Jacobian rows live in Hconst (only their g term is per lane)
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
  accumulate<kN>(Dr, er, D, c, nz, pi, pj, hacc, gacc);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float rT = sqrtT * (xa[i] - xsr[i]);
    if (c == 0) eb[base + kN + i] = rT;
    gacc += 2.f * rT * (sqrtT * LAM[i] * lam_c);
  }

#pragma unroll
  for (int s = 0; s < kPairSlots; ++s) {
    if (pi[s] >= 0) {
      const float v = hacc[s] + Hc[pi[s] * nz + pj[s]];
      Hb[pi[s] * hs + pj[s]] = v;
      Hb[pj[s] * hs + pi[s]] = v;
    }
  }
  return gacc;
}

}  // namespace gn
