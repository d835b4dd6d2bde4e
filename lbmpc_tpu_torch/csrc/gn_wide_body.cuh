// gn_wide_body.cuh — the Gauss-Newton phase of one lane on one thread block,
// at any nz <= 128 and for both families: the body of gn_wide.cu (K1w).
//
// The function is gn_body.cuh's (K1), widened. For the lane: the N-step
// learned rollout through the Nadaraya-Watson (NW) oracle window with its
// closed-form Jacobian, the sensitivities S_k = dx_k/dz, the residual stack
// e and H = 2 J'J + Hconst, g = 2 J'e. The two families of the reference
// (lbmpc_tpu/ops/pallas_gn.py:78-90, :118-125):
//   fmincon: u_k = Ks x_k + c_k, running stages 0..N-3, unscaled;
//   casadi:  u_k = c_k, running stages 0..N-1, each row scaled by
//            sqrt(delta). The du rows' Jacobians sqrt(delta) Lr (E_k - PSI_T)
//            are constant, so their 2 J'J part lives in Hconst (built on the
//            host, ops/gn_kernel.py, with the 1e-6 ridge and the rT rows)
//            and only their g term is computed here.
//
// Layout: one block of 64 (nz <= 64) or 128 threads per lane; thread c owns
// decision column c: S_k[:, c] and du_k/dz[c] sit in its registers, so the
// sensitivity update needs no communication. Each stage's NW sums (20 of
// them, as in K1) run over the window points strided across the block and
// close with warp shuffles and one block barrier; every thread then holds the
// stage's scalars. The stage's Jacobian rows go through a shared buffer D,
// and H (nz x nz, row-major) is accumulated in shared memory, thread c
// owning column c. Causality skips the exactly-zero entries: at stage k, D's
// nonzero columns are c <= k (fmincon; c < k for casadi) and theta (c = N),
// so only those threads update, and only over those rows. Entry (i, c) and
// (c, i) get the same terms in the same order (the products commute), so H
// comes out exactly symmetric. D and the NW partials are double-buffered by
// stage parity: two block barriers a stage.

#pragma once

#include <cuda_runtime.h>

#include "gn_body.cuh"

namespace gnw {

constexpr int kN = gn::kN;                 // state dimension
constexpr int kNzMax = 128;
constexpr int kMaxRows = kN + 1;           // Jacobian rows of a stage: rx (n) + ru (m=1)
constexpr int kSums = 20;                  // the NW sums of a stage
constexpr int kMaxWarps = 4;               // 128 threads

// The threads that run the GN phase at nz: gn_wide.cu's block size, and the
// part of K3w's block that runs it (the NW sums' order depends on it).
__host__ __device__ constexpr int threads(int nz) { return nz <= 64 ? 64 : 128; }

// The constant block: gn_body.cuh's layout, plus C_SQD (sqrt(delta) for the
// casadi family, 1 for fmincon); ops/gn_kernel.py writes the same offsets.
enum {
  C_A = gn::C_A, C_B = gn::C_B, C_KS = gn::C_KS, C_LQ = gn::C_LQ, C_LP = gn::C_LP,
  C_LAM = gn::C_LAM, C_XSREF = gn::C_XSREF, C_LR = gn::C_LR, C_PSI = gn::C_PSI,
  C_SQRTT = gn::C_SQRTT, C_INVBW2 = gn::C_INVBW2, C_RIDGE = gn::C_RIDGE, C_SQD = 69,
  C_HCONST = gn::C_HCONST
};

struct Shared {
  float* win;  // q * 8: the lane's window (gn::stage_window)
  float* H;    // nz * nz: the running 2 J'J
  float* D;    // 2 * kMaxRows * kNzMax: the stage's Jacobian rows, by parity
  float* red;  // 2 * kMaxWarps * kSums: the NW partials, by parity
};

__host__ __device__ constexpr size_t shared_floats(int q, int nz) {
  return (size_t)q * 8 + (size_t)nz * nz + 2 * kMaxRows * kNzMax + 2 * kMaxWarps * kSums;
}

__device__ __forceinline__ Shared carve(float* smem, int q, int nz) {
  Shared sh;
  sh.win = smem;
  sh.H = sh.win + q * 8;
  sh.D = sh.H + nz * nz;
  sh.red = sh.D + 2 * kMaxRows * kNzMax;
  return sh;
}

// H[:, c] += 2 sum_r D_r[:] D_r[c] over the rows i = 0..hi and theta (i =
// N), or over every row (all), by thread c, whose own entries are Dc.
template <int R>
__device__ __forceinline__ void add_outer(const Shared& sh, const float* D, const float (&Dc)[R],
                                          int c, int nz, int N, int hi, bool all) {
  const int last = all ? nz - 1 : hi;
  for (int i = 0; i <= last; ++i) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) a += D[r * kNzMax + i] * Dc[r];
    sh.H[i * nz + c] += 2.f * a;
  }
  if (!all) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) a += D[r * kNzMax + N] * Dc[r];
    sh.H[N * nz + c] += 2.f * a;
  }
}

// The GN phase of one lane, run by the first T threads of the block (thread
// c = column c; T = 64 or 128, a multiple of 32 and >= nz): reads the
// constant block cst, the lane's z (nz = N + 1) and dx0 (kN), and its window
// staged in sh.win (synchronised by the caller); writes e (ne floats) to eb
// (thread 0) and leaves 2 J'J (without Hconst) in sh.H, synchronised.
// Returns g[c] in thread c < nz. Threads c >= T (a larger block: K3w's) take
// part in every barrier and in nothing else, so the sums run in the same
// order, and round the same, at any block size.
template <bool kCasadi>
__device__ __forceinline__ float lane(const Shared& sh, const float* __restrict__ cst,
                                      const float* __restrict__ zb,
                                      const float* __restrict__ dx0b, int N, int q,
                                      float* __restrict__ eb, int T) {
  constexpr int R = kCasadi ? kN : kN + 1;     // rows with a per-lane Jacobian
  const int c = threadIdx.x;
  const int lane_id = c & 31, warp = c >> 5, nwarps = T >> 5;
  const bool active = c < T;
  const int nz = N + 1;
  const int n_run = kCasadi ? N : N - 2;
  const bool col = c < nz;

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
  const float inv_bw2 = cst[C_INVBW2], ridge = cst[C_RIDGE], sqd = cst[C_SQD];

  if (active)
    for (int e = c; e < nz * nz; e += T) sh.H[e] = 0.f;

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
    const int par = k & 1;
    float u, dudz;
    if (kCasadi) {
      u = zb[k];
      dudz = (c == k) ? 1.f : 0.f;
    } else {
      u = Ks[0] * x[0] + Ks[1] * x[1] + Ks[2] * x[2] + Ks[3] * x[3] + zb[k];
      dudz = Ks[0] * S[0] + Ks[1] * S[1] + Ks[2] * S[2] + Ks[3] * S[3]
             + ((c == k) ? 1.f : 0.f);
    }

    // NW oracle at xi = (x0, x1, u): the 20 sums of gn_body.cuh over the
    // points, strided across the block
    float acc[kSums];
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = 0.f;
    for (int p = c; active && p < q; p += T) {
      const float* w = sh.win + p * 8;
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
    float* red = sh.red + par * kMaxWarps * kSums;
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      const float v = gn::warp_sum(acc[i]);
      if (lane_id == 0 && warp < nwarps) red[warp * kSums + i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSums; ++i) {
      float v = 0.f;
      for (int w = 0; w < nwarps; ++w) v += red[w * kSums + i];
      acc[i] = v;
    }
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
      float er[kN + 1], Dr[kN + 1];
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        float ev = 0.f, dv = 0.f;
#pragma unroll
        for (int j = 0; j < kN; ++j) {
          ev += Lq[i * kN + j] * (x[j] - xa[j]);
          dv += Lq[i * kN + j] * (S[j] - LAM[j] * lam_c);
        }
        er[i] = kCasadi ? sqd * ev : ev;
        Dr[i] = kCasadi ? sqd * dv : dv;
      }
      er[kN] = Lr * (u - ua);
      Dr[kN] = Lr * (dudz - PSI * lam_c);
      if (kCasadi) {
        er[kN] = sqd * er[kN];
        Dr[kN] = sqd * Dr[kN];
      }
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < kN; ++i) eb[k * kN + i] = er[i];
        eb[n_run * kN + k] = er[kN];
      }
      if (col) {
#pragma unroll
        for (int r = 0; r <= kN; ++r) gacc += 2.f * er[r] * Dr[r];
      }
      float* D = sh.D + par * kMaxRows * kNzMax;
      float Dc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Dc[r] = Dr[r];
        if (col) D[r * kNzMax + c] = Dr[r];
      }
      __syncthreads();
      // causal columns of this stage's rows: c <= k (fmincon: du/dz has
      // column k) or c < k (casadi: S_k only), and theta
      const int hi = kCasadi ? k - 1 : k;
      if (col && (c <= hi || c == N)) add_outer<R>(sh, D, Dc, c, nz, N, hi, false);
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
  const int base = n_run * (kN + 1);
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
  float* D = sh.D + (N & 1) * kMaxRows * kNzMax;
  if (col) {
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      D[r * kNzMax + c] = Dr[r];
      gacc += 2.f * er[r] * Dr[r];
    }
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float rT = sqrtT * (xa[i] - xsr[i]);
    if (c == 0) {
      eb[base + i] = er[i];
      eb[base + kN + i] = rT;
    }
    gacc += 2.f * rT * (sqrtT * LAM[i] * lam_c);
  }
  __syncthreads();
  if (col) add_outer<kN>(sh, D, Dr, c, nz, N, nz - 1, true);
  __syncthreads();
  return gacc;
}

}  // namespace gnw
