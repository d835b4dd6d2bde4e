"""Invariant-set algorithms: MPIS, mRPIS, reach sets, ROA.

Re-implementations (from the underlying algorithms, not the MATLAB code paths)
of the reference's set-computation layer:
  - compute_mpis  (ref: functions/compute_MPIS.m:11-22 — Gilbert-Tan fixpoint)
  - calc_mrpis    (ref: functions/calc_mRPIS.m — Rakovic et al. eps-outer mRPIS)
  - reach_set     (ref: functions/reach_set.m — truncated Minkowski series)
  - roa           (ref: trackingMPC/ROA.m:16-34 — N-step backward reachable set)
"""

from __future__ import annotations

import numpy as np

from lbmpc_tpu_torch.sets.polytope import Polytope, _linprog_max


def compute_mpis(Xw: Polytope, Aw: np.ndarray, max_iter: int = 500) -> Polytope:
    """Maximal positively invariant set of x+ = Aw x inside Xw.

    Gilbert-Tan fixpoint: O_i = ∩_{k<=i} {F Aw^k x <= 1} until O_{i+1} = O_i.
    The H-rep is normalized to rhs = 1 first (ref: compute_MPIS.m:7).
    Termination check uses per-row support LPs (row redundancy) instead of
    MPT's polytope equality — equivalent but one LP per new row.
    """
    Xn = Xw.normalize()
    F0 = Xn.F
    cur_F = F0.copy()
    cur_h = np.ones(F0.shape[0])
    Ak = np.asarray(Aw, float)
    Apow = Ak.copy()
    for _ in range(max_iter):
        # candidate new rows: F0 @ Apow, rhs 1
        newF = F0 @ Apow
        # a new row is redundant iff its support over current set <= 1
        add_rows = []
        for f in newF:
            if _linprog_max(f, cur_F, cur_h) > 1.0 + 1e-9:
                add_rows.append(f)
        if not add_rows:
            return Polytope(cur_F, cur_h)
        cur_F = np.vstack([cur_F, np.array(add_rows)])
        cur_h = np.concatenate([cur_h, np.ones(len(add_rows))])
        Apow = Apow @ Ak
    raise RuntimeError("MPIS fixpoint did not converge")


def reach_set(Ak: np.ndarray, W: Polytope, s: int) -> Polytope:
    """Z = W ⊕ Ak W ⊕ ... ⊕ Ak^{s-1} W (ref: reach_set.m:5-11)."""
    Z = W
    Apow = np.asarray(Ak, float)
    for _ in range(1, s):
        Z = Z.minkowski_sum(W.linear_map(Apow))
        Apow = Apow @ Ak
    return Z


def calc_mrpis(Ak: np.ndarray, F_w: np.ndarray, h_w: np.ndarray, eps: float) -> Polytope:
    """Rakovic eps-outer approximation of the minimal robust PI set.

    Ref: functions/calc_mRPIS.m — find smallest s with
    alpha(s) <= eps/(eps+M(s)), then Z = (1-alpha)^-1 * reach_set(Ak, W, s).
    """
    W = Polytope(F_w, h_w)
    Ak = np.asarray(Ak, float)
    n = Ak.shape[0]
    s = 0
    while True:
        s += 1
        As = np.linalg.matrix_power(Ak, s)
        # alpha = max_i  h_W(As' F_i) / h_i
        alphas = [
            _linprog_max(As.T @ F_w[i], F_w, h_w) / h_w[i] for i in range(len(h_w))
        ]
        alpha = max(alphas)
        # M(s): max over basis directions of sum of support functions
        M_vals = []
        for j in range(n):
            e = np.zeros(n)
            e[j] = 1.0
            mp = sum(
                _linprog_max(np.linalg.matrix_power(Ak, k).T @ e, F_w, h_w)
                for k in range(0, max(s - 1, 0))
            )
            mm = sum(
                _linprog_max(-(np.linalg.matrix_power(Ak, k).T @ e), F_w, h_w)
                for k in range(0, max(s - 1, 0))
            )
            M_vals.append(max(mp, mm))
        M = max(M_vals) if M_vals else 0.0
        if M > 0 and alpha <= eps / (eps + M):
            break
        if s > 200:
            raise RuntimeError("mRPIS s-search did not converge")
    Z = reach_set(Ak, W, s)
    return Z.scale(1.0 / (1.0 - alpha))




def roa_preimage(Ak: np.ndarray, W: Polytope, N: int) -> Polytope:
    """Forward ROA variant (ref: utilities/ROA.m:5-19): the N-step preimage
    of the terminal region W under the PRESTABILIZED closed loop x+ = Ak x —
    {x : Ak^N x in W}. The reference iterates Polyhedron(F Ak, h) with a
    no-op projection; algebraically each step maps F <- F Ak, so the result
    is one matrix power. Redundant rows are pruned by the LP-based min_hrep
    (what MPT's minVRep call amounted to)."""
    Ak = np.asarray(Ak, float)
    return Polytope(W.F @ np.linalg.matrix_power(Ak, N), W.h).min_hrep()


def roa(
    Xf: Polytope,
    A: np.ndarray,
    B: np.ndarray,
    Xc: Polytope,
    Uc: Polytope,
    N: int,
) -> Polytope:
    """N-step region of attraction: backward reachable set of Xf under
    x+ = A x + B u, x in Xc, u in Uc (ref: trackingMPC/ROA.m:16-34).

    Each backward step solves Pre(S) = proj_x { (x,u) : A x + B u in S,
    x in Xc, u in Uc } via Fourier-Motzkin projection.
    """
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    n = A.shape[0]
    m = B.shape[1]
    S = Xf
    for _ in range(N):
        # lifted constraints on (x, u)
        F_l = np.vstack(
            [
                np.hstack([S.F @ A, S.F @ B]),
                np.hstack([Xc.F, np.zeros((Xc.nrows, m))]),
                np.hstack([np.zeros((Uc.nrows, n)), Uc.F]),
            ]
        )
        h_l = np.concatenate([S.h, Xc.h, Uc.h])
        S = Polytope(F_l, h_l).project(range(n)).min_hrep()
    return S
