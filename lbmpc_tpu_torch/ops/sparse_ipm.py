"""Sparse-path IPM: interior point on the stage-wise (DMS) OCP form with a
Riccati factorization of the block-banded KKT systems, batched over lanes.

Port of lbmpc_tpu/ops/sparse_ipm.py. The condensed QP
(controllers/condensed.py) eliminates the states up front, which suits
short horizons; for long ones the stage variables stay and each Newton
system is factored by a Riccati sweep (the lifted DMS NLPs the reference
MATLAB hands to IPOPT/MUMPS, examples/DMS_LBMPC_casadi.m:130).

Problem (delta coordinates, casadi-family tracking semantics):

  min  sum_{k=0}^{N-1} delta*[(x_k-L th)'Q(x_k-L th) + (u_k-S th)'R(u_k-S th)]
       + (x_N-L th)'P(x_N-L th) + th'L'T L th
  s.t. x_{k+1} = A x_k + B u_k,  x_0 fixed,
       F_x x_k <= h_x (k=1..N),  F_u u_k <= h_u (k=0..N-1),
       F_wN [x_N; th] <= h_wN.

theta couples all stages; each Newton system is solved by a Schur complement
on theta: nth + 1 Riccati right-hand sides whose coupling columns are shared
between the Mehrotra predictor and corrector. The stage data is shared by
the lanes; x0 (B, n) sets them, and every reduction the reference makes
inside one problem (mu, mu_aff, the step lengths, the violation, the freeze,
sigma) stays inside its lane.

The sequential route factors the stage weights once an iteration and sweeps
the right-hand sides against that factor as the columns of one matrix (the
theta columns with the predictor, then the corrector): the same arithmetic
per column as the reference's one sweep per right-hand side. parallel=True
routes every right-hand side through ops/riccati.lqr_parallel, as the
reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.ops.lanes import lane_sum
from lbmpc_tpu_torch.ops.riccati import _inv, _solve, lqr_parallel, scan_peak_bytes


class StageQP(NamedTuple):
    """Static OCP data (tensors on the solver's device, no lane axis);
    weights pre-doubled so they are the exact Hessian blocks."""

    A: torch.Tensor
    B: torch.Tensor
    Qb: torch.Tensor     # 2*delta*Q
    Rb: torch.Tensor     # 2*delta*R
    Pb: torch.Tensor     # 2*P
    Tb: torch.Tensor     # 2*LAM' T LAM
    LAM: torch.Tensor
    PSI: torch.Tensor
    F_x: torch.Tensor
    h_x: torch.Tensor
    F_u: torch.Tensor
    h_u: torch.Tensor
    Fw_x: torch.Tensor
    Fw_th: torch.Tensor
    h_w: torch.Tensor
    N: int


def make_stage_qp(A, B, Q, R, P, T, LAMBDA, PSI, cs, N, delta,
                  dtype=torch.float64, device=None) -> StageQP:
    """The stage data from host matrices (numpy), as `dtype` tensors on
    `device` (CUDA unless named)."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    LAM = np.atleast_2d(np.asarray(LAMBDA, float))
    PSI_ = np.atleast_2d(np.asarray(PSI, float))
    n = np.asarray(A).shape[0]
    F_w_N = np.asarray(cs.F_w_N, float)
    return StageQP(
        A=t(A), B=t(B),
        Qb=t(2.0 * delta * np.asarray(Q, float)),
        Rb=t(2.0 * delta * np.asarray(R, float)),
        Pb=t(2.0 * np.asarray(P, float)),
        Tb=t(2.0 * float(T) * LAM.T @ LAM),
        LAM=t(LAM), PSI=t(PSI_),
        F_x=t(cs.F_x), h_x=t(cs.h_x), F_u=t(cs.F_u), h_u=t(cs.h_u),
        Fw_x=t(F_w_N[:, :n]), Fw_th=t(F_w_N[:, n:]), h_w=t(cs.h_w_N),
        N=int(N),
    )


def _riccati_factor(A, B, Qx, Ru, PN):
    """The quadratic backward sweep (once an IPM iteration): the value
    Hessian recursion depends only on (Qx, Ru, PN), shared by the theta
    columns, the predictor and the corrector. Returns stacks (K, Acl, W12,
    nSi, G) for _riccati_apply, with W12 = K'Ru + Acl'V B,
    nSi = -(Ru + B'V B)^-1 and G = [B'; Acl'].
    Qx (B, N, n, n), Ru (B, N, m, m), PN (B, n, n); A, B shared."""
    N = Qx.shape[1]
    V = PN
    out = [None] * N
    stages = list(zip(Qx.unbind(1), Ru.unbind(1)))
    for k in reversed(range(N)):
        Qk, Rk = stages[k]
        BtV = B.mT @ V
        S = Rk + BtV @ B
        if S.shape[-1] == 1:
            Si = 1.0 / S
            K = -(BtV @ A) * Si
        else:
            Si = _inv(S)
            K = -(Si @ (BtV @ A))
        Acl = A + B @ K
        KtR = K.mT @ Rk
        AtV = Acl.mT @ V
        V = Qk + KtR @ K + AtV @ Acl
        out[k] = (K, Acl, KtR + AtV @ B, -Si)
    K, Acl, W12, nSi = (torch.stack(a, 1) for a in zip(*out))
    return K, Acl, W12, nSi, torch.cat([B.mT.expand(Acl.shape[:2] + B.mT.shape), Acl.mT],
                                       dim=-2)


def _riccati_apply(factor, A, B, qx, ru, pN):
    """Linear backward sweep + forward rollout against a stored factor, for
    the columns of qx (B, N, n, k), ru (B, N, m, k), pN (B, n, k): the affine
    part of the classic sweep (kf = -Si (B'v + r), v1 = q + K'r + W12 kf +
    Acl'v), then x_{k+1} = Acl_k x_k + B kf_k from x_0 = 0 and
    u_k = K_k x_k + kf_k. Returns X (B, N+1, n, k), U (B, N, m, k)."""
    K, Acl, W12, nSi, G = factor
    N, m = K.shape[1], K.shape[2]
    scalar = nSi.shape[-1] == 1
    qK = qx + K.mT @ ru
    v = pN
    kfs = [None] * N
    stages = list(zip(*(a.unbind(1) for a in (G, ru, nSi, qK, W12))))
    for j in reversed(range(N)):
        Gj, rj, nSj, qKj, Wj = stages[j]
        Gv = Gj @ v                         # [B' v; Acl_k' v]
        t = Gv[:, :m] + rj
        kf = t * nSj if scalar else nSj @ t
        v = qKj + Wj @ kf + Gv[:, m:]
        kfs[j] = kf
    kfs = torch.stack(kfs, 1)
    x = torch.zeros_like(pN)
    X = [x]
    for Aj, bj in zip(Acl.unbind(1), (B @ kfs).unbind(1)):
        x = Aj @ x + bj
        X.append(x)
    X = torch.stack(X, 1)
    return X, K @ X[:, :N] + kfs


def _riccati_solve(A, B, Qx, qx, Ru, ru, PN, pN, factor):
    """Equality-constrained LQ with stage-varying weights and dx_0 = 0:
    min sum_k 1/2 x'Qx_k x + qx_k'x + 1/2 u'Ru_k u + ru_k'u
        + 1/2 x_N'PN x_N + pN'x_N,   x_{k+1} = A x_k + B u_k,
    for the columns of qx (B, N, n, k), ru (B, N, m, k), pN (B, n, k).
    Returns (X (B, N+1, n, k), U (B, N, m, k)): against `factor`
    (_riccati_factor's), or with factor=None each column through the
    associative-scan factorization (ops/riccati.lqr_parallel, O(log N)
    depth)."""
    if factor is not None:
        return _riccati_apply(factor, A, B, qx, ru, pN)
    x0 = torch.zeros_like(pN[..., 0])
    sols = [lqr_parallel(A, B, Qx, Ru, PN, x0, q=qx[..., i], r=ru[..., i], p=pN[..., i])
            for i in range(pN.shape[-1])]
    return torch.stack([s.X for s in sols], -1), torch.stack([s.U for s in sols], -1)


class SparseIPMSolution(NamedTuple):
    X: torch.Tensor              # (B, N+1, n)
    U: torch.Tensor              # (B, N, m)
    theta: torch.Tensor          # (B, nth)
    mu: torch.Tensor             # (B,)
    max_violation: torch.Tensor  # (B,)
    converged: torch.Tensor      # (B,) bool


def dtype_guards(dtype):
    """(tiny, d_cap, tol_eff, conv_tol) of the reference's stage IPMs:
    the slack floor, the cap on D = z/s, the converged-freeze threshold (f64:
    30 eps; f32 mu bottoms out near 1e-5 in the Riccati sweeps, so it freezes
    there) and the final grade (f32: 2e-4, the active-set-exact grade)."""
    f64 = dtype == torch.float64
    fi = torch.finfo(dtype)
    return (float(fi.tiny) * 1e8, 1e30 if f64 else 1e7,
            30.0 * float(fi.eps) if f64 else 1e-5, 1e-7 if f64 else 2e-4)


def schur_solve(S, rhs):
    """S^-1 rhs per lane for the theta Schur system, S (B, nth, nth): a
    division when nth = 1 (the MGCM's, what the LU of a 1 x 1 system
    computes, and nothing that reads the device), else solve_ex."""
    if S.shape[-1] == 1:
        return rhs / S[..., 0]
    return _solve(S, rhs[..., None])[..., 0]


def steplen(pairs, t_: float):
    """The largest step in (0, 1], times t_, that keeps every v + a dv >= 0,
    per lane: pairs of (v, dv) with the lanes leading; an empty group sets no
    limit."""
    v0 = pairs[0][0]
    a = torch.ones(v0.shape[0], dtype=v0.dtype, device=v0.device)
    for v, dv in pairs:
        v, dv = v.flatten(1), dv.flatten(1)
        if v.shape[1] == 0:
            continue
        neg = dv < 0
        r = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
        a = torch.minimum(a, t_ * r.amin(dim=1))
    return a


def lane_max(*gs):
    """max over each lane's entries of every array, -inf for none."""
    Bsz = gs[0].shape[0]
    parts = [g.flatten(1) for g in gs]
    parts = [p for p in parts if p.shape[1]]
    if not parts:
        return torch.full((Bsz,), -torch.inf, dtype=gs[0].dtype, device=gs[0].device)
    return torch.cat(parts, 1).amax(dim=1)


def solve_sparse(qp: StageQP, x0: torch.Tensor, iters: int = 25, tau: float = 0.995,
                 parallel: bool = False) -> SparseIPMSolution:
    """Mehrotra predictor-corrector on the stage form (module docstring), for
    the lanes of x0 (B, n), in the dtype and on the device of `qp`.

    parallel=True uses the associative-scan Riccati (O(log N) depth per KKT
    solve) — identical math. Float32 matrix products run in full precision
    (TF32 is off in the package), as the reference runs at HIGHEST."""
    N = qp.N
    A, Bm = qp.A, qp.B
    dtype, dev = A.dtype, A.device
    x0 = x0.to(dtype=dtype, device=dev)
    Bsz, n = x0.shape
    m = Bm.shape[1]
    nth = qp.LAM.shape[1]
    m_total = float(N * qp.h_x.shape[0] + N * qp.h_u.shape[0] + qp.h_w.shape[0])
    tiny, d_cap, tol_eff, conv_tol = dtype_guards(dtype)
    kw = dict(dtype=dtype, device=dev)

    # the initial iterate satisfies the dynamics (Newton directions are
    # homogeneous in them): the U = 0 rollout (ref:
    # DMS_tracking_LMPC_casadi.m:97-104)
    xs = [x0]
    for _ in range(N):
        xs.append(xs[-1] @ A.mT)
    X = torch.stack(xs, 1)
    U = torch.zeros(Bsz, N, m, **kw)
    th = torch.zeros(Bsz, nth, **kw)

    def ineq(X, U, th):
        gx = X[:, 1:] @ qp.F_x.mT - qp.h_x
        gu = U @ qp.F_u.mT - qp.h_u
        gw = X[:, N] @ qp.Fw_x.mT + th @ qp.Fw_th.mT - qp.h_w
        return gx, gu, gw

    gx0, gu0, gw0 = ineq(X, U, th)
    sx, su, sw = (torch.clamp(-g, min=1.0) for g in (gx0, gu0, gw0))
    zx, zu, zw = (torch.ones_like(s) for s in (sx, su, sw))

    # constant theta-block Hessian of the smooth cost
    Hth_cost = (qp.Tb + float(N) * (qp.LAM.mT @ qp.Qb @ qp.LAM + qp.PSI.mT @ qp.Rb @ qp.PSI)
                + qp.LAM.mT @ qp.Pb @ qp.LAM)
    CxL = -qp.Qb @ qp.LAM          # stage x-theta cross Hessian (k=0..N-1)
    CxN = -qp.Pb @ qp.LAM          # terminal x-theta
    CuL = -qp.Rb @ qp.PSI          # stage u-theta
    # the theta columns' right-hand sides (independent of the iterate):
    # column i puts CxL e_i on x_1..x_{N-1} and CuL e_i on every u
    qx_cols = torch.cat([torch.zeros(1, n, nth, **kw), CxL.expand(N - 1, n, nth)], 0)
    ru_cols = CuL.expand(N, m, nth)

    def smul(*a):
        return sum(lane_sum(x.flatten(1)) for x in a)

    def grads(X, U, th):
        ex = X - (th @ qp.LAM.mT)[:, None]
        eu = U - (th @ qp.PSI.mT)[:, None]
        gX = torch.cat([ex[:, :N] @ qp.Qb.mT, ex[:, N:] @ qp.Pb.mT], 1)
        gU = eu @ qp.Rb.mT
        gth = (th @ qp.Tb.mT - (ex[:, :N].sum(1) @ qp.Qb.mT) @ qp.LAM
               - (ex[:, N] @ qp.Pb.mT) @ qp.LAM - (eu.sum(1) @ qp.Rb.mT) @ qp.PSI)
        return gX, gU, gth

    def coupling_dot(CxN_eff, Xs, Us):
        """M_thw applied to primal directions Xs (B, N+1, n, k), Us (B, N, m, k)
        -> (B, nth, k)."""
        return ((CxL.mT @ Xs[:, 1:N]).sum(1) + CxN_eff.mT @ Xs[:, N]
                + (CuL.mT @ Us).sum(1))

    frozen = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    for _ in range(iters):
        gx, gu, gw = ineq(X, U, th)
        sx_s, su_s, sw_s = (torch.clamp(s, min=tiny) for s in (sx, su, sw))
        Dx = torch.clamp(zx / sx_s, max=d_cap)
        Du = torch.clamp(zu / su_s, max=d_cap)
        Dw = torch.clamp(zw / sw_s, max=d_cap)
        mu = smul(sx * zx, su * zu, sw * zw) / m_total

        gX, gU, gth = grads(X, U, th)
        # dual-feasibility residuals r = grad + F'z
        rX = gX.clone()
        rX[:, 1:] += zx @ qp.F_x
        rX[:, N] += zw @ qp.Fw_x
        rU = gU + zu @ qp.F_u
        rth = gth + zw @ qp.Fw_th
        rpx, rpu, rpw = gx + sx, gu + su, gw + sw

        # modified stage Hessians (the same for predictor and corrector)
        Qt = qp.Qb + (qp.F_x.mT * Dx[..., None, :]) @ qp.F_x     # x_1..x_N
        Rt = qp.Rb + (qp.F_u.mT * Du[..., None, :]) @ qp.F_u
        PT = (qp.Pb + qp.F_x.mT @ (Dx[:, N - 1, :, None] * qp.F_x)
              + qp.Fw_x.mT @ (Dw[..., None] * qp.Fw_x))
        # Riccati stage weights: x_0 is fixed (dx_0 = 0) -> a zero block;
        # x_k uses Qt[k-1] for k = 1..N-1; Qt[N-1] belongs to x_N, in PT
        Qr = torch.cat([torch.zeros(Bsz, 1, n, n, **kw), Qt[:, :N - 1]], 1)
        Hth_eff = Hth_cost + qp.Fw_th.mT @ (Dw[..., None] * qp.Fw_th)
        CxN_eff = CxN + qp.Fw_x.mT @ (Dw[..., None] * qp.Fw_th)
        factor = None if parallel else _riccati_factor(A, Bm, Qr, Rt, PT)

        def newton_rhs(rcx, rcu, rcw):
            ax = (Dx * rpx - rcx / sx_s) @ qp.F_x           # rows x_1..x_N
            au = (Du * rpu - rcu / su_s) @ qp.F_u
            tw = Dw * rpw - rcw / sw_s
            # Riccati-as-minimizer returns dw = -Mtilde^{-1} q, so pass q = +r
            q_full = rX[:, 1:] + ax
            qx_r = torch.cat([torch.zeros(Bsz, 1, n, **kw), q_full[:, :N - 1]], 1)
            pN_r = q_full[:, N - 1] + tw @ qp.Fw_x          # + the terminal-set part
            return (qx_r, rU + au, pN_r), tw @ qp.Fw_th

        def newton_finish(X0_, U0_, awth, cols, rcx, rcu, rcw):
            Xc, Uc = cols
            rhs_th = -(rth + awth) - coupling_dot(CxN_eff, X0_[..., None], U0_[..., None])[..., 0]
            dth = schur_solve(Smat, rhs_th)
            dXc, dUc = Xc[..., 0] * dth[:, 0, None, None], Uc[..., 0] * dth[:, 0, None, None]
            for i in range(1, nth):
                dXc = dXc + Xc[..., i] * dth[:, i, None, None]
                dUc = dUc + Uc[..., i] * dth[:, i, None, None]
            dX, dU = X0_ + dXc, U0_ + dUc
            dgx = dX[:, 1:] @ qp.F_x.mT
            dgu = dU @ qp.F_u.mT
            dgw = dX[:, N] @ qp.Fw_x.mT + dth @ qp.Fw_th.mT
            dzx = Dx * (rpx + dgx) - rcx / sx_s
            dzu = Du * (rpu + dgu) - rcu / su_s
            dzw = Dw * (rpw + dgw) - rcw / sw_s
            return dX, dU, dth, -rpx - dgx, -rpu - dgu, -rpw - dgw, dzx, dzu, dzw

        # predictor, with the theta coupling columns in the same sweep
        (qx_r, ru_r, pN_r), awth = newton_rhs(sx * zx, su * zu, sw * zw)
        Xs, Us = _riccati_solve(
            A, Bm, Qr, torch.cat([qx_cols.expand(Bsz, N, n, nth), qx_r[..., None]], -1),
            Rt, torch.cat([ru_cols.expand(Bsz, N, m, nth), ru_r[..., None]], -1),
            PT, torch.cat([CxN_eff, pN_r[..., None]], -1), factor)
        cols = (Xs[..., :nth], Us[..., :nth])
        Smat = Hth_eff + coupling_dot(CxN_eff, *cols)
        dXa, dUa, dtha, dsxa, dsua, dswa, dzxa, dzua, dzwa = newton_finish(
            Xs[..., nth], Us[..., nth], awth, cols, sx * zx, su * zu, sw * zw)
        ap = steplen([(sx, dsxa), (su, dsua), (sw, dswa)], 1.0)
        ad = steplen([(zx, dzxa), (zu, dzua), (zw, dzwa)], 1.0)
        apx, adx = ap[:, None, None], ad[:, None, None]
        mu_aff = (smul((sx + apx * dsxa) * (zx + adx * dzxa),
                       (su + apx * dsua) * (zu + adx * dzua))
                  + smul((sw + ap[:, None] * dswa) * (zw + ad[:, None] * dzwa))) / m_total
        sigma = (mu_aff / torch.clamp(mu, min=tiny)) ** 3
        smu = (sigma * mu)
        # corrector
        rcx = sx * zx + dsxa * dzxa - smu[:, None, None]
        rcu = su * zu + dsua * dzua - smu[:, None, None]
        rcw = sw * zw + dswa * dzwa - smu[:, None]
        (qx_r, ru_r, pN_r), awth = newton_rhs(rcx, rcu, rcw)
        X0_, U0_ = _riccati_solve(A, Bm, Qr, qx_r[..., None], Rt, ru_r[..., None], PT,
                                  pN_r[..., None], factor)
        dX, dU, dth, dsx, dsu, dsw, dzx, dzu, dzw = newton_finish(
            X0_[..., 0], U0_[..., 0], awth, cols, rcx, rcu, rcw)
        ap = steplen([(sx, dsx), (su, dsu), (sw, dsw)], tau)
        ad = steplen([(zx, dzx), (zu, dzu), (zw, dzw)], tau)
        # freeze once converged (ops/ipm.py): keeps mu from driving s, z into
        # denormals; the freeze takes effect one iteration late, as in the
        # reference (keep tests the old flag)
        viol = lane_max(gx, gu, gw)
        done = (mu < tol_eff) & (viol < tol_eff)

        def keep(new, old):
            return torch.where(frozen.view((-1,) + (1,) * (new.ndim - 1)), old, new)

        def step(v, a, dv):
            return keep(v + a.view((-1,) + (1,) * (v.ndim - 1)) * dv, v)

        X, U, th = step(X, ap, dX), step(U, ap, dU), step(th, ap, dth)
        sx, su, sw = step(sx, ap, dsx), step(su, ap, dsu), step(sw, ap, dsw)
        zx, zu, zw = step(zx, ad, dzx), step(zu, ad, dzu), step(zw, ad, dzw)
        frozen = frozen | done

    mu = smul(sx * zx, su * zu, sw * zw) / m_total
    viol = lane_max(*ineq(X, U, th))
    return SparseIPMSolution(X=X, U=U, theta=th, mu=mu, max_violation=viol,
                             converged=(mu < conv_tol) & (viol < conv_tol))



def peak_bytes(lanes: int, N: int, n: int, m: int, nth: int, rows: tuple,
               itemsize: int, parallel: bool = True) -> int:
    """A model, from the shapes, of the peak bytes solve_sparse holds for
    `lanes` lanes: with parallel=True the associative scan's
    (ops/riccati.scan_peak_bytes) beside the IPM's own arrays, counted as at
    most 16 arrays of each stage constraint group (mx, mu rows a stage),
    12 stage vectors of n, 4 stage blocks of n x n and 2 of m x m, and the
    terminal group's (mw rows) 16 vectors and its n + nth row products. An
    upper bound: the live tensors of a float64 DMS_LMPC solve on the CPU (at
    N = 20 and 50, 8 and 32 lanes) peaked at 69-70 % of the scan's term
    alone, 66-69 % of the whole with parallel=True and 87-92 % without."""
    mx, mu, mw = rows
    ipm = N * (16 * (mx + mu) + 12 * n + 4 * n * n + 2 * m * m) + mw * (16 + n + nth)
    scan = scan_peak_bytes(lanes, N, n, m, itemsize) if parallel else 0
    return scan + lanes * itemsize * ipm
