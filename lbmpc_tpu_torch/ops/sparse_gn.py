"""Stage-form (sparse Riccati) LBMPC SQP subproblems for long horizons,
batched over lanes.

Port of lbmpc_tpu/ops/sparse_gn.py. The condensed LBMPC SQP
(controllers/lbmpc.py + ops/ipm.py) builds O(N^2) prediction matrices; the
stage form keeps the stage variables and factors every IPM Newton system
with a Riccati sweep (the lifted DMS NLP of examples/DMS_LBMPC_casadi.m:
122-130, y = [xl(0..N); x(0..N); u; theta]).

The LBMPC structure is dual-trajectory (ref: DMS_LBMPC_casadi.m:252-315):
the LEARNED trajectory xl drives the Gauss-Newton cost, the NOMINAL
trajectory x drives the safety constraints. Both depend on the same
controls, so the stage variable is w_k = [dxl_k; dx_k] in R^{2n} with
block-diagonal stage-varying dynamics

  dxl_{k+1} = Al_k dxl_k + Bl_k dc_k   (linearized learned model; the oracle
                                        Jacobian Jg_k varies by stage)
  dx_{k+1}  = An  dx_k  + B   dc_k     (nominal, An = A + B Ks; Ks = 0 for
                                        the casadi family)

and the QP solved here is the exact GN subproblem of the condensed SQP —
step d in z = [c_0..c_{N-1}; theta], min 1/2 d'H d + g'd s.t. G(z+d) <= h —
without materializing H or G: every Mehrotra Newton system runs cross-term
Riccati sweeps, with theta eliminated by a Schur complement (the pattern of
ops/sparse_ipm.py, with stage-varying dynamics and the prestabilizer's x-u
cross weights). One quadratic factor an IPM iteration serves every
right-hand side; the theta columns and the predictor sweep against it as
the columns of one matrix, the corrector after them.

Constraint groups (masks encode both reference families — see make_stage_gn):
  gx: F_x dx_k <= hx_k,  k = 1..N       (state rows; fmincon masks out k=N)
  gu: F_u (Ks dx_k + dc_k) <= hu_k      (input rows)
  gd: F_x_d rows on dx_1                (tightened first step; may be empty)
  gw: F_wN [dx_kT; theta] rows          (terminal set at stage kT)

Lanes lead every per-problem array; every reduction of one problem (mu,
mu_aff, the step lengths, the violation, the freeze, sigma) stays in its
lane.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.ops.lanes import lane_sum
from lbmpc_tpu_torch.ops.riccati import _inv
from lbmpc_tpu_torch.ops.sparse_ipm import dtype_guards, lane_max, schur_solve, steplen


class StageGNQP(NamedTuple):
    """Static data of the stage-form GN subproblem (tensors, no lane axis)."""

    A: torch.Tensor        # (n, n) nominal
    B: torch.Tensor        # (n, m)
    Ks: torch.Tensor       # (m, n) prestabilizer (zeros for casadi family)
    Qb: torch.Tensor       # (n, n) 2*w*Q  (w = 1 fmincon, delta casadi)
    Rb: torch.Tensor       # (m, m) 2*w*R
    Pb: torch.Tensor       # (n, n) 2*P
    TLL: torch.Tensor      # (nth, nth) 2*T*LAM'LAM
    LAM: torch.Tensor      # (n, nth)
    PSI: torch.Tensor      # (m, nth)
    cost_mask: torch.Tensor   # (N,) 1.0 where the running stage cost applies
    srow_mask: torch.Tensor   # (N,) 1.0 where state rows apply to x_{k+1}
    urow_mask: torch.Tensor   # (N,) 1.0 where input rows apply to u_k
    F_x: torch.Tensor
    h_x: torch.Tensor
    F_u: torch.Tensor
    h_u: torch.Tensor
    F_d: torch.Tensor      # tightened rows at x_1 ((0, n) if unused)
    h_d: torch.Tensor
    Fw_x: torch.Tensor
    Fw_th: torch.Tensor
    h_w: torch.Tensor
    N: int
    kT: int                # terminal-set stage (on x_kT)


def make_stage_gn(A, B, Ks, Q, R, P, T, LAMBDA, PSI, cs, N, delta,
                  family="fmincon", terminal_at="first",
                  tighten_first_step=True, dtype=torch.float64,
                  device=None) -> StageGNQP:
    """Stage data matching build_fmincon_lmpc / build_casadi_dms semantics
    (controllers/condensed.py), with the reference quirks: fmincon runs cost
    stages 0..N-3, state rows x_1..x_{N-1}, input rows u_0..u_{N-2},
    terminal at x_{N-1} ('last') or x_1 ('first'); casadi runs the
    delta-scaled cost on all stages, state rows x_1..x_N, input rows all,
    terminal at x_1 or x_N. Host numpy in, `dtype` tensors on `device`
    (CUDA unless named) out."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    n, m = B.shape
    Ks_ = (np.atleast_2d(np.asarray(Ks, float)) if family == "fmincon"
           else np.zeros((m, n)))
    LAM = np.atleast_2d(np.asarray(LAMBDA, float))
    PSI_ = np.atleast_2d(np.asarray(PSI, float))
    wgt = 1.0 if family == "fmincon" else float(delta)
    cost_mask = np.zeros(N)
    srow_mask = np.zeros(N)
    urow_mask = np.zeros(N)
    if family == "fmincon":
        cost_mask[: max(N - 2, 0)] = 1.0
        srow_mask[: N - 1] = 1.0       # x_1..x_{N-1}
        urow_mask[: N - 1] = 1.0       # u_0..u_{N-2}
        kT = 1 if terminal_at == "first" else N - 1
    else:
        cost_mask[:] = 1.0
        srow_mask[:] = 1.0             # x_1..x_N
        urow_mask[:] = 1.0
        kT = 1 if terminal_at == "first" else N
    use_d = tighten_first_step and getattr(cs, "F_x_d", None) is not None
    F_d = np.asarray(cs.F_x_d, float) if use_d else np.zeros((0, n))
    h_d = np.asarray(cs.h_x_d, float) if use_d else np.zeros((0,))
    F_w_N = np.asarray(cs.F_w_N, float)
    return StageGNQP(
        A=t(A), B=t(B), Ks=t(Ks_),
        Qb=t(2.0 * wgt * np.asarray(Q, float)),
        Rb=t(2.0 * wgt * np.asarray(R, float)),
        Pb=t(2.0 * np.asarray(P, float)),
        TLL=t(2.0 * float(T) * LAM.T @ LAM),
        LAM=t(LAM), PSI=t(PSI_),
        cost_mask=t(cost_mask), srow_mask=t(srow_mask), urow_mask=t(urow_mask),
        F_x=t(cs.F_x), h_x=t(cs.h_x), F_u=t(cs.F_u), h_u=t(cs.h_u),
        F_d=t(F_d), h_d=t(h_d),
        Fw_x=t(F_w_N[:, :n]), Fw_th=t(F_w_N[:, n:]), h_w=t(cs.h_w_N),
        N=int(N), kT=int(kT),
    )


def _riccati_factor(As, Bs, Qs, Ss, Rs, PN):
    """The quadratic backward sweep, once an IPM iteration: the value
    Hessian recursion depends only on (A, B, Q, S, R, PN), shared by the
    predictor, the corrector and every theta coupling column. Stage arrays
    (B, N, ., .), PN (B, nw, nw). Returns the stacks _riccati_solve reads:
      Kg  (B, N, m, nw)       feedback gains
      Acl (B, N, nw, nw)      closed-loop dynamics
      W12 (B, N, nw, m)       S + K'R + Acl'V B   (linear-pass coupling)
      nSwi (B, N, m, m)       -(R + B'V B)^-1
      G   (B, N, m + nw, nw)  [B'; Acl'], the carry's two products in one
    """
    N = As.shape[1]
    V = PN
    out = [None] * N
    stages = list(zip(*(a.unbind(1) for a in (As, Bs, Qs, Ss, Rs))))
    for k in reversed(range(N)):
        Ak, Bk, Qk, Sk, Rk = stages[k]
        BtV = Bk.mT @ V
        Sw = Rk + BtV @ Bk
        M = Sk.mT + BtV @ Ak
        if Sw.shape[-1] == 1:
            Swi = 1.0 / Sw
            K = -M * Swi
        else:
            Swi = _inv(Sw)
            K = -Swi @ M
        Acl = Ak + Bk @ K
        KtR = K.mT @ Rk
        SK = Sk @ K
        AtV = Acl.mT @ V
        # V_k = Q + K'RK + K'S' + SK + Acl'V Acl   (K'S' = (SK)')
        V = Qk + KtR @ K + SK.mT + SK + AtV @ Acl
        out[k] = (K, Acl, Sk + KtR + AtV @ Bk, -Swi)
    Kg, Acl, W12, nSwi = (torch.stack(a, 1) for a in zip(*out))
    return Kg, Acl, W12, nSwi, torch.cat([Bs.mT, Acl.mT], dim=-2)


def _riccati_solve(factor, As, Bs, qs, rs, pN):
    """Linear backward sweep + forward rollout against a stored factor, for
    the columns of qs (B, N, nw, k), rs (B, N, m, k), pN (B, nw, k): with
    v_{k+1} the carry,
      kf_k = -Swi_k (B_k' v_{k+1} + r_k)
      v_k  = q_k + K_k' r_k + W12_k kf_k + Acl_k' v_{k+1}
    then the rollout w_{k+1} = Acl_k w_k + B_k kf_k from w_0 = 0 and
    c_k = K_k w_k + kf_k. Returns (W (B, N+1, nw, k), C (B, N, m, k))."""
    Kg, Acl, W12, nSwi, G = factor
    N = Kg.shape[1]
    m = Kg.shape[2]
    scalar = nSwi.shape[-1] == 1
    qK = qs + Kg.mT @ rs                    # q_k + K_k' r_k, every stage at once
    v = pN
    kfs = [None] * N
    stages = list(zip(*(a.unbind(1) for a in (G, rs, nSwi, qK, W12))))
    for j in reversed(range(N)):
        Gj, rj, nSj, qKj, Wj = stages[j]
        Gv = Gj @ v                         # [B_k' v; Acl_k' v]
        t = Gv[:, :m] + rj
        kf = t * nSj if scalar else nSj @ t
        v = qKj + Wj @ kf + Gv[:, m:]
        kfs[j] = kf
    kfs = torch.stack(kfs, 1)
    w = torch.zeros_like(pN)
    W = [w]
    for Aj, bj in zip(Acl.unbind(1), (Bs @ kfs).unbind(1)):
        w = Aj @ w + bj
        W.append(w)
    W = torch.stack(W, 1)
    return W, Kg @ W[:, :N] + kfs


def _riccati_cross(As, Bs, Qs, Ss, Rs, qs, rs, PN, pN):
    """LQ with stage-varying dynamics, x-u cross terms and w_0 = 0, one
    right-hand side, by the single-device sweeps:

      min sum_k 1/2 w_k'Q_k w_k + w_k'S_k c_k + 1/2 c_k'R_k c_k
              + q_k'w_k + r_k'c_k  +  1/2 w_N'PN w_N + pN'w_N
      s.t. w_{k+1} = A_k w_k + B_k c_k,  w_0 = 0.

    Lanes lead: stage arrays (B, N, ., .), qs (B, N, nw), rs (B, N, m), PN
    (B, nw, nw), pN (B, nw). Returns (W (B, N+1, nw), C (B, N, m)): the
    factor/solve split in one call, the sweep ops/riccati_sharded's split
    one is held to (the reference's lbmpc_tpu/ops/sparse_gn.py:199)."""
    factor = _riccati_factor(As, Bs, Qs, Ss, Rs, PN)
    W, C = _riccati_solve(factor, As, Bs, qs[..., None], rs[..., None], pN[..., None])
    return W[..., 0], C[..., 0]


class SparseGNSolution(NamedTuple):
    dC: torch.Tensor             # (B, N, m) control step
    dth: torch.Tensor            # (B, nth) theta step
    mu: torch.Tensor             # (B,)
    max_violation: torch.Tensor  # (B,)
    converged: torch.Tensor      # (B,) bool


def solve_sparse_gn(qp: StageGNQP, Als, Bls, q_xl, r_c, g_th,
                    hx_t, hu_t, hd_t, hw_t,
                    iters: int = 25, tau: float = 0.995, mesh=None) -> SparseGNSolution:
    """Solve the GN subproblem of every lane in step variables d = (dC stages,
    dtheta), in the dtype and on the device of `qp`.

    Inputs from the SQP wrapper (in delta/step space around z_bar, lanes
    leading):
      Als, Bls   (B, N, n, n), (B, N, n, m): linearized learned stage dynamics
      q_xl       (B, N+1, n): GN linear term on dxl_k (= 2 J' e stage rows)
      r_c        (B, N, m):   GN linear term on dc_k
      g_th       (B, nth):    GN linear term on dtheta
      hx_t (B, N, mx), hu_t (B, N, mu), hd_t (B, md), hw_t (B, mw): per-group
        rhs h - F(rollout at z_bar), the slack the current iterate leaves.

    mesh: a 'stage' mesh (ops/riccati_sharded.stage_mesh): the Riccati
    sweeps then run stage-sharded over its shards (lqr_cross_sharded), the
    theta columns and the predictor in one multi-RHS sweep, the corrector in
    a second, as the reference's (lbmpc_tpu/ops/sparse_gn.py:355-372); each
    sweep redoes the quadratic part. Float32 matrix products run in full
    precision (TF32 is off in the package), as the reference runs at
    HIGHEST."""
    if mesh is not None and getattr(mesh, "axis", None) != "stage":
        raise ValueError("solve_sparse_gn(mesh=...) takes a 'stage' mesh "
                         "(ops/riccati_sharded.stage_mesh)")
    N, kT = qp.N, qp.kT
    dtype, dev = qp.A.dtype, qp.A.device
    cast = lambda a: a.to(dtype=dtype, device=dev)
    Als, Bls, q_xl, r_c, g_th = map(cast, (Als, Bls, q_xl, r_c, g_th))
    hx_t, hu_t, hd_t, hw_t = map(cast, (hx_t, hu_t, hd_t, hw_t))
    Bsz = Als.shape[0]
    n = qp.A.shape[0]
    m = qp.B.shape[1]
    nth = qp.LAM.shape[1]
    nw = 2 * n
    kw = dict(dtype=dtype, device=dev)
    mx, mu_r = qp.h_x.shape[0], qp.h_u.shape[0]
    md, mw = qp.h_d.shape[0], qp.h_w.shape[0]
    msk_x = qp.srow_mask[:, None]            # (N, 1) over x_1..x_N
    msk_u = qp.urow_mask[:, None]
    m_total = (float(mx) * qp.srow_mask.sum() + float(mu_r) * qp.urow_mask.sum()
               + float(md + mw))
    tiny, d_cap, tol_eff, conv_tol = dtype_guards(dtype)

    An = qp.A + qp.B @ qp.Ks
    As = torch.zeros(Bsz, N, nw, nw, **kw)
    As[..., :n, :n] = Als
    As[..., n:, n:] = An
    Bs = torch.zeros(Bsz, N, nw, m, **kw)
    Bs[..., :n, :] = Bls
    Bs[..., n:, :] = qp.B

    KsR = qp.Ks.mT @ qp.Rb                    # (n, m)
    Qeff = qp.Qb + KsR @ qp.Ks                # learned-block stage Hessian
    cm = qp.cost_mask[:, None]                # (N, 1)
    cm3 = qp.cost_mask[:, None, None]
    # cost theta-couplings
    CwL = -(qp.Qb @ qp.LAM + KsR @ qp.PSI)    # (n, nth) learned block
    CcL = -qp.Rb @ qp.PSI                     # (m, nth)
    CwN = -qp.Pb @ qp.LAM
    n_cost = qp.cost_mask.sum()
    Hth_cost = (qp.TLL + n_cost * (qp.LAM.mT @ qp.Qb @ qp.LAM + qp.PSI.mT @ qp.Rb @ qp.PSI)
                + qp.LAM.mT @ qp.Pb @ qp.LAM)
    I_m = torch.eye(m, **kw)
    # the theta columns' cost right-hand sides (the barrier part is added per
    # iteration)
    qw_cols = torch.zeros(N, nw, nth, **kw)
    qw_cols[:, :n] = cm3 * CwL
    rc_cols = cm3 * CcL                       # CcL at the cost stages only
    pN_cols = torch.zeros(nw, nth, **kw)
    pN_cols[:n] = CwN

    W = torch.zeros(Bsz, N + 1, nw, **kw)
    C = torch.zeros(Bsz, N, m, **kw)
    th = torch.zeros(Bsz, nth, **kw)

    def ineq(W, C, th):
        dx = W[:, 1:, n:]                                  # x_1..x_N
        gx = dx @ qp.F_x.mT - hx_t
        du = C + W[:, :N, n:] @ qp.Ks.mT
        gu = du @ qp.F_u.mT - hu_t
        gd = W[:, 1, n:] @ qp.F_d.mT - hd_t
        gw = W[:, kT, n:] @ qp.Fw_x.mT + th @ qp.Fw_th.mT - hw_t
        return gx, gu, gd, gw

    gx0, gu0, gd0, gw0 = ineq(W, C, th)
    sx, su, sd, sw = (torch.clamp(-g, min=1.0) for g in (gx0, gu0, gd0, gw0))
    zx, zu, zd, zw = (torch.ones_like(s) for s in (sx, su, sd, sw))

    def lsum(a):
        return lane_sum(a.flatten(1))

    def coupling_cost(Ws, Cs):
        """The cost-only theta coupling of primal arrays Ws (..., N+1, nw),
        Cs (..., N, m) -> (..., nth)."""
        acc = ((Ws[..., :N, :n] * cm) @ CwL).sum(-2)
        acc = acc + Ws[..., N, :n] @ CwN
        return acc + ((Cs * cm) @ CcL).sum(-2)

    frozen = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    for _ in range(iters):
        gx, gu, gd, gw = ineq(W, C, th)
        sx_s, su_s, sd_s, sw_s = (torch.clamp(s, min=tiny) for s in (sx, su, sd, sw))
        Dx = torch.clamp(zx / sx_s, max=d_cap) * msk_x
        Du = torch.clamp(zu / su_s, max=d_cap) * msk_u
        Dd = torch.clamp(zd / sd_s, max=d_cap)
        Dw = torch.clamp(zw / sw_s, max=d_cap)
        mu = (lsum(sx * zx * msk_x) + lsum(su * zu * msk_u) + lsum(sd * zd)
              + lsum(sw * zw)) / m_total

        # ---- stage Hessian blocks: cost + barrier D-terms ----
        Qs = torch.zeros(Bsz, N, nw, nw, **kw)
        Qs[..., :n, :n] += cm3 * Qeff
        # state rows for x_k live on stage k (k = 1..N-1); x_N rows -> PN
        FxD = (qp.F_x.mT * Dx[:, :N - 1, None, :]) @ qp.F_x
        Qs[:, 1:, n:, n:] += FxD
        FuD = (qp.F_u.mT * Du[..., None, :]) @ qp.F_u              # (B, N, m, m)
        Qs[..., n:, n:] += qp.Ks.mT @ FuD @ qp.Ks
        Qs[:, 1, n:, n:] += qp.F_d.mT @ (Dd[..., None] * qp.F_d)
        TwD = qp.Fw_x.mT @ (Dw[..., None] * qp.Fw_x)                # (B, n, n)
        if kT < N:
            Qs[:, kT, n:, n:] += TwD
        Ss = torch.zeros(Bsz, N, nw, m, **kw)
        Ss[..., :n, :] += cm3 * KsR
        Ss[..., n:, :] += qp.Ks.mT @ FuD
        Rs = cm3 * qp.Rb + FuD + 1e-9 * I_m
        PN = torch.zeros(Bsz, nw, nw, **kw)
        PN[:, :n, :n] = qp.Pb
        if kT == N:
            PN[:, n:, n:] += TwD
        # x_N state rows (casadi family; the mask makes this a no-op for fmincon)
        PN[:, n:, n:] += qp.F_x.mT @ (Dx[:, N - 1, :, None] * qp.F_x)

        Hth_eff = Hth_cost + qp.Fw_th.mT @ (Dw[..., None] * qp.Fw_th)
        CwT_eff = qp.Fw_x.mT @ (Dw[..., None] * qp.Fw_th)         # (B, n, nth) on dx_kT

        # ONE quadratic backward sweep an iteration; the nth + 2 right-hand
        # sides (theta columns, predictor, corrector) reuse its factor. On a
        # mesh the sweeps run stage-sharded instead (ops/riccati_sharded)
        if mesh is None:
            factor = _riccati_factor(As, Bs, Qs, Ss, Rs, PN)

        def rsolve(qs, rs, pNs):
            if mesh is None:
                return _riccati_solve(factor, As, Bs, qs, rs, pNs)
            from lbmpc_tpu_torch.ops.riccati_sharded import lqr_cross_sharded

            return lqr_cross_sharded(mesh, As, Bs, Qs, Ss, Rs, qs, rs, PN, pNs)

        def coupling_step(Ws, Cs):
            """The theta row of the augmented system (cost + barrier
            couplings) applied to primal directions (B, k, N+1, nw),
            (B, k, N, m) -> (B, k, nth)."""
            return coupling_cost(Ws, Cs) + Ws[:, :, kT, n:] @ CwT_eff

        # ---- theta coupling columns (shared by predictor + corrector) ----
        qw_th = qw_cols.expand(Bsz, N, nw, nth).clone()
        pN_th = pN_cols.expand(Bsz, nw, nth).clone()
        if kT < N:
            qw_th[:, kT, n:] += CwT_eff
        else:
            pN_th[:, n:] += CwT_eff

        # ---- dual-feasibility residuals at the current iterate ----
        # cost-only Hessian products (the D-terms act on the step; their
        # iterate forces are the F'z dual terms)
        zx_m = zx * msk_x
        zu_m = zu * msk_u
        wl = W[:, :N, :n]
        gW = torch.zeros(Bsz, N, nw, **kw)
        gW[..., :n] += cm * (wl @ Qeff.mT + C @ KsR.mT + (th @ CwL.mT)[:, None]) + q_xl[:, :N]
        gW[:, 1:, n:] += zx_m[:, :N - 1] @ qp.F_x
        gW[..., n:] += (zu_m @ qp.F_u) @ qp.Ks
        gW[:, 1, n:] += zd @ qp.F_d
        gC = cm * (wl @ KsR + C @ qp.Rb.mT + (th @ CcL.mT)[:, None]) + r_c + zu_m @ qp.F_u
        gWN = torch.zeros(Bsz, nw, **kw)
        gWN[:, :n] += W[:, N, :n] @ qp.Pb.mT + th @ CwN.mT + q_xl[:, N]
        gWN[:, n:] += zx_m[:, N - 1] @ qp.F_x
        tw = zw @ qp.Fw_x
        if kT < N:
            gW[:, kT, n:] += tw
        else:
            gWN[:, n:] += tw
        rth = th @ Hth_cost.mT + g_th + coupling_cost(W, C) + zw @ qp.Fw_th

        def newton_rhs(rcx, rcu, rcd, rcw):
            elim_x = (Dx * (gx + sx) - rcx / sx_s) * msk_x
            elim_u = (Du * (gu + su) - rcu / su_s) * msk_u
            elim_d = Dd * (gd + sd) - rcd / sd_s
            elim_w = Dw * (gw + sw) - rcw / sw_s
            ax = elim_x @ qp.F_x                # (B, N, n) rows for x_1..x_N
            au_c = elim_u @ qp.F_u              # (B, N, m)
            qw = gW.clone()
            qw[:, 1:, n:] += ax[:, :N - 1]
            qw[..., n:] += au_c @ qp.Ks
            qw[:, 1, n:] += elim_d @ qp.F_d
            pN_r = gWN.clone()
            pN_r[:, n:] += ax[:, N - 1]
            awx = elim_w @ qp.Fw_x
            if kT < N:
                qw[:, kT, n:] += awx
            else:
                pN_r[:, n:] += awx
            return (qw, gC + au_c, pN_r), elim_w @ qp.Fw_th

        def newton_finish(W0, C0, awth, cols, rcx, rcu, rcd, rcw):
            Wc, Cc = cols                                   # (B, nth, N+1, nw), ...
            rhs_th = -(rth + awth) - coupling_step(W0[:, None], C0[:, None])[:, 0]
            dth = schur_solve(Smat, rhs_th)
            dWc, dCc = dth[:, 0, None, None] * Wc[:, 0], dth[:, 0, None, None] * Cc[:, 0]
            for i in range(1, nth):
                dWc = dWc + dth[:, i, None, None] * Wc[:, i]
                dCc = dCc + dth[:, i, None, None] * Cc[:, i]
            dW, dC = W0 + dWc, C0 + dCc
            dgx = dW[:, 1:, n:] @ qp.F_x.mT
            dgu = (dC + dW[:, :N, n:] @ qp.Ks.mT) @ qp.F_u.mT
            dgd = dW[:, 1, n:] @ qp.F_d.mT
            dgw = dW[:, kT, n:] @ qp.Fw_x.mT + dth @ qp.Fw_th.mT
            dzx = (Dx * ((gx + sx) + dgx) - rcx / sx_s) * msk_x
            dzu = (Du * ((gu + su) + dgu) - rcu / su_s) * msk_u
            dzd = Dd * ((gd + sd) + dgd) - rcd / sd_s
            dzw = Dw * ((gw + sw) + dgw) - rcw / sw_s
            dsx = (-(gx + sx) - dgx) * msk_x
            dsu = (-(gu + su) - dgu) * msk_u
            dsd = -(gd + sd) - dgd
            dsw = -(gw + sw) - dgw
            return dW, dC, dth, dsx, dsu, dsd, dsw, dzx, dzu, dzd, dzw

        # predictor, swept with the theta columns
        (qw, rc, pN_r), awth = newton_rhs(sx * zx, su * zu, sd * zd, sw * zw)
        Wk, Ck = rsolve(
            torch.cat([qw_th, qw[..., None]], -1),
            torch.cat([rc_cols.expand(Bsz, N, m, nth), rc[..., None]], -1),
            torch.cat([pN_th, pN_r[..., None]], -1))
        Wk, Ck = Wk.movedim(-1, 1), Ck.movedim(-1, 1)       # (B, nth+1, N+1, nw), ...
        cols = (Wk[:, :nth], Ck[:, :nth])
        Smat = Hth_eff + coupling_step(*cols).mT
        pred = newton_finish(Wk[:, nth], Ck[:, nth], awth, cols,
                             sx * zx, su * zu, sd * zd, sw * zw)
        dsxa, dsua, dsda, dswa = pred[3:7]
        dzxa, dzua, dzda, dzwa = pred[7:11]
        ap = steplen([(sx, dsxa), (su, dsua), (sd, dsda), (sw, dswa)], 1.0)
        ad_ = steplen([(zx, dzxa), (zu, dzua), (zd, dzda), (zw, dzwa)], 1.0)
        ap3, ad3, ap2, ad2 = ap[:, None, None], ad_[:, None, None], ap[:, None], ad_[:, None]
        mu_aff = (lsum((sx + ap3 * dsxa) * (zx + ad3 * dzxa) * msk_x)
                  + lsum((su + ap3 * dsua) * (zu + ad3 * dzua) * msk_u)
                  + lsum((sd + ap2 * dsda) * (zd + ad2 * dzda))
                  + lsum((sw + ap2 * dswa) * (zw + ad2 * dzwa))) / m_total
        sigma = (mu_aff / torch.clamp(mu, min=tiny)) ** 3
        smu3, smu2 = (sigma * mu)[:, None, None], (sigma * mu)[:, None]
        # corrector
        rcs = (sx * zx + dsxa * dzxa - smu3, su * zu + dsua * dzua - smu3,
               sd * zd + dsda * dzda - smu2, sw * zw + dswa * dzwa - smu2)
        (qw, rc, pN_r), awth = newton_rhs(*rcs)
        W0, C0 = rsolve(qw[..., None], rc[..., None], pN_r[..., None])
        corr = newton_finish(W0[..., 0], C0[..., 0], awth, cols, *rcs)
        dW, dC, dth = corr[0], corr[1], corr[2]
        dsx, dsu, dsd, dsw = corr[3:7]
        dzx, dzu, dzd, dzw = corr[7:11]
        ap = steplen([(sx, dsx), (su, dsu), (sd, dsd), (sw, dsw)], tau)
        ad_ = steplen([(zx, dzx), (zu, dzu), (zd, dzd), (zw, dzw)], tau)
        viol = lane_max(gx * msk_x, gu * msk_u, gd, gw)
        done = (mu < tol_eff) & (viol < tol_eff)

        # the freeze takes effect one iteration late, as in the reference
        # (keep tests the old flag)
        def step(v, a, dv):
            shape = (-1,) + (1,) * (v.ndim - 1)
            return torch.where(frozen.view(shape), v, v + a.view(shape) * dv)

        W, C, th = step(W, ap, dW), step(C, ap, dC), step(th, ap, dth)
        sx, su, sd, sw = (step(v, ap, d) for v, d in ((sx, dsx), (su, dsu), (sd, dsd),
                                                       (sw, dsw)))
        zx, zu, zd, zw = (step(v, ad_, d) for v, d in ((zx, dzx), (zu, dzu), (zd, dzd),
                                                        (zw, dzw)))
        frozen = frozen | done

    mu = (lsum(sx * zx * msk_x) + lsum(su * zu * msk_u) + lsum(sd * zd)
          + lsum(sw * zw)) / m_total
    gx, gu, gd, gw = ineq(W, C, th)
    viol = lane_max(gx * msk_x, gu * msk_u, gd, gw)
    return SparseGNSolution(dC=C, dth=th, mu=mu, max_violation=viol,
                            converged=(mu < conv_tol) & (viol < conv_tol))
