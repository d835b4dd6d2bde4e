"""Learning-based MPC: learned-model cost + nominal-model constraints.

The core LBMPC split (ref: functions/costLBMPC.m:27 vs constraintsLBMPC.m:23):
performance is optimized against the oracle-corrected model while safety
constraints are enforced on the nominal model. In condensed form the nominal
constraints are the constant (G, h0, Hp) stack of the condensed QP; only the
cost rolls out the learned dynamics, as the Gauss-Newton residual stack built
here (batched over lanes). make_lbmpc_solver runs the per-problem SQP
(controllers/sqp.py) on it — the vmapped solver of the reference, with the
lanes on the leading axis — and make_casadi_warm_start is the casadi
family's shift-and-append warm start.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbmpc_tpu_torch.controllers.condensed import CondensedQP
from lbmpc_tpu_torch.controllers.sqp import _ALPHAS, sqp_solve
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.ops.lanes import exact_sum, lane_left, lane_mm, lane_sum, on_min_lanes
from lbmpc_tpu_torch.oracle import (DataWindow, make_xi, nw_estimate,
                                    nw_estimate_and_jac)


@dataclasses.dataclass(frozen=True)
class LBMPCWeights:
    """Square-root weights for the Gauss-Newton residual stack."""

    Lq: np.ndarray
    Lr: np.ndarray
    Lp: np.ndarray
    sqrtT: float
    LAMBDA: np.ndarray
    PSI: np.ndarray

    @classmethod
    def make(cls, Q, R, P, T, LAMBDA, PSI):
        return cls(
            Lq=np.linalg.cholesky(np.asarray(Q, float)).T,
            Lr=np.linalg.cholesky(np.asarray(R, float)).T,
            Lp=np.linalg.cholesky(np.asarray(P, float)).T,
            sqrtT=float(np.sqrt(T)),
            LAMBDA=np.atleast_2d(np.asarray(LAMBDA, float)),
            PSI=np.atleast_2d(np.asarray(PSI, float)),
        )


def residual_rows(N: int, n: int, m: int, family: str = "fmincon") -> int:
    """Rows of the residual stack: rx, ru over the running stages (fmincon:
    0..N-3, the costLBMPC.m quirk; casadi: all N), then rP (n), rT (n)."""
    n_run = N - 2 if family == "fmincon" else N
    return n_run * (n + m) + 2 * n


def make_residual_and_jac(
    qp: CondensedQP,
    A: np.ndarray,
    B: np.ndarray,
    Ks: np.ndarray,
    w: LBMPCWeights,
    family: str = "fmincon",
    delta: float = 0.01,
    bandwidth: float = 0.5,
    ridge: float = 0.001,
    dx_ref: np.ndarray | None = None,
    dtype=torch.float64,
    device=None,
):
    """Gauss-Newton residual stack and its hand-derived Jacobian, batched.

    The residual is linear in the learned-rollout trajectory, so its Jacobian
    follows from sensitivity propagation S_{k+1} = A S_k + B du/dz
    + Jg dxi/dz with the oracle Jacobian Jg in closed form
    (oracle.nw_estimate_and_jac). Returns

      residual(z (B, nz), dx0 (B, n), window) -> e (B, ne)
      res_jac(z, dx0, window) -> (e (B, ne), J (B, ne, nz))

    with the window batched over the same B lanes. family='fmincon':
    u_k = Ks x_k + c_k and running stages 0..N-3 (costLBMPC.m quirk);
    family='casadi': u_k = c_k and delta-scaled running stages 0..N-1.
    The products take ops/lanes' forms, so a lane's bits do not depend on
    the batch's size; on the card their short contractions are unfused
    (fused=False), as K1w and K3w compute them (this is their plain
    version, ops/gn_kernel.GNPhase.plain).
    """
    dev = resolve_device(device)
    N, n, m = qp.N, qp.n, qp.m
    mm = lambda v, M: lane_mm(v, M, fused=False)
    left = lambda M, S: lane_left(M, S, fused=False)
    fmincon = family == "fmincon"
    nth = np.atleast_2d(np.asarray(w.LAMBDA)).shape[1]
    nz = N * m + nth
    n_run = N - 2 if fmincon else N
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    Ad, Bd = t(A), t(B)
    Ksd = t(np.atleast_2d(Ks))
    Lq, Lr, Lp = t(w.Lq), t(w.Lr), t(w.Lp)
    LAM, PSI = t(w.LAMBDA), t(w.PSI)
    sqrtT = float(w.sqrtT)
    xs_ref = t(np.zeros(n) if dx_ref is None else dx_ref)
    scale = 1.0 if fmincon else float(np.sqrt(delta))
    Eks = np.zeros((N, m, nz))
    for k in range(N):
        Eks[k, :, k * m:(k + 1) * m] = np.eye(m)
    Eks = t(Eks)
    Tsel = np.zeros((nth, nz))
    Tsel[:, N * m:] = np.eye(nth)
    LAM_T = t(np.atleast_2d(np.asarray(w.LAMBDA, float)) @ Tsel)   # (n, nz)
    PSI_T = t(np.atleast_2d(np.asarray(w.PSI, float)) @ Tsel)      # (m, nz)

    def _finish(theta, xs, us, xN):
        Bsz = theta.shape[0]
        xa = mm(theta, LAM)                                         # (B, n)
        ua = mm(theta, PSI)                                         # (B, m)
        rx = scale * mm(xs[:, :n_run] - xa[:, None], Lq)
        ru = scale * mm(us[:, :n_run] - ua[:, None], Lr)
        rP = mm(xN - xa, Lp)
        rT = sqrtT * (xa - xs_ref)
        return torch.cat([rx.reshape(Bsz, -1), ru.reshape(Bsz, -1), rP, rT],
                         dim=1)

    def residual(z, dx0, window: DataWindow):
        cs = z[:, :N * m].reshape(-1, N, m)
        x = dx0
        xs, us = [], []
        for k in range(N):
            u = mm(x, Ksd) + cs[:, k] if fmincon else cs[:, k]
            x1 = (mm(x, Ad) + mm(u, Bd)
                  + nw_estimate(make_xi(x, u), window, bandwidth, ridge))
            xs.append(x)
            us.append(u)
            x = x1
        return _finish(z[:, N * m:], torch.stack(xs, 1), torch.stack(us, 1), x)

    def res_jac(z, dx0, window: DataWindow):
        Bsz = z.shape[0]
        cs = z[:, :N * m].reshape(Bsz, N, m)
        x = dx0
        S = torch.zeros(Bsz, n, nz, dtype=z.dtype, device=z.device)
        xs, us, Ss, dudzs = [], [], [], []
        for k in range(N):
            if fmincon:
                u = mm(x, Ksd) + cs[:, k]
                dudz = left(Ksd, S) + Eks[k]
            else:
                u = cs[:, k]
                dudz = Eks[k].expand(Bsz, m, nz)
            gv, Jg = nw_estimate_and_jac(make_xi(x, u), window, bandwidth,
                                         ridge)
            dxidz = torch.cat([S[:, :2], dudz], dim=1)   # xi = [x0, x1, u]
            x1 = mm(x, Ad) + mm(u, Bd) + gv
            S1 = left(Ad, S) + left(Bd, dudz) + Jg @ dxidz
            xs.append(x)
            us.append(u)
            Ss.append(S)
            dudzs.append(dudz)
            x, S = x1, S1
        Ss = torch.stack(Ss[:n_run], 1)                   # (B, n_run, n, nz)
        dudzs = torch.stack(dudzs[:n_run], 1)             # (B, n_run, m, nz)
        Jrx = scale * left(Lq, Ss - LAM_T)
        Jru = scale * left(Lr, dudzs - PSI_T)
        JrP = left(Lp, S - LAM_T)
        JrT = (sqrtT * LAM_T).expand(Bsz, n, nz)
        e = _finish(z[:, N * m:], torch.stack(xs, 1), torch.stack(us, 1), x)
        J = torch.cat([Jrx.reshape(Bsz, -1, nz), Jru.reshape(Bsz, -1, nz),
                       JrP, JrT], dim=1)
        return e, J

    return residual, res_jac


def make_lbmpc_solver(
    qp: CondensedQP,
    A: np.ndarray,
    B: np.ndarray,
    Ks: np.ndarray,
    w: LBMPCWeights,
    family: str = "fmincon",
    delta: float = 0.01,
    bandwidth: float = 0.5,
    ridge: float = 0.001,
    dx_ref: np.ndarray | None = None,
    sqp_iters: int = 3,
    ipm_iters: int = 30,
    dtype=torch.float64,
    mixed: bool = False,
    device=None,
):
    """Returns solve(dx0 (B, n), window, z_ws (B, nz)) -> (z (B, nz),
    converged (B,)): `sqp_iters` Gauss-Newton SQP iterations per lane on the
    learned-rollout residual (make_residual_and_jac's hand-derived Jacobian)
    under the constant nominal constraints G z <= h0 + Hp dx0, each QP solved
    by ops/ipm (`ipm_iters` iterations; mixed=True: float32 + a float64
    refinement, with `dtype` float64). The inputs are cast to `dtype` on the
    solver's device; `converged` is the last QP's flag, as in the reference.
    A lane's bits do not depend on the batch's size or the lane's place in
    it: the products and sums take ops/lanes' forms, and on the card a solve
    runs at least ops/lanes.MIN_LANES lanes (on_min_lanes), in float32 and
    float64 alike.
    family='fmincon': u_k = Ks x_k + c_k, running stages 0..N-3;
    family='casadi': u_k = c_k, delta-scaled running stages 0..N-1."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    Gd, h0d, Hpd = t(qp.G), t(qp.h0), t(qp.Hp)
    residual, res_jac = make_residual_and_jac(
        qp, A, B, Ks, w, family=family, delta=delta, bandwidth=bandwidth,
        ridge=ridge, dx_ref=dx_ref, dtype=dtype, device=dev)

    def solve(dx0, window: DataWindow, z_ws):
        return on_min_lanes(solve_lanes, dx0.to(dev, dtype), window.to(dtype, dev),
                            z_ws.to(dev, dtype))

    def solve_lanes(dx0, window: DataWindow, z_ws):
        Bsz = dx0.shape[0]

        def cost(z):
            # z may stack k copies of the batch (sqp_solve's merit ladder)
            k = z.shape[0] // Bsz
            if k == 1:
                e = residual(z, dx0, window)
            else:
                tile = lambda a: a.repeat((k,) + (1,) * (a.ndim - 1))
                e = residual(z, tile(dx0), DataWindow(*(tile(a) for a in window)))
            return exact_sum(e * e)

        h = h0d + lane_mm(dx0, Hpd)
        out = sqp_solve(cost, lambda z: residual(z, dx0, window), Gd, h, z_ws,
                        iters=sqp_iters, ipm_iters=ipm_iters, mixed=mixed,
                        res_jac_fn=lambda z: res_jac(z, dx0, window))
        return out.z, out.qp_converged

    return solve


def make_lbmpc_solver_sparse(
    qp: CondensedQP,
    A: np.ndarray,
    B: np.ndarray,
    Ks: np.ndarray,
    w: LBMPCWeights,
    cs,
    family: str = "fmincon",
    delta: float = 0.01,
    bandwidth: float = 0.5,
    ridge: float = 0.001,
    dx_ref: np.ndarray | None = None,
    sqp_iters: int = 3,
    ipm_iters: int = 30,
    terminal_at: str = "first",
    tighten_first_step: bool = True,
    dtype=torch.float64,
    rho: float = 1e4,
    device=None,
):
    """LBMPC SQP whose subproblems run in stage form (ops/sparse_gn.py):
    each Gauss-Newton step is a Riccati-factored Mehrotra IPM over the
    dual-trajectory stage variables instead of a dense condensed QP — O(N)
    per Newton system instead of O((Nm)^3). `qp` gives only the layout
    (N, n, m, nz) and the shared residual stack. Ref: the lifted DMS NLPs
    the reference hands to IPOPT (examples/DMS_LBMPC_casadi.m:122-130).

    Returns solve(dx0 (B, n), window, z_ws (B, nz)) -> (z, converged (B,))
    — the contract and the cost/constraint semantics of make_lbmpc_solver.
    Each SQP iteration linearizes the learned rollout (the NW value and its
    closed-form Jacobian) and the nominal one, solves the GN subproblem, and
    steps by the first of the step sizes (1, 1/2, 1/4, 1/8, 1/16) that
    passes the Armijo test on the l1 merit cost + rho * violation, per lane;
    a lane where none passes takes no step. A non-finite step is zeroed only
    after the ladder has run on it, so it fails every rung and steps 0.
    `converged` is the last SQP iteration's QP flag."""
    from lbmpc_tpu_torch.ops.sparse_gn import make_stage_gn, solve_sparse_gn

    dev = resolve_device(device)
    N, n, m = qp.N, qp.n, qp.m
    sg = make_stage_gn(A, B, Ks, np.asarray(w.Lq).T @ np.asarray(w.Lq),
                       np.asarray(w.Lr).T @ np.asarray(w.Lr),
                       np.asarray(w.Lp).T @ np.asarray(w.Lp),
                       float(w.sqrtT) ** 2, w.LAMBDA, w.PSI, cs, N, delta,
                       family=family, terminal_at=terminal_at,
                       tighten_first_step=tighten_first_step, dtype=dtype,
                       device=dev)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    Ad, Bd = t(A), t(B)
    Ksd = t(np.atleast_2d(Ks)) if family == "fmincon" else t(np.zeros((m, n)))
    An = Ad + Bd @ Ksd
    LAM, PSI = t(w.LAMBDA), t(w.PSI)
    xs_ref = t(np.zeros(n) if dx_ref is None else dx_ref)
    T2 = 2.0 * float(w.sqrtT) ** 2
    residual, _ = make_residual_and_jac(
        qp, A, B, Ks, w, family=family, delta=delta, bandwidth=bandwidth,
        ridge=ridge, dx_ref=dx_ref, dtype=dtype, device=dev)
    # selector rows: dxi/dxl = [e1; e2; Ks or 0], dxi/dc = [0; 0; I]
    Exl = torch.cat([torch.eye(2, n, dtype=dtype, device=dev), Ksd], dim=0)  # (3, n)
    cm = sg.cost_mask[:, None]

    def nominal(cvals, dx0):
        """x_0..x_N of the nominal rollout (B, N+1, n)."""
        xs = [dx0]
        for k in range(N):
            xs.append(xs[-1] @ An.mT + cvals[:, k] @ Bd.mT)
        return torch.stack(xs, 1)

    def linearize(z, dx0, window):
        Bsz = z.shape[0]
        cvals = z[:, :N * m].reshape(Bsz, N, m)
        theta = z[:, N * m:]
        xl = dx0
        Als, Bls, xls, us = [], [], [], []
        for k in range(N):
            u = xl @ Ksd.mT + cvals[:, k]
            gv, Jg = nw_estimate_and_jac(make_xi(xl, u), window, bandwidth, ridge)
            Als.append(An + Jg @ Exl)
            Bls.append(Bd + Jg[..., 2:3])
            xls.append(xl)
            us.append(u)
            xl = xl @ Ad.mT + u @ Bd.mT + gv
        xls, us, xlN = torch.stack(xls, 1), torch.stack(us, 1), xl
        xn_all = nominal(cvals, dx0)

        # GN linear terms (the pre-doubled convention of StageGNQP's blocks)
        ex = xls - (theta @ LAM.mT)[:, None]              # (B, N, n)
        eu = us - (theta @ PSI.mT)[:, None]               # (B, N, m)
        eN = xlN - theta @ LAM.mT
        q_stage = cm * (ex @ sg.Qb.mT + eu @ (sg.Ks.mT @ sg.Rb).mT)
        q_xl = torch.cat([q_stage, (eN @ sg.Pb.mT)[:, None]], dim=1)
        r_c = cm * (eu @ sg.Rb.mT)
        g_th = (-((ex * cm).sum(1) @ sg.Qb.mT) @ LAM
                - ((eu * cm).sum(1) @ sg.Rb.mT) @ PSI
                - (eN @ sg.Pb.mT) @ LAM
                + theta @ sg.TLL.mT
                - T2 * (xs_ref @ LAM))
        hx_t = sg.h_x - xn_all[:, 1:] @ sg.F_x.mT
        hu_t = sg.h_u - (cvals + xn_all[:, :N] @ Ksd.mT) @ sg.F_u.mT
        hd_t = sg.h_d - xn_all[:, 1] @ sg.F_d.mT
        hw_t = sg.h_w - xn_all[:, sg.kT] @ sg.Fw_x.mT - theta @ sg.Fw_th.mT
        return (torch.stack(Als, 1), torch.stack(Bls, 1), q_xl, r_c, g_th,
                hx_t, hu_t, hd_t, hw_t)

    def viol_of(z, dx0):
        Bsz = z.shape[0]
        cvals = z[:, :N * m].reshape(Bsz, N, m)
        theta = z[:, N * m:]
        xn_all = nominal(cvals, dx0)
        vx = torch.clamp(xn_all[:, 1:] @ sg.F_x.mT - sg.h_x, min=0.0)
        vu = torch.clamp((cvals + xn_all[:, :N] @ Ksd.mT) @ sg.F_u.mT - sg.h_u, min=0.0)
        vd = torch.clamp(xn_all[:, 1] @ sg.F_d.mT - sg.h_d, min=0.0)
        vw = torch.clamp(xn_all[:, sg.kT] @ sg.Fw_x.mT + theta @ sg.Fw_th.mT - sg.h_w,
                         min=0.0)
        return (lane_sum((vx * sg.srow_mask[:, None]).flatten(1))
                + lane_sum((vu * sg.urow_mask[:, None]).flatten(1))
                + lane_sum(vd) + lane_sum(vw))

    def solve(dx0, window: DataWindow, z_ws):
        dx0 = dx0.to(dev, dtype)
        window = window.to(dtype, dev)
        z = z_ws.to(dev, dtype)
        Bsz = dx0.shape[0]
        k = len(_ALPHAS) + 1
        tile = lambda a: a.repeat((k,) + (1,) * (a.ndim - 1))
        dx0_k, win_k = tile(dx0), DataWindow(*(tile(a) for a in window))

        def cost(zs):
            e = residual(zs, dx0, window)
            return lane_sum(e * e)

        conv = None
        for _ in range(sqp_iters):
            sol = solve_sparse_gn(sg, *linearize(z, dx0, window), iters=ipm_iters)
            d = torch.cat([sol.dC.reshape(Bsz, -1), sol.dth], dim=1)
            conv = sol.converged
            # lanes are independent: the gradient of the lane sum holds each
            # lane's own
            g_z = torch.func.grad(lambda zz: cost(zz).sum())(z)
            # the merit at z and at every step size, in one rollout
            zs = torch.cat([z] + [z + a * d for a in _ALPHAS])
            e = residual(zs, dx0_k, win_k)
            viol = viol_of(zs, dx0_k)
            merit = (lane_sum(e * e) + rho * viol).reshape(k, Bsz)
            m0 = merit[0]
            dirderiv = (g_z * d).sum(dim=1) - rho * viol[:Bsz]
            accepted = torch.zeros(Bsz, dtype=torch.bool, device=dev)
            alpha_sel = torch.zeros(Bsz, dtype=dtype, device=dev)
            for i, a in enumerate(_ALPHAS):
                ok = ~accepted & (merit[i + 1] <= m0 + 1e-4 * a * dirderiv)
                alpha_sel = torch.where(ok, a, alpha_sel)
                accepted = accepted | ok
            d = torch.where(torch.isfinite(d), d, 0.0)
            z = z + alpha_sel[:, None] * d
        return z, conv

    solve.linearize = linearize
    solve.stage_qp = sg
    return solve


def make_casadi_warm_start(qp: CondensedQP, A, B, Ks, dtype=torch.float64,
                           device=None):
    """Shift-and-append warm start (ref: DMS_LBMPC_casadi.m:209-213), batched:
    z' = [du_1..du_{N-1}, Ks dx_N^nom, theta], where dx_N^nom is the nominal
    condensed rollout's final state from dx_used under the solution."""
    dev = resolve_device(device)
    N, m = qp.N, qp.m
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    SxN, ScN, Ksd = t(qp.Sx[N]), t(qp.Sc[N]), t(np.atleast_2d(Ks))

    def warm(z, dx_used, dx_next, window):
        cs = z[:, :N * m]
        dxN = lane_mm(dx_used, SxN) + lane_mm(cs, ScN)
        return torch.cat([cs[:, m:], lane_mm(dxN, Ksd), z[:, N * m:]], dim=1)

    return warm
