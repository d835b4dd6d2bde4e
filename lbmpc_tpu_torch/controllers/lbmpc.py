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
from lbmpc_tpu_torch.controllers.sqp import sqp_solve
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.ops.lanes import lane_sum
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
    """
    dev = resolve_device(device)
    N, n, m = qp.N, qp.n, qp.m
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
        xa = theta @ LAM.T                                          # (B, n)
        ua = theta @ PSI.T                                          # (B, m)
        rx = scale * ((xs[:, :n_run] - xa[:, None]) @ Lq.T)
        ru = scale * ((us[:, :n_run] - ua[:, None]) @ Lr.T)
        rP = (xN - xa) @ Lp.T
        rT = sqrtT * (xa - xs_ref)
        return torch.cat([rx.reshape(Bsz, -1), ru.reshape(Bsz, -1), rP, rT],
                         dim=1)

    def residual(z, dx0, window: DataWindow):
        cs = z[:, :N * m].reshape(-1, N, m)
        x = dx0
        xs, us = [], []
        for k in range(N):
            u = x @ Ksd.T + cs[:, k] if fmincon else cs[:, k]
            x1 = (x @ Ad.T + u @ Bd.T
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
                u = x @ Ksd.T + cs[:, k]
                dudz = Ksd @ S + Eks[k]
            else:
                u = cs[:, k]
                dudz = Eks[k].expand(Bsz, m, nz)
            gv, Jg = nw_estimate_and_jac(make_xi(x, u), window, bandwidth,
                                         ridge)
            dxidz = torch.cat([S[:, :2], dudz], dim=1)   # xi = [x0, x1, u]
            x1 = x @ Ad.T + u @ Bd.T + gv
            S1 = Ad @ S + Bd @ dudz + Jg @ dxidz
            xs.append(x)
            us.append(u)
            Ss.append(S)
            dudzs.append(dudz)
            x, S = x1, S1
        Ss = torch.stack(Ss[:n_run], 1)                   # (B, n_run, n, nz)
        dudzs = torch.stack(dudzs[:n_run], 1)             # (B, n_run, m, nz)
        Jrx = scale * (Lq @ (Ss - LAM_T))
        Jru = scale * (Lr @ (dudzs - PSI_T))
        JrP = Lp @ (S - LAM_T)
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
    family='fmincon': u_k = Ks x_k + c_k, running stages 0..N-3;
    family='casadi': u_k = c_k, delta-scaled running stages 0..N-1."""
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    Gd, h0d, Hpd = t(qp.G), t(qp.h0), t(qp.Hp)
    residual, res_jac = make_residual_and_jac(
        qp, A, B, Ks, w, family=family, delta=delta, bandwidth=bandwidth,
        ridge=ridge, dx_ref=dx_ref, dtype=dtype, device=dev)

    def solve(dx0, window: DataWindow, z_ws):
        dx0 = dx0.to(dev, dtype)
        window = window.to(dtype, dev)
        Bsz = dx0.shape[0]

        def cost(z):
            # z may stack k copies of the batch (sqp_solve's merit ladder)
            k = z.shape[0] // Bsz
            if k == 1:
                e = residual(z, dx0, window)
            else:
                tile = lambda a: a.repeat((k,) + (1,) * (a.ndim - 1))
                e = residual(z, tile(dx0), DataWindow(*(tile(a) for a in window)))
            return lane_sum(e * e)

        h = h0d + dx0 @ Hpd.T
        out = sqp_solve(cost, lambda z: residual(z, dx0, window), Gd, h,
                        z_ws.to(dev, dtype), iters=sqp_iters, ipm_iters=ipm_iters,
                        mixed=mixed, res_jac_fn=lambda z: res_jac(z, dx0, window))
        return out.z, out.qp_converged

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
        dxN = dx_used @ SxN.T + cs @ ScN.T
        return torch.cat([cs[:, m:], dxN @ Ksd.T, z[:, N * m:]], dim=1)

    return warm
