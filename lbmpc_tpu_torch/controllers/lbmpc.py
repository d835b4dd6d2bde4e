"""Learning-based MPC: learned-model cost + nominal-model constraints.

The core LBMPC split (ref: functions/costLBMPC.m:27 vs constraintsLBMPC.m:23):
performance is optimized against the oracle-corrected model while safety
constraints are enforced on the nominal model. In condensed form the nominal
constraints are the constant (G, h0, Hp) stack of the condensed QP; only the
cost rolls out the learned dynamics, as the Gauss-Newton residual stack built
here (batched over lanes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbmpc_tpu_torch.controllers.condensed import CondensedQP
from lbmpc_tpu_torch.device import resolve_device
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
