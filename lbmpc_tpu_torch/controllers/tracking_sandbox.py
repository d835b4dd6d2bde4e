"""Tracking-MPC sandbox: the reference's didactic double-integrator subtree.

Port of lbmpc_tpu/controllers/tracking_sandbox.py (ref:
matlab/trackingMPC/RunExample.m, nominal, and RunExample_robust.m, tube).
2-state/2-input double integrator, N=3, artificial-steady-state tracking of a
piecewise-constant reference schedule, with terminal sets computed ONLINE
(extended-state MPIS, MAIS comparison) rather than loaded from a cache. The
host part (gains, sets, the condensed QP) is numpy on the port's own `sets`
and `synthesis`; the closed loop solves one QP a step with ops/ipm.solve_qp
on the given device, in float64.

Formulation notes (kept faithful):
  - decision z = [u_0..u_{N-1}; theta]; plant/prediction are the same LTI
    (getTransitions applies u directly, trackingMPC/getTransitions.m:1-5);
  - cost (costFunction.m:24-39): running stages k=0..N-2 on (x_k, u_k),
    terminal P on x_{N-1}, steady-state offset T = 100*P;
  - constraints (constraintsFunction.m:26-40): run_F [x_k; u_k] <= run_h for
    k=0..N-1, terminal set on [x_N; theta];
  - reference schedule set_ref (RunExample.m:213-223).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.models.linear import DLTIModel, double_integrator
from lbmpc_tpu_torch.ops.ipm import solve_qp
from lbmpc_tpu_torch.sets.invariant import calc_mrpis, compute_mpis
from lbmpc_tpu_torch.sets.polytope import Polytope, box, from_vertices
from lbmpc_tpu_torch.synthesis import dare, dlqr, steady_state_parametrization


@dataclasses.dataclass(frozen=True)
class TrackingSetup:
    """Everything RunExample.m derives before its MPC loop."""

    model: DLTIModel
    K: np.ndarray
    P: np.ndarray
    T: np.ndarray
    LAMBDA: np.ndarray
    PSI: np.ndarray
    Xc: Polytope
    Uc: Polytope
    term: Polytope        # extended-state [x; theta] terminal set (MPIS)
    mais: Polytope        # classic MAIS of the prestabilized system (comparison)
    Xf: Polytope          # terminal set projected to x-space
    # condensed QP pieces: min 1/2 z'Hz + (Gp x0 + Gr xs)'z, Gz <= h0 + Hp x0
    H: np.ndarray
    Gp: np.ndarray
    Gr: np.ndarray
    G: np.ndarray
    h0: np.ndarray
    Hp: np.ndarray
    N: int

    @property
    def nz(self) -> int:
        return self.N * self.model.m + self.model.m


def reference_schedule(k) -> np.ndarray:
    """Piecewise-constant xs(k) (ref: RunExample.m:213-223, 1-based k): (2,)
    for a step k, (..., 2) for an array of steps."""
    k1 = np.asarray(k)[..., None] + 1
    return np.where(
        k1 <= 30,
        np.asarray([4.95, 0.0]),
        np.where(
            k1 <= 60,
            np.asarray([-5.5, 0.0]),
            np.where(k1 <= 90, np.asarray([2.0, 0.0]), np.asarray([0.0, 0.0])),
        ),
    )


def build_tracking_setup(
    N: int = 3,
    u_lim: float = 0.3,
    x_lim: float = 5.0,
    lam: float = 0.99,
    robust_w: float | None = None,
) -> TrackingSetup:
    """Derive gains, sets, and the condensed QP (ref: RunExample.m:20-118).

    robust_w: if set (e.g. 0.1), performs the RunExample_robust.m pipeline —
    mRPIS Z of the disturbance box [-w, w]^2, tightened X ⊖ Z and U ⊖ KZ,
    robust terminal set on the tightened extended set.
    """
    model = double_integrator()
    A, B, C = model.A, model.B, model.C
    n, m = model.n, model.m
    Q = np.eye(n)
    R = np.eye(m)
    K = -dlqr(A, B, Q, R)
    P = dare(A + B @ K, B, Q, R)
    T = 100.0 * P
    _, LAMBDA, PSI, LAMBDA_0, PSI_0 = steady_state_parametrization(A, B, C)

    Xc = box([-x_lim] * n, [x_lim] * n)
    Uc = box([-u_lim] * m, [u_lim] * m)
    F_x, h_x = Xc.F, Xc.h
    F_u, h_u = Uc.F, Uc.h

    if robust_w is not None:
        # RunExample_robust.m:109-119 — mRPIS of w-box under A+BK, tighten.
        W = box([-robust_w] * n, [robust_w] * n)
        Z = calc_mrpis(A + B @ K, W.F, W.h, eps=1e-2)
        Xt = Xc.pontryagin_diff(Z).min_hrep()
        KZ_vertices = Z.vertices() @ K.T
        KZ = from_vertices(KZ_vertices)
        Ut = Uc.pontryagin_diff(KZ).min_hrep()
        F_x, h_x = Xt.F, Xt.h
        F_u, h_u = Ut.F, Ut.h

    L = PSI - K @ LAMBDA
    L0 = PSI_0 - K @ LAMBDA_0
    F_w = np.vstack(
        [
            np.hstack([F_x, np.zeros((F_x.shape[0], m))]),
            np.hstack([np.zeros((F_x.shape[0], n)), F_x @ LAMBDA]),
            np.hstack([F_u @ K, F_u @ L]),
            np.hstack([np.zeros((F_u.shape[0], n)), F_u @ PSI]),
        ]
    )
    h_w = np.concatenate(
        [h_x, lam * (h_x - F_x @ LAMBDA_0), h_u - F_u @ L0, lam * (h_u - F_u @ PSI_0)]
    )
    Ak = np.block([[A + B @ K, B @ L], [np.zeros((m, n)), np.eye(m)]])
    term = compute_mpis(Polytope(F_w, h_w), Ak).min_hrep()

    # classic MAIS for comparison (ref: RunExample.m:97-101)
    mais_cons = Polytope(
        np.vstack([K, -K, np.eye(n), -np.eye(n)]),
        np.concatenate([np.full(m, u_lim), np.full(m, u_lim), np.full(n, x_lim), np.full(n, x_lim)]),
    )
    mais = compute_mpis(mais_cons, A + B @ K).min_hrep()
    Xf = term.project(range(n)).min_hrep()

    # ---- condensed QP over z = [u_0..u_{N-1}; theta] ----
    nz = N * m + m
    run_F = np.vstack(
        [
            np.hstack([Xc.F, np.zeros((Xc.F.shape[0], m))]),
            np.hstack([np.zeros((Uc.F.shape[0], n)), Uc.F]),
        ]
    )
    run_h = np.concatenate([Xc.h, Uc.h])

    Sx = np.zeros((N + 1, n, n))
    Su = np.zeros((N + 1, n, N * m))
    Sx[0] = np.eye(n)
    for k in range(1, N + 1):
        Sx[k] = A @ Sx[k - 1]
        Su[k] = A @ Su[k - 1]
        Su[k][:, (k - 1) * m : k * m] = B

    th_sel = np.zeros((m, nz))
    th_sel[:, N * m :] = np.eye(m)

    def u_sel(k):
        E = np.zeros((m, nz))
        E[:, k * m : (k + 1) * m] = np.eye(m)
        return E

    def x_op(k):
        Mx = np.zeros((n, nz))
        Mx[:, : N * m] = Su[k]
        return Mx, Sx[k]

    H = np.zeros((nz, nz))
    Gp = np.zeros((nz, n))
    Gr = np.zeros((nz, n))
    for k in range(N - 1):  # running stages 0..N-2
        Mx, Nx = x_op(k)
        Ex = Mx - LAMBDA @ th_sel
        H += 2.0 * Ex.T @ Q @ Ex
        Gp += 2.0 * Ex.T @ Q @ Nx
        Eu = u_sel(k) - PSI @ th_sel
        H += 2.0 * Eu.T @ R @ Eu
    MxT, NxT = x_op(N - 1)  # terminal P on x_{N-1} (reference quirk)
    Ex = MxT - LAMBDA @ th_sel
    H += 2.0 * Ex.T @ P @ Ex
    Gp += 2.0 * Ex.T @ P @ NxT
    Et = LAMBDA @ th_sel
    H += 2.0 * Et.T @ T @ Et
    Gr += -2.0 * Et.T @ T  # linear coupling to the reference xs

    G_rows, h0_rows, Hp_rows = [], [], []
    for k in range(N):  # run_F [x_k; u_k] <= run_h, k=0..N-1
        Mx, Nx = x_op(k)
        lift = np.vstack([Mx, u_sel(k)])
        liftN = np.vstack([Nx, np.zeros((m, n))])
        G_rows.append(run_F @ lift)
        h0_rows.append(run_h)
        Hp_rows.append(-run_F @ liftN)
    MxN, NxN = x_op(N)
    Fw_x = term.F[:, :n]
    Fw_th = term.F[:, n:]
    G_rows.append(Fw_x @ MxN + Fw_th @ th_sel)
    h0_rows.append(term.h)
    Hp_rows.append(-Fw_x @ NxN)

    return TrackingSetup(
        model=model, K=K, P=P, T=T, LAMBDA=LAMBDA, PSI=PSI,
        Xc=Xc, Uc=Uc, term=term, mais=mais, Xf=Xf,
        H=H, Gp=Gp, Gr=Gr,
        G=np.vstack(G_rows), h0=np.concatenate(h0_rows), Hp=np.vstack(Hp_rows),
        N=N,
    )


class TrackingResult(NamedTuple):
    sys_history: torch.Tensor   # (iterations+1, n+m)
    art_history: torch.Tensor   # (iterations, n)
    refs: torch.Tensor          # (iterations, n)
    converged: torch.Tensor     # (iterations,) bool


def run_tracking_episode(
    setup: TrackingSetup,
    x0,
    iterations: int = 100,
    ipm_iters: int = 30,
    disturbance_seed: int | None = None,
    w_max: float = 0.0,
    disturbances=None,
    device=None,
) -> TrackingResult:
    """Closed loop of RunExample.m:131-147 (+ the random disturbance of the
    robust variant, RunExample_robust.m:162,254-280), one QP a step on
    `device` (CUDA unless named), float64.

    The disturbance w_k is uniform in [-w_max, w_max]^n, drawn on the host
    from numpy's generator seeded with disturbance_seed (0 when None), or
    given as `disturbances` (iterations, n); the reference draws its own
    from jax.random, so comparisons pass its draws in."""
    dev = resolve_device(device)
    n, m = setup.model.n, setup.model.m
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=torch.float64, device=dev)
    H, Gp, Gr, G, h0, Hp = (t(a) for a in (setup.H, setup.Gp, setup.Gr, setup.G,
                                           setup.h0, setup.Hp))
    A, B, LAM = t(setup.model.A), t(setup.model.B), t(setup.LAMBDA)
    if disturbances is None:
        rng = np.random.default_rng(0 if disturbance_seed is None else disturbance_seed)
        disturbances = rng.uniform(-w_max, w_max, (iterations, n))
    W = t(disturbances)
    refs = t(reference_schedule(np.arange(iterations)))
    x = t(x0)
    sys_h, art_h, conv = [torch.cat([x, torch.zeros(m, dtype=x.dtype, device=dev)])], [], []
    for k in range(iterations):
        xs = refs[k]
        sol = solve_qp(H, Gp @ x + Gr @ xs, G, h0 + Hp @ x, iters=ipm_iters)
        u, theta = sol.x[:m], sol.x[-m:]
        x = A @ x + B @ u + W[k]
        sys_h.append(torch.cat([x, u]))
        art_h.append(LAM @ theta)
        conv.append(sol.converged)
    return TrackingResult(torch.stack(sys_h), torch.stack(art_h), refs, torch.stack(conv))
