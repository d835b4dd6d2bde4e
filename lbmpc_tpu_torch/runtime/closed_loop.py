"""Closed-loop receding-horizon harness, batched.

Port of lbmpc_tpu/runtime/closed_loop: run_closed_loop_batched advances the
whole cohort step by step with a batch-level solver (a Python loop over the
steps; every step's tensors stay on the solver's device); run_closed_loop is
the single-scenario episode, a cohort of one.

Step semantics (fmincon family, ref: functions/ocpLBMPC.m):
  1. dx = x - x_wp
  2. z = solve OCP(dx, window, z_warmstart)
  3. u = Ks dx + c_0 + u_wp                  (ref: transitionTrue.m:11)
  4. x+ = plant(x, u)
  5. window += (xi(dx, du), residual)        (ref: ocpLBMPC.m:14-19)
  6. log [dx; du]                            (ref: ocpLBMPC.m:40)
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from lbmpc_tpu_torch.ops.lanes import lane_mm
from lbmpc_tpu_torch.oracle import DataWindow, observe_residual, push_batched


class ClosedLoopResult(NamedTuple):
    sys_history: torch.Tensor       # (B, iterations+1, n+m): [dx; du], initial column first
    art_history: torch.Tensor       # (B, iterations, m): artificial reference LAMBDA theta
    solver_converged: torch.Tensor  # (B, iterations) bool
    final_window: DataWindow
    final_x: torch.Tensor = None    # (B, n) absolute plant state after the last step
    final_z: torch.Tensor = None    # (B, nz) warm start for the next solve


def run_closed_loop_batched(
    solve_batch: Callable,    # (dx (B,n), windows, z_ws (B,nz)) -> (z (B,nz), conv (B,))
    plant_step: Callable,     # (x_abs (B,n), u_abs (B,m)) -> x_abs' (batched)
    warm_start_fn: Callable,  # (z, dx_used, dx_next, windows) -> z_ws (batched)
    Ks: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    Mtheta_x: torch.Tensor,
    x_wp: torch.Tensor,
    u_wp: torch.Tensor,
    dx_init: torch.Tensor,    # (B, n)
    z0: torch.Tensor,         # (B, nz)
    window0: DataWindow,      # batched (leading axis B)
    iterations: int,
    learn: bool = True,
    log_post_state: bool = True,
    qp_warm_solve: Callable | None = None,
    qp_init_state: Callable | None = None,
    x_init: torch.Tensor | None = None,
) -> ClosedLoopResult:
    """Advance the cohort `iterations` steps (ref: functions/ocpLBMPC.m:10-46).

    qp_warm_solve/qp_init_state (cross-step warm chain): when given, the QP
    kernel's interior (s, z) state is threaded across time steps —
    qp_warm_solve(dx, window, z_ws, qp_state) -> (z, conv, qp_state') with
    qp_init_state(dx_init, z0) seeding step 0 cold-identically. Every
    product takes a form whose bits do not depend on B, so with a solver
    whose lanes do not either (the per-problem stack, the NMPC's, the fused
    fleet's on pallas_full) a lane of a batch equals its run alone.
    x_init (B, n): the absolute plant state to start from
    (a checkpoint's, runtime/checkpoint.resume), where x_wp + dx_init may
    round away from it; dx_init is then x_init - x_wp."""
    m = u_wp.shape[-1] if u_wp.ndim else 1
    u_wp = torch.atleast_1d(u_wp)
    nth = Mtheta_x.shape[1]
    chain = qp_warm_solve is not None

    x = x_wp[None, :] + dx_init if x_init is None else x_init
    window, z_ws = window0, z0
    qps = qp_init_state(dx_init, z0) if chain else None
    sys_h, art_h, conv_h = [], [], []
    for _ in range(iterations):
        dx = x - x_wp[None, :]
        if chain:
            z, converged, qps = qp_warm_solve(dx, window, z_ws, qps)
        else:
            z, converged = solve_batch(dx, window, z_ws)
        # Ks dx as products and a short sum per lane, not a matrix product,
        # whose kernel cuBLAS picks by B
        du = (dx[:, None, :] * Ks).sum(dim=-1) + z[:, :m]
        x1 = plant_step(x, du + u_wp[None, :])
        dx1 = x1 - x_wp[None, :]
        if learn:
            xi_new, y_new = observe_residual(dx, du, dx1, A, B)
            window = push_batched(window, xi_new, y_new)
        z_ws = warm_start_fn(z, dx, dx1, window)
        sys_h.append(torch.cat([dx1 if log_post_state else dx, du], dim=1))
        art_h.append(lane_mm(z[:, -nth:], Mtheta_x)[:, :m])
        conv_h.append(converged)
        x = x1
    first = torch.cat([dx_init, torch.zeros(dx_init.shape[0], m,
                                            dtype=dx_init.dtype,
                                            device=dx_init.device)], dim=1)
    return ClosedLoopResult(
        sys_history=torch.stack([first] + sys_h, dim=1),
        art_history=torch.stack(art_h, dim=1),
        solver_converged=torch.stack(conv_h, dim=1),
        final_window=window, final_x=x, final_z=z_ws)


def run_closed_loop(
    solve_fn: Callable,       # (dx (B,n), window, z_ws (B,nz)) -> (z, converged), batched
    plant_step: Callable,     # (x_abs (B,n), u_abs (B,m)) -> x_abs', batched
    warm_start_fn: Callable,  # (z, dx_used, dx_next, window) -> z_ws, batched
    Ks: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    Mtheta_x: torch.Tensor,   # LAMBDA (n, nth), for the artificial-reference log
    x_wp: torch.Tensor,
    u_wp: torch.Tensor,
    dx_init: torch.Tensor,    # (n,)
    z0: torch.Tensor,         # (nz,)
    window0: DataWindow,      # one lane's window (no lane axis)
    iterations: int,
    learn: bool = True,
    log_post_state: bool = True,
    x_init: torch.Tensor | None = None,   # (n,)
) -> ClosedLoopResult:
    """One scenario's episode (ref: run_closed_loop): the cohort of one lane
    through run_closed_loop_batched, with the lane axis taken off the
    result: sys_history (iterations+1, n+m), art_history (iterations, m),
    solver_converged (iterations,). The solver, plant and warm start take
    the port's batched forms. log_post_state picks the reference scripts'
    logging convention: ocpLMPC/ocpNMPC log the state after the step
    (ocpLMPC.m:33-37), ocpLBMPC the state before it (ocpLBMPC.m:37-40)."""
    res = run_closed_loop_batched(
        solve_fn, plant_step, warm_start_fn, Ks, A, B, Mtheta_x, x_wp, u_wp,
        dx_init[None], z0[None], DataWindow(*(a[None] for a in window0)),
        iterations, learn=learn, log_post_state=log_post_state,
        x_init=None if x_init is None else x_init[None])
    return ClosedLoopResult(
        sys_history=res.sys_history[0], art_history=res.art_history[0],
        solver_converged=res.solver_converged[0],
        final_window=DataWindow(*(a[0] for a in res.final_window)),
        final_x=res.final_x[0], final_z=res.final_z[0])
