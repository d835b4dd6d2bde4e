"""SQP engine: a Gauss-Newton cost model and dense QP subproblems, batched.

Port of lbmpc_tpu/controllers/sqp.py:
- sqp_solve, the per-problem SQP behind controllers/lbmpc.make_lbmpc_solver
  (the vmapped repair of the hybrid solvers and the float64 parity path). In
  LBMPC only the cost is nonconvex (the learned rollout); the constraints
  G z <= h stay affine, so each SQP iteration is one dense convex QP
  (ops/ipm). A lane where no step size passes the Armijo test takes the
  smallest one, as in the reference.
- sqp_solve_nonlinear_constraints, the NMPC's SQP (controllers/nmpc): the
  constraints c(z) <= 0 are linearized each iteration, with a G per lane.
  A lane where no step size passes takes no step, and a non-finite step is
  zeroed, as in the reference (the same guard as the fused solver's ladder).
The reference vmaps one problem; here the lanes are the leading axis of z, h
and of what the callbacks return. Fixed iteration counts and the fixed
ladder of step sizes (1, 1/2, 1/4, 1/8, 1/16) on an l1 merit keep every lane
in step.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from lbmpc_tpu_torch.ops.ipm import solve_qp, solve_qp_mixed
from lbmpc_tpu_torch.ops.lanes import exact_mv, exact_sum, lane_mm


class SQPResult(NamedTuple):
    z: torch.Tensor             # (B, nz)
    cost: torch.Tensor          # (B,)
    qp_converged: torch.Tensor  # (B,) convergence flag of the last QP subproblem
    step_norms: torch.Tensor    # (B, iters) |d| per iteration — diagnostics


_ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)


def sqp_solve(
    cost_fn: Callable[[torch.Tensor], torch.Tensor],
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    G: torch.Tensor,
    h: torch.Tensor,
    z0: torch.Tensor,
    iters: int = 4,
    ipm_iters: int = 30,
    rho: float = 1e4,
    reg: float = 1e-9,
    mixed: bool = False,
    res_jac_fn: Callable | None = None,
) -> SQPResult:
    """Minimize cost_fn(z) = ||residual_fn(z)||^2 subject to G z <= h, per
    lane: z0 (B, nz), h (B, m), G (m, nz) shared or (B, m, nz).

    cost_fn takes a stack of k copies of the batch along the lanes (k B
    lanes, copy i holding lane j at row i B + j) and returns (k B,): the
    merit ladder evaluates every step size in one call. residual_fn(z) ->
    e (B, ne); res_jac_fn(z) -> (e, J (B, ne, nz)) when the caller has the
    hand-derived Jacobian, else J and the gradient come from torch.func.
    mixed=True solves each QP with solve_qp_mixed (float32 IPM + float64
    refinement). The products and sums take ops/lanes' forms, so a lane's
    bits do not depend on the batch's size (cost_fn should sum with
    exact_sum too)."""
    Bsz, nz = z0.shape
    Ireg = reg * torch.eye(nz, dtype=z0.dtype, device=z0.device)
    alphas = torch.tensor(_ALPHAS, dtype=z0.dtype, device=z0.device)
    k = len(_ALPHAS)

    def gz(zs):
        return lane_mm(zs, G) if G.ndim == 2 else exact_mv(
            G.repeat(zs.shape[0] // Bsz, 1, 1), zs)

    def violation(zs, hs):
        return exact_sum(torch.clamp(gz(zs) - hs, min=0.0))

    z = z0
    norms = []
    conv = None
    for _ in range(iters):
        if res_jac_fn is None:
            # lanes are independent: the Jacobian of the lane sum holds each
            # lane's own block
            J = torch.func.jacrev(lambda zz: residual_fn(zz).sum(dim=0))(z).transpose(0, 1)
            g = torch.func.grad(lambda zz: cost_fn(zz).sum())(z)
        else:
            e, J = res_jac_fn(z)
            g = 2.0 * exact_mv(J.transpose(1, 2), e)
        H = 2.0 * J.transpose(1, 2) @ J + Ireg
        # the QP in the step d: min 1/2 d'Hd + g'd  s.t.  G d <= h - G z
        hq = h - gz(z)
        sol = (solve_qp_mixed(H, g, G, hq, f32_iters=ipm_iters) if mixed
               else solve_qp(H, g, G, hq, iters=ipm_iters))
        d = sol.x
        # the merit at z and at every step size, in one call of cost_fn
        zs = torch.cat([z] + [z + a * d for a in _ALPHAS])
        viol = violation(zs, h.repeat(k + 1, 1))
        merit = (cost_fn(zs) + rho * viol).reshape(k + 1, Bsz)
        m0, v0 = merit[0], viol[:Bsz]
        dir_deriv = exact_sum(g * d) - rho * v0
        oks = merit[1:] <= m0 + 1e-4 * alphas[:, None] * dir_deriv
        # the first accepted alpha; the smallest if none is accepted
        idx = torch.argmax(oks.to(z.dtype), dim=0)
        alpha = torch.where(oks.any(dim=0), alphas[idx], alphas[-1])
        z = z + alpha[:, None] * d
        norms.append(torch.linalg.vector_norm(d, dim=1))
        conv = sol.converged
    return SQPResult(z=z, cost=cost_fn(z), qp_converged=conv,
                     step_norms=torch.stack(norms, dim=1))


def _forward_jac(fn, z):
    """d fn / d z per lane by forward mode: one tangent e_k, shared by every
    lane, gives column k of every lane's Jacobian (the lanes are
    independent). fn (B, nz) -> (B, r); returns (B, r, nz)."""
    eye = torch.eye(z.shape[1], dtype=z.dtype, device=z.device)
    cols = torch.func.vmap(
        lambda t: torch.func.jvp(fn, (z,), (t.expand_as(z),))[1])(eye)
    return cols.permute(1, 2, 0)


def sqp_solve_nonlinear_constraints(
    cost_fn: Callable[[torch.Tensor], torch.Tensor],
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    cons_fn: Callable[[torch.Tensor], torch.Tensor],
    z0: torch.Tensor,
    iters: int = 5,
    ipm_iters: int = 30,
    rho: float = 1e4,
    reg: float = 1e-9,
    elastic_rows: int = 0,
    jac_fn: Callable | None = None,
    merit_fn: Callable | None = None,
    chol_failed: torch.Tensor | None = None,
) -> SQPResult:
    """Minimize cost_fn(z) = ||residual_fn(z)||^2 subject to cons_fn(z) <= 0
    (NMPC: the true-ODE rollout), per lane: z0 (B, nz).

    The constraints are linearized each iteration, c(z) + Jc d <= 0, and the
    merit is cost + rho * sum max(c, 0) (ref: constraintsNMPC.m evaluated by
    fmincon-SQP with finite differences; here Jc is exact). residual_fn(z)
    -> e (B, ne); cost_fn and cons_fn take a stack of k copies of the batch
    along the lanes (copy i holding lane j at row i B + j, as in sqp_solve)
    and return (k B,) and (k B, mc). The Jacobians come from jac_fn(z) ->
    (e, J (B, ne, nz), c (B, mc), Jc (B, mc, nz)) when the caller has them
    (the gradient is then 2 J'e), else from torch.func's forward mode (the
    reference's jacfwd; one pass per decision). merit_fn(zs) -> (cost, c),
    when given, evaluates both of the merit ladder's terms in one pass.
    chol_failed (B,) bool: passed to every QP (ops/ipm.solve_qp); with it
    and jac_fn the solve reads nothing from the device, so it can be
    captured in a CUDA graph. The products and sums take ops/lanes' exact
    forms, so a lane's bits do not depend on the batch's size (merit_fn's
    cost should sum with exact_sum too).

    elastic_rows=k puts the LAST k constraint rows in elastic mode (SNOPT
    style): each gets a slack s >= 0 with c + Jc d <= s and the linear
    penalty rho s in the QP objective,
        H_e = [[H, 0], [0, 1e-6 I]], g_e = [g; rho 1],
        G_e = [[Jc, -E], [0, -I]],  rhs = [-c; 0],
    the exact-penalty QP counterpart of the merit's hinge term, for rows
    whose linearization can be infeasible at intermediate iterates (a
    terminal ellipsoid the rollout cannot reach yet; ref:
    regular_NMPC_casadi.m's terminal constraint). Hard rows stay hard.
    """
    Bsz, nz = z0.shape
    dt, dev = z0.dtype, z0.device
    Ireg = reg * torch.eye(nz, dtype=dt, device=dev)
    k_a = len(_ALPHAS)
    # _ALPHAS = 2^-k, made on the device (no copy from the host)
    alphas = 0.5 ** torch.arange(k_a, dtype=dt, device=dev)
    qp_kw = dict(iters=ipm_iters, chol_failed=chol_failed)

    def merit_terms(zs):
        if merit_fn is not None:
            return merit_fn(zs)
        return cost_fn(zs), cons_fn(zs)

    z = z0
    norms = []
    conv = None
    cost = merit_terms(z)[0] if iters == 0 else None
    for _ in range(iters):
        if jac_fn is None:
            J = _forward_jac(residual_fn, z)
            g = torch.func.grad(lambda zz: cost_fn(zz).sum())(z)
            c = cons_fn(z)
            Jc = _forward_jac(cons_fn, z)
        else:
            e, J, c, Jc = jac_fn(z)
            g = 2.0 * exact_mv(J.transpose(1, 2), e)
        H = 2.0 * J.transpose(1, 2) @ J + Ireg
        if elastic_rows:
            k = elastic_rows
            mc = c.shape[1]
            # d_ext = [d; s]: min .. + rho 1's  s.t. [Jc -E] d_ext <= -c,
            # -s <= 0, where E selects the elastic rows
            Ik = torch.eye(k, dtype=dt, device=dev)
            E = torch.cat([torch.zeros(mc - k, k, dtype=dt, device=dev), Ik])
            zk = torch.zeros(Bsz, k, nz, dtype=dt, device=dev)
            H_e = torch.zeros(Bsz, nz + k, nz + k, dtype=dt, device=dev)
            H_e[:, :nz, :nz] = H
            H_e[:, nz:, nz:] = 1e-6 * Ik
            g_e = torch.cat([g, torch.full((Bsz, k), rho, dtype=dt, device=dev)], dim=1)
            G_e = torch.cat([torch.cat([Jc, -E.expand(Bsz, mc, k)], dim=2),
                             torch.cat([zk, -Ik.expand(Bsz, k, k)], dim=2)], dim=1)
            rhs = torch.cat([-c, torch.zeros(Bsz, k, dtype=dt, device=dev)], dim=1)
            sol = solve_qp(H_e, g_e, G_e, rhs, **qp_kw)
            d = sol.x[:, :nz]
        else:
            sol = solve_qp(H, g, Jc, -c, **qp_kw)
            d = sol.x
        # the merit at z and at every step size, in one pass
        zs = torch.cat([z] + [z + a * d for a in _ALPHAS])
        cost_s, c_s = merit_terms(zs)
        viol = exact_sum(torch.clamp(c_s, min=0.0))
        merit = (cost_s + rho * viol).reshape(k_a + 1, Bsz)
        m0 = merit[0]
        viol0 = exact_sum(torch.clamp(c, min=0.0))
        dir_deriv = exact_sum(g * d) - rho * viol0
        oks = merit[1:] <= m0 + 1e-4 * alphas[:, None] * dir_deriv
        idx = torch.argmax(oks.to(dt), dim=0)
        # if every alpha is rejected (e.g. a diverged QP direction: the
        # elastic/ellipsoid subproblems can fail far from feasibility), take
        # NO step instead of stepping blindly by the smallest alpha
        take = oks.any(dim=0)
        alpha = torch.where(take, alphas[idx], torch.zeros((), dtype=dt, device=dev))
        d = torch.where(torch.isfinite(d), d, 0.0)
        z = z + alpha[:, None] * d
        costs = cost_s.reshape(k_a + 1, Bsz)
        cost = torch.where(take, costs[1:].gather(0, idx[None])[0], costs[0])
        norms.append(torch.linalg.vector_norm(d, dim=1))
        conv = sol.converged
    return SQPResult(z=z, cost=cost, qp_converged=conv,
                     step_norms=torch.stack(norms, dim=1) if norms else z.new_zeros(Bsz, 0))
