"""SQP engine: a Gauss-Newton cost model and dense QP subproblems, batched.

Port of lbmpc_tpu/controllers/sqp.sqp_solve, the per-problem SQP behind
controllers/lbmpc.make_lbmpc_solver (the vmapped repair of the hybrid
solvers and the float64 parity path). In LBMPC only the cost is nonconvex
(the learned rollout); the constraints G z <= h stay affine, so each SQP
iteration is one dense convex QP (ops/ipm). The reference vmaps one problem;
here the lanes are the leading axis of z, h and of what cost_fn and
residual_fn return. Fixed iteration counts and the fixed ladder of step
sizes (1, 1/2, 1/4, 1/8, 1/16) on an l1 merit keep every lane in step; a
lane where no step size passes the Armijo test takes the smallest one, as
in the reference (the fused solver's ladder takes no step instead).

The NMPC variant (sqp_solve_nonlinear_constraints) is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from lbmpc_tpu_torch.ops.ipm import solve_qp, solve_qp_mixed
from lbmpc_tpu_torch.ops.lanes import lane_sum


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
    refinement)."""
    Bsz, nz = z0.shape
    Ireg = reg * torch.eye(nz, dtype=z0.dtype, device=z0.device)
    alphas = torch.tensor(_ALPHAS, dtype=z0.dtype, device=z0.device)
    k = len(_ALPHAS)

    def gz(zs):
        return zs @ G.T if G.ndim == 2 else (G.repeat(zs.shape[0] // Bsz, 1, 1)
                                             @ zs[..., None])[..., 0]

    def violation(zs, hs):
        return lane_sum(torch.clamp(gz(zs) - hs, min=0.0))

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
            g = 2.0 * (J.transpose(1, 2) @ e[..., None])[..., 0]
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
        dir_deriv = (g * d).sum(dim=1) - rho * v0
        oks = merit[1:] <= m0 + 1e-4 * alphas[:, None] * dir_deriv
        # the first accepted alpha; the smallest if none is accepted
        idx = torch.argmax(oks.to(z.dtype), dim=0)
        alpha = torch.where(oks.any(dim=0), alphas[idx], alphas[-1])
        z = z + alpha[:, None] * d
        norms.append(torch.linalg.vector_norm(d, dim=1))
        conv = sol.converged
    return SQPResult(z=z, cost=cost_fn(z), qp_converged=conv,
                     step_norms=torch.stack(norms, dim=1))
