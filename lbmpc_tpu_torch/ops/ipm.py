"""Batched dense Mehrotra predictor-corrector interior-point method (QP/LP).

Port of lbmpc_tpu/ops/ipm.py, the per-problem IPM behind the LMPC solver,
the vmapped SQP (controllers/sqp.py) and the float64 parity path:

    min_x  1/2 x'Hx + g'x   s.t.   G x <= h

The reference writes one problem and batches it with `vmap`; here every
function takes a batch on the leading axis — g (B, n), h (B, m), H (n, n) or
(B, n, n), G (m, n) or (B, m, n) — because the host pays per operation, not
per lane. A single problem (g of shape (n,)) is a batch of one. Each lane
keeps the reference's semantics:
  - a fixed iteration count with a freeze mask: a lane that meets the
    stopping test keeps its iterate, and `iters` records the iteration at
    which it first froze (`iters` = the budget when it never did);
  - dtype-aware guards: tiny = finfo.tiny * 1e8, d = z / s capped at 1e7 in
    float32 and 1e30 in float64;
  - the per-lane diagonal regularization reg = 1e-12 (1 + tr M / n) of the
    normal matrix M = H + G' diag(z / s) G before its Cholesky factor
    (ops/chol.py);
  - the final `converged` flag and the Farkas certificate of primal
    infeasibility (`infeasible`, `farkas_gap`).
solve_qp_batched takes a G per lane, and support_function(_batched) is the
polytope support function h_P(c) = max c'x s.t. Fx <= h as an LP on this
solver, a direction a lane. Plain PyTorch: no kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lbmpc_tpu_torch.ops.chol import chol_batched, solve_tri_lower, solve_tri_upper_t
from lbmpc_tpu_torch.ops.lanes import exact_mv, exact_sum, lane_gemm, lane_mm, on_min_lanes


class IPMSolution(NamedTuple):
    x: torch.Tensor           # primal solution (B, n)
    z: torch.Tensor           # dual multipliers for G x <= h (B, m)
    s: torch.Tensor           # slacks (B, m)
    mu: torch.Tensor          # final complementarity measure (B,)
    primal_res: torch.Tensor  # final ||Gx + s - h||_inf (B,)
    dual_res: torch.Tensor    # final ||Hx + g + G'z||_inf (B,)
    converged: torch.Tensor   # (B,) bool
    iters: torch.Tensor       # (B,) iteration at which the freeze mask first hit
    infeasible: torch.Tensor  # (B,) bool: Farkas certificate of primal infeasibility
    farkas_gap: torch.Tensor  # (B,) -h'y for the normalized candidate ray y


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A v for a shared (r, c) or batched (B, r, c) A and v (B, c)."""
    return exact_mv(A, v) if A.ndim == 3 else lane_mm(v, A)


def _mtv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A' v for a shared (r, c) or batched (B, r, c) A and v (B, r)."""
    return _mv(A.transpose(-1, -2), v)


def _step_length(v: torch.Tensor, dv: torch.Tensor, tau: float) -> torch.Tensor:
    """Largest alpha in (0, 1] with v + alpha dv >= 0, scaled by tau (B,)."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -1.0), torch.inf)
    return torch.clamp(tau * ratio.amin(dim=-1), max=1.0)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return exact_sum(a * b)


def _amax_abs(a: torch.Tensor) -> torch.Tensor:
    return a.abs().amax(dim=-1)


def solve_qp(H, g, G, h, iters: int = 30, tol: float = 1e-10,
             tau: float = 0.995, chol_failed: torch.Tensor | None = None) -> IPMSolution:
    """Solve min 1/2 x'Hx + g'x s.t. Gx <= h by Mehrotra predictor-corrector,
    from the cold start x = 0, s = max(h - G x, 1), z = 1. H may be zero (LP).
    Float32 matrix products run in full float32 (the package turns TF32 off),
    as the reference runs them at HIGHEST. chol_failed (B,) bool: see
    ops/chol.chol_batched (no device read; the caller checks the flags).
    Every product and sum takes a form of ops/lanes (lane_mm with a shared
    matrix, exact_mv with one per lane, exact_sum), so a lane's bits do not
    depend on the batch's size or the lane's place in it, in either dtype,
    on the card from ops/lanes.MIN_LANES lanes up (the solvers pad to it:
    on_min_lanes)."""
    return _solve(H, g, G, h, iters, tol, tau, None, chol_failed)


def solve_qp_warm(H, g, G, h, init: tuple, iters: int = 5, tol: float = 1e-10,
                  tau: float = 0.995) -> IPMSolution:
    """Continue the IPM from a given (x, s, z) interior point (the mixed
    path's float64 stage)."""
    return _solve(H, g, G, h, iters, tol, tau, init)


def solve_qp_mixed(H, g, G, h, f32_iters: int = 18,
                   f64_iters: int = 5) -> IPMSolution:
    """A float32 IPM, then a float64 warm-started refinement from its iterate
    re-centred off the boundary (s, z >= 1e-8). H, g, G, h are float64."""
    f32, f64 = torch.float32, torch.float64
    sol32 = solve_qp(H.to(f32), g.to(f32), G.to(f32), h.to(f32), iters=f32_iters)
    s0 = torch.clamp(sol32.s.to(f64), min=1e-8)
    z0 = torch.clamp(sol32.z.to(f64), min=1e-8)
    return solve_qp_warm(H, g, G, h, (sol32.x.to(f64), s0, z0), iters=f64_iters)


def _solve(H, g, G, h, iters, tol, tau, init, chol_failed=None) -> IPMSolution:
    if g.ndim == 1:
        sol = _solve(H, g[None], G, h[None], iters, tol, tau,
                     None if init is None else tuple(a[None] for a in init),
                     None if chol_failed is None else chol_failed[None])
        return IPMSolution(*(f[0] for f in sol))
    dtype, dev = g.dtype, g.device
    Bsz, n = g.shape
    m = h.shape[-1]
    In = torch.eye(n, dtype=dtype, device=dev)
    finfo = torch.finfo(dtype)
    tiny = float(finfo.tiny) * 1e8
    d_cap = 1e30 if dtype == torch.float64 else 1e7
    tol_eff = max(tol, 30.0 * float(finfo.eps))

    if init is None:
        x = torch.zeros(Bsz, n, dtype=dtype, device=dev)
        s = torch.clamp(h - _mv(G, x), min=1.0)
        z = torch.ones(Bsz, m, dtype=dtype, device=dev)
    else:
        x, s, z = (a.to(dtype) for a in init)

    h_scale = 1.0 + _amax_abs(h)
    g_scale = 1.0 + _amax_abs(g)
    Gt = G.transpose(-1, -2)
    frozen = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    first_it = torch.full((Bsz,), iters, dtype=torch.int64, device=dev)
    for i in range(iters):
        rd = _mv(H, x) + g + _mtv(G, z)
        rp = _mv(G, x) + s - h
        s_safe = torch.clamp(s, min=tiny)
        d = torch.clamp(z / s_safe, max=d_cap)
        GtD = Gt * d[:, None, :]
        M = H + (lane_gemm(GtD, Gt) if G.ndim == 2 else GtD @ G)
        # tiny diagonal regularization keeps the factorization alive for
        # rank-deficient LP normal matrices late in the solve
        reg = 1e-12 * (1.0 + M.diagonal(dim1=-2, dim2=-1).sum(dim=-1) / n)
        L = chol_batched(M + reg[:, None, None] * In, chol_failed)

        def kkt_solve(rc):
            rhs = -(rd + _mtv(G, d * rp) - _mtv(G, rc / s_safe))
            dx = solve_tri_upper_t(L, solve_tri_lower(L, rhs))
            Gdx = _mv(G, dx)
            return dx, -rp - Gdx, d * (rp + Gdx) - rc / s_safe

        mu = _dot(s, z) / m
        # predictor
        dx_a, ds_a, dz_a = kkt_solve(s * z)
        a_p = _step_length(s, ds_a, 1.0)
        a_d = _step_length(z, dz_a, 1.0)
        mu_aff = _dot(s + a_p[:, None] * ds_a, z + a_d[:, None] * dz_a) / m
        sigma = (mu_aff / torch.clamp(mu, min=tiny)) ** 3
        # corrector
        rc = s * z + ds_a * dz_a - (sigma * mu)[:, None]
        dx, ds, dz = kkt_solve(rc)
        a_p = _step_length(s, ds, tau)[:, None]
        a_d = _step_length(z, dz, tau)[:, None]

        done = ((mu < tol_eff * (1.0 + _dot(s, z).abs()))
                & (_amax_abs(rp) < tol_eff * h_scale * 1e2)
                & (_amax_abs(rd) < tol_eff * g_scale * 1e2))
        first_it = torch.where(done & ~frozen, i, first_it)
        keep = frozen[:, None]
        x = torch.where(keep, x, x + a_p * dx)
        s = torch.where(keep, s, s + a_p * ds)
        z = torch.where(keep, z, z + a_d * dz)
        frozen = frozen | done

    rd = _mv(H, x) + g + _mtv(G, z)
    rp = _mv(G, x) + s - h
    sz = _dot(s, z)
    mu = sz / m
    conv_tol = 1e-7 if dtype == torch.float64 else 2e-4
    converged = (mu < conv_tol * (1.0 + sz.abs())) & (_amax_abs(rp) < conv_tol * h_scale)
    # Farkas certificate of primal infeasibility: y >= 0, G'y = 0, h'y < 0
    # proves {x : Gx <= h} empty. The duals blow up along such a ray with
    # uneven magnitudes, so project the normalized duals onto null(G'),
    # clip to >= 0, and test the conditions on the result.
    cert_tol = 1e-6 if dtype == torch.float64 else 1e-3
    y = z / torch.clamp(_amax_abs(z), min=tiny)[:, None]
    Gmax = G.abs().amax(dim=(-2, -1))
    GtG = Gt @ G + (1e-12 * (1.0 + Gmax ** 2))[..., None, None] * In
    # GtG is SPD by its ridge: a Cholesky solve, which reads nothing from the
    # device when chol_failed is given (a general solve checks its pivots on
    # the host); for a shared G, its one inverse (two triangular solves on
    # the identity), applied as lane_mm: the two solves on the lanes'
    # right-hand sides take a path picked by B
    Lg = chol_batched(GtG, chol_failed)
    Gty = _mtv(G, y)
    if G.ndim == 2:
        Li = torch.linalg.solve_triangular(Lg, In, upper=False)
        proj = lane_mm(Gty, torch.linalg.solve_triangular(Lg.mT, Li, upper=True))
    else:
        proj = solve_tri_upper_t(Lg, solve_tri_lower(Lg, Gty))
    y = torch.clamp(y - _mv(G, proj), min=0.0)
    ynorm = _amax_abs(y)
    y = y / torch.clamp(ynorm, min=tiny)[:, None]
    farkas_gap = -_dot(h, y)
    infeasible = (~converged & (ynorm > 0.1) & (farkas_gap > cert_tol * h_scale)
                  & (_amax_abs(_mtv(G, y)) < cert_tol * (1.0 + Gmax)))
    return IPMSolution(x=x, z=z, s=s, mu=mu, primal_res=_amax_abs(rp),
                       dual_res=_amax_abs(rd), converged=converged, iters=first_it,
                       infeasible=infeasible, farkas_gap=farkas_gap)


def solve_qp_batched(H, g, G, h, **kw) -> IPMSolution:
    """solve_qp with a problem a lane: H (B, n, n), g (B, n), G (B, m, n),
    h (B, m); kw as solve_qp's. The reference vmaps solve_qp over the four;
    solve_qp takes a G per lane as it is."""
    return solve_qp(H, g, G, h, **kw)


def support_function(c, F, h, iters: int = 40) -> torch.Tensor:
    """h_P(c) = max_x c'x s.t. Fx <= h, the polytope's support function in
    direction c (n,): an LP (H = 0, g = -c) on solve_qp, on c's device."""
    return support_function_batched(c[None], F, h, iters=iters)[0]


def support_function_batched(C, F, h, iters: int = 40) -> torch.Tensor:
    """support_function for k directions C (k, n) over one polytope Fx <= h:
    one solve of k lanes with the shared F, each lane's bits the same at
    any k (ops/lanes' forms, on at least MIN_LANES lanes on the card).
    Returns (k,)."""
    n = C.shape[-1]
    H = torch.zeros(n, n, dtype=C.dtype, device=C.device)
    F, h = F.to(C), h.to(C)

    def lanes(C_):
        sol = solve_qp(H, -C_, F, h.expand(C_.shape[0], -1), iters=iters)
        return exact_sum(C_ * sol.x)

    return on_min_lanes(lanes, C)
