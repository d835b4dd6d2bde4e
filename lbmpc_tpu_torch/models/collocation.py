"""Orthogonal collocation: degree-d Legendre collocation over one step.

Port of lbmpc_tpu/models/collocation.py, batched over lanes. The reference's
fourth transcription scheme (ref: examples/collocation_regular_NMPC_test.m:
11-46 builds the C/D/B coefficient matrices for degree-3 Legendre collocation
and lifts the collocation states into the NLP). Here, as in the reference
package, the same coefficients drive an implicit collocation *integrator*:
the per-step collocation equations are solved by a fixed number of Newton
iterations, so the step serves both as a plant-accurate integrator and as the
prediction model of an NMPC, which differentiates through those iterations.

Coefficient construction follows the Lagrange-polynomial recipe: for
collocation points 0 = tau_0 < tau_1 < ... < tau_d,
  C[j, r] = dL_j/dt (tau_r)   (derivative of basis j at point r)
  D[j]    = L_j(1)            (end-of-interval extrapolation)
  B[j]    = int_0^1 L_j       (quadrature weights)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lbmpc_tpu_torch.config import BETA2
from lbmpc_tpu_torch.models.mgcm import mgcm_ode, mgcm_ode_jac


@functools.lru_cache(maxsize=None)
def legendre_coeffs(d: int = 3):
    """Collocation coefficient matrices (C, D, B) for Gauss-Legendre points.

    Returns C (d+1, d+1), D (d+1,), B (d+1,) as float64 numpy arrays.
    Ref: collocation_regular_NMPC_test.m:11-46 (the same construction via
    CasADi's collocation_points; here the shifted-Legendre roots come from
    numpy).
    """
    # shifted Gauss-Legendre points on (0, 1]
    pts, _ = np.polynomial.legendre.leggauss(d)
    tau = np.concatenate([[0.0], (pts + 1.0) / 2.0])
    C = np.zeros((d + 1, d + 1))
    D = np.zeros(d + 1)
    B = np.zeros(d + 1)
    for j in range(d + 1):
        # Lagrange basis polynomial j
        p = np.poly1d([1.0])
        for r in range(d + 1):
            if r != j:
                p *= np.poly1d([1.0, -tau[r]]) / (tau[j] - tau[r])
        D[j] = p(1.0)
        dp = np.polyder(p)
        for r in range(d + 1):
            C[j, r] = dp(tau[r])
        B[j] = np.polyint(p)(1.0)
    return C, D, B


def _jac_x(ode, X, u):
    """d f / d x at the collocation states X (B, d, n), u (B,): (B, d, n, n)."""
    n = X.shape[-1]
    if ode is mgcm_ode:
        return mgcm_ode_jac(X)[..., :n]
    uu = u[:, None].expand(X.shape[:-1]).reshape(-1)
    J = torch.func.vmap(torch.func.jacfwd(ode))(X.reshape(-1, n), uu)
    return J.reshape(X.shape + (n,))


def _parts(x, d, dt):
    return _coeff_tensors(d, x.shape[-1], x.dtype, x.device)


@functools.lru_cache(maxsize=None)
def _coeff_tensors(d, n, dtype, device):
    """C[:, 1:], D and the Newton matrix's constant part as tensors, made
    once (a CUDA graph may not copy them from the host while it captures).
    Row block r, column block j of the constant part hold C[j+1, r+1] I_n
    (the -dt Jf(X_r) diagonal blocks vary)."""
    C, D, _ = legendre_coeffs(d)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(C[:, 1:]), t(D), t(np.kron(C[1:, 1:].T, np.eye(n)))


def _newton_matrix(Ck, Jf, dt):
    """Ck - dt blockdiag(Jf(X_1), ..., Jf(X_d)): Jf (B, d, n, n)."""
    Bsz, d, n, _ = Jf.shape
    blocks = torch.diag_embed(Jf.permute(0, 2, 3, 1)).permute(0, 3, 1, 4, 2)
    return Ck - dt * blocks.reshape(Bsz, d * n, d * n)


def _solve(M, r):
    """M^-1 r by LU, without the pivot check that reads the device (so a
    solve can be captured in a CUDA graph); a singular Newton matrix gives
    non-finite steps, as the reference's does."""
    return torch.linalg.solve_ex(M, r, check_errors=False)[0]


def _input(u):
    return u[..., 0] if u.ndim == 2 else u


def collocation_step(x: torch.Tensor, u: torch.Tensor, dt: float, degree: int = 3,
                     newton_iters: int = 3, ode=mgcm_ode) -> torch.Tensor:
    """One implicit collocation step of x' = f(x, u) over dt, per lane:
    x (B, n), u (B,) or (B, 1) -> x+ (B, n).

    Solves the collocation equations
        sum_j C[j, r] X_j = dt * f(X_r, u),   r = 1..d,   X_0 = x
    for X_1..X_d by Newton's method (a fixed number of iterations, the exact
    Jacobian of the residual stack: closed form for the MGCM, jacfwd for
    another ode), then extrapolates x+ = sum_j D_j X_j. A-stable: it handles
    the stiff throttle mode at large dt where RK4 diverges.
    """
    u = _input(u)
    Bsz, n = x.shape
    d = degree
    Cr, Dj, Ck = _parts(x, d, dt)
    Xc = x[:, None, :].expand(Bsz, d, n)
    for _ in range(newton_iters):
        Xall = torch.cat([x[:, None, :], Xc], dim=1)                 # (B, d+1, n)
        r = torch.einsum("jr,bjn->brn", Cr, Xall) - dt * ode(Xc, u[:, None])
        M = _newton_matrix(Ck, _jac_x(ode, Xc, u), dt)
        step = _solve(M, r.reshape(Bsz, d * n))
        Xc = Xc - step.reshape(Bsz, d, n)
    Xall = torch.cat([x[:, None, :], Xc], dim=1)
    return torch.einsum("j,bjn->bn", Dj, Xall)


def collocation_step_tangent(x: torch.Tensor, Tx: torch.Tensor, u: torch.Tensor,
                             Tu: torch.Tensor, dt: float, degree: int = 3,
                             newton_iters: int = 3):
    """collocation_step of the MGCM with its forward derivatives: x (B, n),
    u (B,), and K tangents Tx (B, K, n), Tu (B, K). Returns (x+ (B, n),
    Tx+ (B, K, n)), the derivative taken through the fixed Newton
    iterations as jacfwd takes it through the reference's: each step
    s = M^-1 r moves its tangent by M^-1 (r' - M' s), M' the derivative of
    the Newton matrix along the tangent (the second derivatives of the
    ODE's two nonlinear terms)."""
    Bsz, n = x.shape
    K = Tx.shape[1]
    d = degree
    Cr, Dj, Ck = _parts(x, d, dt)
    Xc = x[:, None, :].expand(Bsz, d, n)
    TX = Tx[:, :, None, :].expand(Bsz, K, d, n)
    for _ in range(newton_iters):
        Xall = torch.cat([x[:, None, :], Xc], dim=1)
        TXall = torch.cat([Tx[:, :, None, :], TX], dim=2)           # (B, K, d+1, n)
        r = torch.einsum("jr,bjn->brn", Cr, Xall) - dt * mgcm_ode(Xc, u[:, None])
        Jfu = mgcm_ode_jac(Xc)                                       # (B, d, n, n+1)
        Jf = Jfu[..., :n]
        dr = (torch.einsum("jr,bkjn->bkrn", Cr, TXall)
              - dt * (torch.einsum("brac,bkrc->bkra", Jf, TX)
                      + Jfu[:, None, :, :, n] * Tu[:, :, None, None]))
        M = _newton_matrix(Ck, Jf, dt)
        s = _solve(M, r.reshape(Bsz, d * n)).reshape(Bsz, d, n)
        # M' s = -dt dJf(X_r)[TX_r] s_r: only f1's x1^3 and f2's x3 sqrt(x2)
        # have second derivatives
        x1, x2, x3 = Xc[..., 0][:, None], Xc[..., 1][:, None], Xc[..., 2][:, None]
        rt = torch.sqrt(x2)
        da = -3.0 * x1 * TX[..., 0]
        db = (-TX[..., 2] / (2.0 * rt) + x3 * TX[..., 1] / (4.0 * x2 * rt)) / BETA2
        dc = -TX[..., 1] / (2.0 * rt) / BETA2
        row0 = da * s[:, None, :, 0]
        row1 = db * s[:, None, :, 1] + dc * s[:, None, :, 2]
        Ms = -dt * torch.stack([row0, row1, torch.zeros_like(row0),
                                torch.zeros_like(row0)], dim=-1)     # (B, K, d, n)
        rhs = (dr - Ms).reshape(Bsz, K, d * n).transpose(1, 2)
        ds = _solve(M, rhs).transpose(1, 2).reshape(Bsz, K, d, n)
        Xc = Xc - s
        TX = TX - ds
    Xall = torch.cat([x[:, None, :], Xc], dim=1)
    TXall = torch.cat([Tx[:, :, None, :], TX], dim=2)
    return (torch.einsum("j,bjn->bn", Dj, Xall),
            torch.einsum("j,bkjn->bkn", Dj, TXall))
