"""Nonlinear MPC: the true-ODE rollout in the cost AND the constraints, by SQP.

Port of lbmpc_tpu/controllers/nmpc.py, batched over lanes. Ref:
functions/costNMPC.m + constraintsNMPC.m (fmincon family) and
examples/DMS_tracking_NMPC_casadi.m (casadi family). The prediction model is
the true MGCM ODE integrated with substepped RK4 (the plant itself may use
adaptive RK23: SURVEY.md §7.4.4), or degree-d Legendre collocation (ref:
collocation_regular_NMPC_test.m:129-159; the implicit collocation equations
are solved inside the prediction step and the SQP differentiates through
the fixed Newton iterations, so the decision vector is the same for every
transcription), or the nominal DLTI (the regulation LMPC of
regular_LMPC_casadi.m).

Regulation variants (ref: regular_NMPC_casadi.m / regular_LMPC_casadi.m):
regulation to the equilibrium with theta pinned at 0, the hard-coded
terminal cost P (regular_NMPC_casadi.m:48-53), and the ellipsoidal terminal
region (x-x_eq)' P (x-x_eq) <= alpha (alpha=0.7, regular_NMPC_casadi.m:
231-233) as one elastic nonlinear-constraint row.

The SQP (controllers/sqp.sqp_solve_nonlinear_constraints) needs the
Jacobians of the residual and constraint stacks in z every iteration. They
come from one forward pass that carries the value and the nz tangents of
the rollout together: every state of the rollout is
a (B, 1 + nz, 6) tensor, row 0 the value [x, u, 1] and row 1 + k its
derivative in z_k [dx/dz_k, du/dz_k, 0]. The ODE's linear part acts on all
rows in one matrix product; its two nonlinear terms (x1^3 and x3 sqrt(x2))
take their derivatives from the value row. So a tangent pass costs the
host about as many operations as a plain rollout, which the host's dispatch
of small operations bounds. The residuals and constraints are affine in the
rollout (the ellipsoid row aside), so their tangents are the same maps
without their constants. On the card this pass is 19-35x faster than
torch.func's forward or reverse mode over the plain rollout
(tools/nmpc_jacobian_modes.py, which times the three).
"""

from __future__ import annotations

import numpy as np
import torch

from lbmpc_tpu_torch.config import BETA2, TWO_ZETA_WN, WN2, X2_C
from lbmpc_tpu_torch.controllers.lbmpc import LBMPCWeights
from lbmpc_tpu_torch.controllers.sqp import sqp_solve_nonlinear_constraints
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.models.collocation import (collocation_step,
                                                collocation_step_tangent)
from lbmpc_tpu_torch.ops.lanes import exact_sum, on_min_lanes
from lbmpc_tpu_torch.sets.terminal import ConstraintSet

# mgcm_ode's linear part on the columns [x1, x2, x3, x4, u, 1] (rows 4 and 5
# zero: u and the constant do not move within a sample period)
_ODE_LINEAR = np.zeros((6, 6))
_ODE_LINEAR[0, [0, 1, 5]] = (1.5, -1.0, X2_C + 1.0)
_ODE_LINEAR[1, [0, 5]] = (1.0 / BETA2, 1.0 / BETA2)
_ODE_LINEAR[2, 3] = 1.0
_ODE_LINEAR[3, [2, 3, 4]] = (-WN2, -TWO_ZETA_WN, WN2)


def _prod(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """x @ W for a small W (K, M) as products and a sum of K terms per
    entry: cuBLAS picks a matrix product's kernel by the rows it is given,
    so with the batch in the rows a lane would round apart between batch
    sizes (on the card, the residuals' products with Lq at 2 lanes and at
    1024)."""
    return (x[..., None, :] * W.T).sum(dim=-1)


def _ode_dual(S, lin_t, w_cube, w_root, w_quot):
    """mgcm_ode on the value row of S (B, R, 6) and its derivative on the
    tangent rows: (B, R, 6), the last two columns 0."""
    F = _prod(S, lin_t)
    x1, x2, x3 = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    # -x1^3 / 2 on the value row, -3/2 x1^2 dx1 on the tangent rows
    F[..., 0].addcmul_((x1 * x1)[:, None] * w_cube, S[..., 0])
    # -x3 sqrt(x2) on the value row, -(sqrt(x2) dx3 + x3 / (2 sqrt(x2)) dx2)
    # on the tangent rows
    r = torch.sqrt(x2)
    F[..., 1].addcmul_((r * w_root)[:, None], S[..., 2])
    F[..., 1].addcmul_((x3 / r)[:, None] * w_quot, S[..., 1])
    return F


class _Graphed:
    """A function of CUDA tensors, captured in a CUDA graph at its first call
    for each input shape and replayed after: the NMPC solve issues ~10^5
    small operations, which the host's dispatch would otherwise bound. fn
    returns (outputs, failed); when a replay marks a lane in `failed` (a
    factorization the library gave up on, which the graph cannot branch
    on), the call runs `fallback` instead, the solve without the graph.
    Batches larger than max_lanes run `fallback` too (the library's batched
    LU checks its pivots on the host, which no graph may capture)."""

    def __init__(self, fn, fallback, max_lanes=None):
        self.fn, self.fallback, self.graphs = fn, fallback, {}
        self.max_lanes = max_lanes
        self.replays = self.fallbacks = 0

    def _capture(self, args):
        static = [a.clone() for a in args]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*static)                       # warm-up: cuBLAS/cuSOLVER handles
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # captured on its own stream: cuBLAS keeps one workspace per (handle,
        # stream), so graphs captured on one stream would share it and race
        # when replayed at once on different streams
        with torch.cuda.graph(graph, stream=side):
            out = self.fn(*static)
        return graph, static, out

    def __call__(self, *args):
        if self.max_lanes is not None and args[0].shape[0] > self.max_lanes:
            return self.fallback(*args)
        key = tuple((a.shape, a.dtype) for a in args)
        if key not in self.graphs:
            self.graphs[key] = self._capture(args)
        graph, static, (out, failed) = self.graphs[key]
        for s, a in zip(static, args):
            s.copy_(a)
        graph.replay()
        if bool(failed.any()):
            self.fallbacks += 1
            return self.fallback(*args)
        self.replays += 1
        return tuple(o.clone() for o in out)


def make_nmpc_solver(
    cs: ConstraintSet,
    Ks: np.ndarray,
    w: LBMPCWeights,
    N: int,
    ts: float,
    x_wp: np.ndarray,
    u_wp: float,
    family: str = "fmincon",
    pred_substeps: int = 4,
    dx_ref: np.ndarray | None = None,
    sqp_iters: int = 4,
    ipm_iters: int = 30,
    dtype=torch.float64,
    prediction: str = "rk4",
    colloc_degree: int = 3,
    colloc_newton_iters: int = 3,
    AB: tuple | None = None,
    regulation: bool = False,
    P_term: np.ndarray | None = None,
    ellipsoid_alpha: float | None = None,
    device=None,
):
    """Returns solve(dx0 (B, n), window, z_ws (B, nz)) -> (z (B, nz),
    converged (B,)); the window is not used.

    fmincon family: z = [c_0..c_{N-1}; theta], u_k = Ks(x_k - x_wp) + c_k +
    u_wp (ref: transitionTrue.m:11); the cost stage quirk of costNMPC.m
    (running stages 0..N-3 in delta coordinates, terminal on dx_N); the
    constraints of constraintsNMPC.m (states dx_1..dx_{N-1}, inputs
    du_0..du_{N-2}, terminal set on [dx_{N-1}; theta]).
    casadi family: z = [du_0..du_{N-1}; theta] direct, delta-scaled stages
    0..N-1, terminal on dx_N and the terminal set on [dx_N; theta] (ref:
    DMS_tracking_NMPC_casadi.m:271-286).

    prediction: "rk4" (RK4 of the true ODE with pred_substeps substeps),
    "collocation" (implicit degree-d Legendre collocation,
    models/collocation.py), or "dlti" (the nominal A, B of `AB`, delta
    coordinates around the working point; the regulation LMPC's model).

    regulation=True pins theta at 0 (its z slots stay for the layout but
    influence nothing and keep their warm-start value), drops the
    artificial-reference T row and the polytopic terminal set, uses P_term
    for the terminal cost, and, when ellipsoid_alpha is given, adds the
    terminal region dx_N' P_term dx_N <= alpha as one elastic nonlinear
    row, dimensionless (x'Px/alpha - 1).

    The Jacobians come from the tangent pass (see the module docstring). On
    the card (collocation for one lane) each batch size's solve is captured
    in a CUDA graph at its first call and replayed after.
    """
    dev = resolve_device(device)
    n = cs.F_x.shape[1]
    m = cs.F_u.shape[1]
    nth = w.LAMBDA.shape[1]
    nz = N * m + nth
    if m != 1 or n != 4:
        raise ValueError("the NMPC predicts the 4-state, 1-input MGCM")
    if prediction not in ("rk4", "collocation", "dlti"):
        raise ValueError(f"prediction={prediction!r}")
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    Ks_t = t(np.atleast_2d(Ks))[0]                     # (n,)
    x_wpt = t(x_wp)
    u_wpf = float(np.atleast_1d(u_wp)[0])
    Lq, Lr = t(w.Lq), t(w.Lr)
    LAM, PSI = t(w.LAMBDA), t(w.PSI)
    F_x, h_x = t(cs.F_x), t(cs.h_x)
    F_u, h_u = t(cs.F_u), t(cs.h_u)
    Fw_x, Fw_th, h_wN = t(cs.F_w_N[:, :n]), t(cs.F_w_N[:, n:]), t(cs.h_w_N)
    xs_ref = torch.zeros(n, dtype=dtype, device=dev) if dx_ref is None else t(dx_ref)
    sq_delta = float(np.sqrt(ts))
    if regulation:
        P = np.asarray(P_term if P_term is not None else w.Lp.T @ w.Lp, float)
        Lp = t(np.linalg.cholesky(P).T)
        P_ell = t(P)
    else:
        Lp = t(w.Lp)
    if regulation and ellipsoid_alpha is not None:
        elastic = 1
    else:
        elastic = 0
    lin_t = t(_ODE_LINEAR.T)
    if prediction == "dlti":
        A_d, B_d = np.asarray(AB[0], float), np.asarray(AB[1], float)
        xw = np.asarray(x_wp, float)
        W = np.zeros((6, n))
        W[:n] = A_d.T
        W[n] = B_d[:, 0]
        W[n + 1] = xw - A_d @ xw - B_d[:, 0] * u_wpf
        dlti_t = t(W)
    h = ts / pred_substeps

    def weights(R):
        """The per-row factors of _ode_dual's nonlinear terms."""
        w_cube = t([-0.5] + [-1.5] * (R - 1))
        w_quot = t([0.0] + [-0.5 / BETA2] * (R - 1))
        return w_cube, -1.0 / BETA2, w_quot

    # made here, not inside a captured solve
    wts_by_rows = {1: weights(1), 1 + nz: weights(1 + nz)}
    firsts = {R: t(np.eye(R, 1)) for R in wts_by_rows}

    def integrate(S, wts):
        """One sample period of the prediction on S (B, R, 6): the next
        state's value and tangents (B, R, n)."""
        if prediction == "dlti":
            return _prod(S, dlti_t)
        if prediction == "collocation":
            x, u = S[:, 0, :n], S[:, 0, n]
            if S.shape[1] == 1:
                return collocation_step(x, u, ts, degree=colloc_degree,
                                        newton_iters=colloc_newton_iters)[:, None]
            x1, Tx1 = collocation_step_tangent(
                x, S[:, 1:, :n], u, S[:, 1:, n], ts, degree=colloc_degree,
                newton_iters=colloc_newton_iters)
            return torch.cat([x1[:, None], Tx1], dim=1)
        f = lambda s: _ode_dual(s, lin_t, *wts)
        for _ in range(pred_substeps):
            k1 = f(S)
            k2 = f(torch.add(S, k1, alpha=h / 2.0))
            k3 = f(torch.add(S, k2, alpha=h / 2.0))
            k4 = f(torch.add(S, k3, alpha=h))
            # k1 + 2 k2 + 2 k3 + k4, summed in that order
            k = torch.add(torch.add(torch.add(k1, k2, alpha=2.0), k3, alpha=2.0), k4)
            S = torch.add(S, k, alpha=h / 6.0)
        return S[..., :n]

    def rollout(z, dx0, tangents: bool):
        """The prediction from dx0 under z: dxs (B, N, R, n) (dx_0..dx_{N-1}),
        dus (B, N, R) and dxN (B, R, n), R = 1 + nz rows with the tangents,
        1 without."""
        Bsz = z.shape[0]
        R = 1 + nz if tangents else 1
        wts, first = wts_by_rows[R], firsts[R]
        xwp_row = first * x_wpt
        X = (x_wpt + dx0)[:, None, :]
        # c_k on the value row and, on row 1 + k, its derivative 1 (built
        # without writing z into a buffer, which torch.func's modes refuse)
        crow = z[:, :N, None]
        if tangents:
            eye = torch.eye(N, nz, dtype=dtype, device=dev)
            crow = torch.cat([crow, eye.expand(Bsz, N, nz)], dim=2)
            X = torch.cat([X, torch.zeros(Bsz, nz, n, dtype=dtype, device=dev)], dim=1)
        dxs, dus = [], []
        for k in range(N):
            dX = X - xwp_row
            dU = crow[:, k] + (_prod(dX, Ks_t[:, None])[..., 0] if family == "fmincon"
                                else 0.0)
            S = torch.cat([X, (dU + u_wpf * first[:, 0])[..., None],
                           first.expand(Bsz, R, 1)], dim=2)
            X = integrate(S, wts)
            dxs.append(dX)
            dus.append(dU)
        return torch.stack(dxs, dim=1), torch.stack(dus, dim=1), X - xwp_row

    def residuals(dxs, dus, dxN, theta, lin: bool = False):
        """The residual stack on leading axes (..., ): dxs (..., N, n),
        dus (..., N), dxN (..., n), theta (..., nth) -> (..., ne). lin drops
        the constant terms (the map's derivative)."""
        dus = dus[..., None]
        if regulation:
            xa = ua = 0.0
        else:
            xa = _prod(theta, LAM.T)[..., None, :]
            ua = _prod(theta, PSI.T)[..., None, :]
        if family == "fmincon":
            rx = _prod(dxs[..., : N - 2, :] - xa, Lq.T)
            ru = _prod(dus[..., : N - 2, :] - ua, Lr.T)
        else:
            rx = sq_delta * _prod(dxs - xa, Lq.T)
            ru = sq_delta * _prod(dus - ua, Lr.T)
        xaN = 0.0 if regulation else xa[..., 0, :]
        rP = _prod(dxN - xaN, Lp.T)
        parts = [rx.flatten(-2), ru.flatten(-2), rP]
        if not regulation:
            parts.append(w.sqrtT * (xaN - (0.0 if lin else xs_ref)))
        return torch.cat(parts, dim=-1)

    def constraints(dxs, dus, dxN, theta, lin: bool = False, dxv=None):
        """The constraint stack c <= 0 (..., mc); lin: its derivative map,
        the ellipsoid row linearized at the value rollout's dxv."""
        off = lambda hv: 0.0 if lin else hv
        st = torch.cat([dxs[..., 1:, :], dxN[..., None, :]], dim=-2)
        if family == "fmincon":
            st = st[..., : N - 1, :]
            du_c = dus[..., : N - 1]
            dx_term = st[..., -1, :]
        else:
            du_c = dus
            dx_term = dxN
        c_state = (_prod(st, F_x.T) - off(h_x)).flatten(-2)
        c_input = (_prod(du_c[..., None], F_u.T) - off(h_u)).flatten(-2)
        if regulation:
            if ellipsoid_alpha is None:
                return torch.cat([c_state, c_input], dim=-1)
            # dimensionless (x'Px/alpha - 1 <= 0): the row keeps the O(1)
            # scale of the box rows (P's entries are O(2e3))
            if lin:
                c_ell = 2.0 * (_prod(dx_term, P_ell) * dxv).sum(-1) / ellipsoid_alpha
            else:
                c_ell = (_prod(dx_term, P_ell) * dx_term).sum(-1) / ellipsoid_alpha - 1.0
            return torch.cat([c_state, c_input, c_ell[..., None]], dim=-1)
        c_term = _prod(dx_term, Fw_x.T) + _prod(theta, Fw_th.T) - off(h_wN)
        return torch.cat([c_state, c_input, c_term], dim=-1)

    def dx_terminal(dxs, dxN):
        return dxs[:, N - 1] if family == "fmincon" else dxN

    def values(z, dx0):
        dxs, dus, dxN = rollout(z, dx0, tangents=False)
        theta = z[:, N * m:]
        args = (dxs[:, :, 0], dus[:, :, 0], dxN[:, 0], theta)
        return residuals(*args), constraints(*args)

    def jac_tangent(z, dx0):
        dxs, dus, dxN = rollout(z, dx0, tangents=True)
        theta = z[:, N * m:]
        v = (dxs[:, :, 0], dus[:, :, 0], dxN[:, 0], theta)
        # tangents with the direction axis first: (nz, B, ...)
        Ttheta = torch.eye(nz, dtype=dtype, device=dev)[:, N * m:]
        T = (dxs[:, :, 1:].permute(2, 0, 1, 3), dus[:, :, 1:].permute(2, 0, 1),
             dxN[:, 1:].permute(1, 0, 2), Ttheta[:, None, :].expand(nz, z.shape[0], nth))
        e, c = residuals(*v), constraints(*v)
        # (B, rows, nz), contiguous: the products that take them keep one
        # kernel whatever B (a strided operand's depends on it)
        J = residuals(*T, lin=True).permute(1, 2, 0).contiguous()
        dxv = dx_terminal(v[0], v[2])
        Jc = constraints(*T, lin=True, dxv=dxv).permute(1, 2, 0).contiguous()
        return e, J, c, Jc

    def solve_core(dx0, z_ws, graph_safe: bool = False):
        reps = lambda zs: dx0.repeat(zs.shape[0] // dx0.shape[0], 1)

        def merit_fn(zs):
            e, c = values(zs, reps(zs))
            return exact_sum(e * e), c

        failed = (torch.zeros(dx0.shape[0], dtype=torch.bool, device=dev)
                  if graph_safe else None)
        out = sqp_solve_nonlinear_constraints(
            None, None, None, z_ws, iters=sqp_iters, ipm_iters=ipm_iters,
            elastic_rows=elastic, jac_fn=lambda z: jac_tangent(z, dx0), merit_fn=merit_fn,
            chol_failed=failed)
        return (out.z, out.qp_converged), failed

    eager = lambda dx0, z_ws: solve_core(dx0, z_ws)[0]
    # the card replays a captured solve; collocation's Newton steps are LU
    # solves, which the library captures for one lane only
    graphed = (_Graphed(lambda dx0, z_ws: solve_core(dx0, z_ws, graph_safe=True), eager,
                        max_lanes=1 if prediction == "collocation" else None)
               if dev.type == "cuda" else None)

    def solve(dx0, window, z_ws):
        dx0 = dx0.to(dtype)
        z_ws = z_ws.to(dtype)
        # on the card a solve runs at least ops/lanes.MIN_LANES lanes
        # (on_min_lanes): with one, cuSOLVER and cuBLAS take their unbatched
        # paths, and the IPM's stopping test turns their roundoff into a
        # one-iteration difference (3e-9 over 10 NMPC_N50 steps on the card);
        # with the exact sums and products of ops/lanes a lane then gets the
        # same bits at any batch size. Collocation runs one lane as it is:
        # its one-lane graph is worth more than its lane bits.
        if prediction == "collocation":
            return (graphed or eager)(dx0, z_ws)
        return on_min_lanes(graphed or eager, dx0, z_ws)

    solve.nz = nz
    # the pieces, for the tools that time them
    solve.parts = dict(rollout=rollout, values=values, jac=jac_tangent, eager=eager,
                       graphed=graphed)
    return solve
