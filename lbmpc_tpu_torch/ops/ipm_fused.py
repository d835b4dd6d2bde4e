"""Batch-level Mehrotra QP with the KKT solves on the K5 Cholesky kernels
(the `qp_kernel="xla"` route of the fused SQP).

Port of lbmpc_tpu/ops/ipm_fused.py. Every Mehrotra iteration assembles the
KKT normal matrices of the whole batch with a few matrix products that skip
G's structural zeros (`_build_structured_assembly`), equilibrates them
symmetrically, and solves them in ops/chol_kernel: K5a (factor, solve, store
L) for the predictor and K5c (re-solve with L) for the corrector, or K5b
twice when LBMPC_CHOL_STORE=0. LBMPC_CHOL_BLOCKED=1 puts the factorizations
on the slab-blocked K6a / K6b at n_p = 8 ceil(nz / 8) >= 32, as in the
reference (read when the solver is built); they equal K5a / K5b bit for
bit, and K5c still re-solves. The rest is batched torch. float32, with full
float32 matrix products (TF32 is off in the package).

Two options, off by default as in the reference:
- refine=True: the safeguarded float64 refinement of the corrector solve
  (lbmpc_tpu/ops/ipm_fused.py:338-353): the residual M dx - r in float64,
  one K5c re-solve of it with the stored L, and the correction kept only on
  the lanes where it shrinks the residual. It runs where the reference runs
  it, with L stored (on the K5 or K6 route; the reference's x64 condition
  always holds in torch): one more K5c launch an IPM iteration;
- LBMPC_CHOL=xla (read when the solver is built): the reference's library
  route, jnp.linalg's Cholesky (ops/ipm_fused.py:176, :330-331), here
  torch.linalg.cholesky_ex and cholesky_solve; a lane the library cannot
  factor gets a NaN factor, as jnp.linalg.cholesky gives. It launches no
  K5.

No batch padding: the reference pads B to its TPU lane tile because a
Pallas grid of B // tile programs would skip a ragged tail; here every
kernel runs one block per lane, so any B is solved as it is.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.ops.lanes import lane_sum
from lbmpc_tpu_torch.ops.chol_kernel import (blocked_switch, chol_factor_solve,
                                             chol_factor_solve_blocked, chol_resolve,
                                             chol_solve, chol_solve_blocked,
                                             factor_store_feasible)

_F32 = torch.float32


def _build_structured_assembly(G: np.ndarray, n_b: int | None = None,
                               device=None):
    """Returns assemble(d (B, mI)) -> M (B, nz, nz) = G' diag(d) G, skipping
    G's structural zeros (same row classes as the reference):
      - rows with a 1-column support add to the diagonal: one
        (B, m1) @ (m1, nz) product;
      - rows sharing a 2-column support {a, b} add three dot products to
        (a, a), (a, b) = (b, a) and (b, b);
      - the remaining rows, bucketed by their last nonzero column (n_b
        buckets, LBMPC_ASM_BUCKETS, default 4, the last full width), add a
        dense d_c @ W_c truncated to the bucket's column bound.
    The terms are added in the reference's order (buckets, diagonal, pairs);
    the reference sums padded copies because each slice update cost a pass
    over M under XLA, while here the sums go into M's slices in place."""
    if n_b is None:
        n_b = int(os.environ.get("LBMPC_ASM_BUCKETS", "4"))
    dev = resolve_device(device)
    G = np.asarray(G, np.float32)
    mI, nz = G.shape
    supports = [np.nonzero(G[i])[0] for i in range(mI)]
    singles: list[int] = []
    pair_groups: dict[tuple, list[int]] = {}
    rest: list[int] = []
    for i, s in enumerate(supports):
        if len(s) == 1:
            singles.append(i)
        elif len(s) == 2:
            pair_groups.setdefault((int(s[0]), int(s[1])), []).append(i)
        else:
            rest.append(i)
    n_b = max(1, n_b)
    step = -(-nz // n_b)
    bounds = [min((c + 1) * step, nz) for c in range(n_b)]
    buckets: list[list[int]] = [[] for _ in range(n_b)]
    for i in rest:
        hi = int(supports[i][-1]) + 1 if len(supports[i]) else 1
        for c, bnd in enumerate(bounds):
            if hi <= bnd:
                buckets[c].append(i)
                break

    t = lambda a, dt=_F32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    idx = lambda rows: t(np.asarray(rows, np.int64), torch.int64)
    bucket_data = []
    for c, rows in enumerate(buckets):
        if rows:
            bb = bounds[c]
            Gr = G[rows][:, :bb]
            Wc = (Gr[:, :, None] * Gr[:, None, :]).reshape(len(rows), bb * bb)
            bucket_data.append((bb, idx(rows), t(Wc)))
    single_data = (idx(singles), t(G[singles] ** 2)) if singles else None
    pair_data = []
    for (a, b), rows in pair_groups.items():
        coefs = np.stack([G[rows, a] * G[rows, a], G[rows, a] * G[rows, b],
                          G[rows, b] * G[rows, b]], axis=1)       # (mp, 3)
        pair_data.append((a, b, idx(rows), t(coefs)))

    def assemble(d: torch.Tensor) -> torch.Tensor:
        Bsz = d.shape[0]
        M = torch.zeros(Bsz, nz, nz, dtype=d.dtype, device=d.device)
        for bb, r, Wc in bucket_data:
            M[:, :bb, :bb] += (d[:, r] @ Wc).reshape(Bsz, bb, bb)
        if single_data is not None:
            r, Gsq = single_data
            M.diagonal(dim1=1, dim2=2).add_(d[:, r] @ Gsq)
        for a, b, r, coefs in pair_data:
            dots = d[:, r] @ coefs                                # (B, 3)
            M[:, a, a] += dots[:, 0]
            M[:, a, b] += dots[:, 1]
            M[:, b, a] += dots[:, 1]
            M[:, b, b] += dots[:, 2]
        return M

    return assemble


class FusedBatchSolution(NamedTuple):
    x: torch.Tensor           # (B, nz)
    converged: torch.Tensor   # (B,)
    mu: torch.Tensor          # (B,)
    infeasible: torch.Tensor  # (B,) Farkas certificate of primal infeasibility
    farkas_gap: torch.Tensor  # (B,) -h'y for the normalized dual ray y


class FusedQPSolver:
    """Returned by build_fused_qp_solver. `solver(g (B, nz), h (B, mI))`
    solves with the shared H; `solve_with_H(H_b (B, nz, nz), g, h)` with a
    Hessian per lane (both cast to float32 on the solver's device);
    `raw_with_H` takes float32 tensors as they are. Each returns a
    FusedBatchSolution."""

    def __init__(self, H, G, iters: int = 20, refine: bool = False,
                 scale: bool = True, d_cap: float = 1e6, device=None,
                 plain: bool = False):
        G = np.asarray(G)
        mI, nz = G.shape
        self.chol_xla = os.environ.get("LBMPC_CHOL", "pallas") == "xla"
        self.device = dev = resolve_device(device)
        self.iters, self.scale, self.d_cap = int(iters), bool(scale), float(d_cap)
        self.plain = plain
        self.nz, self.mI = nz, mI
        self.store_L = factor_store_feasible()
        self.blocked = blocked_switch(nz)
        self.refine = bool(refine) and self.store_L and not self.chol_xla
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.H = t(H).reshape(1, nz, nz) if H is not None else None
        self.G = t(G)
        self.assemble = _build_structured_assembly(G, device=dev)
        self._ridge = 1e-6 * torch.eye(nz, dtype=_F32, device=dev)
        # Farkas purification operator y -> y - y G (G'G)^-1 G', projecting
        # onto null(G') where every infeasibility certificate lives; f64 on
        # the host
        G64 = G.astype(np.float64)
        GtG64 = G64.T @ G64 + 1e-12 * (1.0 + np.abs(G64).max() ** 2) * np.eye(nz)
        self.GtGinv_Gt = t(np.linalg.solve(GtG64, G64.T))
        self.G_max = float(1.0 + np.abs(G64).max())

    def __call__(self, g, h) -> FusedBatchSolution:
        if self.H is None:
            raise ValueError("this solver was built without a shared H; use "
                             "solve_with_H")
        dev = self.device
        return self._solve(self.H, g.to(dev, _F32), h.to(dev, _F32))

    def solve_with_H(self, H_b, g, h) -> FusedBatchSolution:
        dev = self.device
        return self._solve(H_b.to(dev, _F32), g.to(dev, _F32), h.to(dev, _F32))

    def raw_with_H(self, H_b, g, h) -> FusedBatchSolution:
        return self._solve(H_b, g, h)

    def _farkas(self, z, h, h_scale):
        """Purified Farkas ray from the duals: project z/|z| onto null(G'),
        clip >= 0, check G'y ~ 0 and h'y < 0. Checked inside the loop too,
        because an infeasible lane's float32 duals overflow to NaN before the
        last iteration; the certificate latches while they are finite."""
        G = self.G
        zmax = z.amax(dim=1, keepdim=True)
        y = z / torch.clamp(zmax, min=1e-25)
        y = torch.clamp(y - (y @ G) @ self.GtGinv_Gt, min=0.0)
        ynorm = y.abs().amax(dim=1, keepdim=True)
        y = y / torch.clamp(ynorm, min=1e-25)
        gap = -lane_sum(h * y)
        cert = ((zmax[:, 0] > 1e4) & (ynorm[:, 0] > 0.1)
                & (gap > 1e-3 * h_scale)
                & ((y @ G).abs().amax(dim=1) < 1e-3 * self.G_max))
        return cert, gap

    def _solve(self, Hb, g, h) -> FusedBatchSolution:
        Bsz, nz, mI = g.shape[0], self.nz, self.mI
        G, Gt = self.G, self.G.T
        plain = self.plain
        x = torch.zeros(Bsz, nz, dtype=_F32, device=g.device)
        s = torch.clamp(h, min=1.0)
        z = torch.ones(Bsz, mI, dtype=_F32, device=g.device)
        h_scale = 1.0 + h.abs().amax(dim=1)
        shared_H = Hb.shape[0] == 1
        infeasible = torch.zeros(Bsz, dtype=torch.bool, device=g.device)
        gap_lat = torch.zeros(Bsz, dtype=_F32, device=g.device)

        def steplen(v, dv, frac):
            ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), 1e9)
            return torch.clamp(frac * ratio.amin(dim=1), max=1.0)[:, None]

        for _ in range(self.iters):
            cert, gap = self._farkas(z, h, h_scale)
            infeasible = infeasible | cert
            gap_lat = torch.where(cert, torch.maximum(gap_lat, gap), gap_lat)
            Hx = x @ Hb[0].T if shared_H else (Hb @ x[..., None])[..., 0]
            rd = Hx + g + z @ G
            rp = x @ Gt + s - h
            s_safe = torch.clamp(s, min=1e-25)
            d = torch.clamp(z / s_safe, max=self.d_cap)
            M = self.assemble(d) + Hb + self._ridge
            if self.scale:
                sc = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=1, dim2=2),
                                             min=1e-30))
                Mk = M * (sc[:, :, None] * sc[:, None, :])
            else:
                sc = torch.ones(Bsz, nz, dtype=_F32, device=g.device)
                Mk = M
            mu = lane_sum(s * z) / mI

            def rhs_of(rc):
                return -(rd + (d * rp - rc / s_safe) @ G)

            def expand(dx, rc):
                Gdx = dx @ Gt
                return -rp - Gdx, d * (rp + Gdx) - rc / s_safe

            rc_aff = s * z
            # module globals looked up at call time (tests and chip_smoke
            # wrap them)
            factor = chol_factor_solve_blocked if self.blocked else chol_factor_solve
            refactor = chol_solve_blocked if self.blocked else chol_solve
            if self.chol_xla:
                L = _library_factor(Mk)
                u_a = torch.cholesky_solve((rhs_of(rc_aff) * sc)[..., None], L)[..., 0]
            elif self.store_L:
                L, u_a = factor(Mk, rhs_of(rc_aff) * sc, plain)
            else:
                u_a = refactor(Mk, rhs_of(rc_aff) * sc, plain)
            ds_a, dz_a = expand(u_a * sc, rc_aff)
            ap = steplen(s, ds_a, 1.0)
            ad = steplen(z, dz_a, 1.0)
            mu_aff = lane_sum((s + ap * ds_a) * (z + ad * dz_a)) / mI
            sr = mu_aff / torch.clamp(mu, min=1e-25)
            sigma = sr * sr * sr
            rc = s * z + ds_a * dz_a - (sigma * mu)[:, None]
            rhs_u = rhs_of(rc)
            rhs_c = rhs_u * sc
            if self.chol_xla:
                dx = torch.cholesky_solve(rhs_c[..., None], L)[..., 0] * sc
            elif self.store_L:
                dx = chol_resolve(L, rhs_c, plain) * sc
            else:
                dx = refactor(Mk, rhs_c, plain) * sc
            if self.refine:
                dx = _refine(M, L, dx, rhs_u, sc, plain)
            ds, dz = expand(dx, rc)
            ap = steplen(s, ds, 0.995)
            ad = steplen(z, dz, 0.995)
            x, s, z = x + ap * dx, s + ap * ds, z + ad * dz

        cert_f, gap_f = self._farkas(
            torch.nan_to_num(z, nan=0.0, posinf=1e30), h, h_scale)
        farkas_gap = torch.where(cert_f & ~infeasible, gap_f, gap_lat)
        infeasible = infeasible | cert_f
        mu = lane_sum(s * z) / mI
        rp = x @ Gt + s - h
        conv = ((mu < 2e-4 * (1.0 + mu * mI))
                & (rp.abs().amax(dim=1) < 2e-3 * h_scale))
        return FusedBatchSolution(x=x, converged=conv, mu=mu,
                                  infeasible=infeasible & ~conv,
                                  farkas_gap=farkas_gap)


def _library_factor(Mk):
    """torch.linalg's Cholesky of every lane, NaN where it fails (as
    jnp.linalg.cholesky); no host check."""
    L, info = torch.linalg.cholesky_ex(Mk, check_errors=False)
    return torch.where((info != 0)[:, None, None], torch.nan, L)


def _refine(M, L, dx, rhs, sc, plain: bool):
    """One safeguarded refinement of the corrector's dx (M dx = rhs, with
    the equilibrated factor L of sc M sc): the residual in float64, one K5c
    re-solve of it, the correction kept on the lanes where the float64
    residual shrinks (lbmpc_tpu/ops/ipm_fused.py:338-353)."""
    M64 = M.double()
    resid = (M64 @ dx.double()[..., None])[..., 0] - rhs.double()
    e = chol_resolve(L, resid.float() * sc, plain) * sc
    resid2 = resid - (M64 @ e.double()[..., None])[..., 0]
    better = (resid2 * resid2).sum(dim=1) < (resid * resid).sum(dim=1)
    return dx - torch.where(better[:, None], e, 0.0)


def build_fused_qp_solver(H, G, iters: int = 20, refine: bool = False,
                          scale: bool = True, d_cap: float = 1e6, device=None,
                          plain: bool = False) -> FusedQPSolver:
    """The reference factory's name for FusedQPSolver (H may be None when
    only solve_with_H / raw_with_H are used). `scale` is the symmetric
    Jacobi equilibration of every KKT matrix before the factorization;
    `d_cap` caps the constraint weights d = z/s (the reference's on-chip
    sweep chose 1e6). `refine` is the safeguarded float64 refinement of the
    corrector solve (with L stored; module docstring). `device` and `plain`
    are the port's."""
    return FusedQPSolver(H, G, iters=iters, refine=refine, scale=scale,
                         d_cap=d_cap, device=device, plain=plain)
