"""Batch-level LBMPC SQP: the Gauss-Newton loop at batch level.

Port of lbmpc_tpu/controllers/sqp_fused.py on all four routes of the
reference's `qp_kernel`, each Gauss-Newton (GN) iteration followed by the
batched l1-merit Armijo ladder in plain torch, float32 throughout as the
reference casts it:
- `qp_kernel="xla"` (the default, as in the reference): the residual and
  its Jacobian J in batched torch (K1's plain version, controllers/lbmpc),
  H = 2J'J + 1e-6 I and g = 2J'e, then one fused QP (ops/ipm_fused) whose
  KKT solves run on the K5 Cholesky kernels. The fmincon and casadi
  families, any nz up to 128;
- `qp_kernel="pallas"`: the same plain GN phase feeding K2 (ops/qp_kernel:
  the Mehrotra QP with a Hessian per lane; K2w above nz 32), one launch per
  GN iteration. Any family at nz <= 128 and mI <= 1024;
- `qp_kernel="pallas_full"`: two launches per GN iteration — K1 or K1w
  (ops/gn_kernel.GNPhase: residual, H and g for every lane) and K2 or K2w,
  fed that H as it is. The m=1 fmincon and casadi families at nz <= 128
  and mI <= 1024 (K1 and K2 at nz <= 32 for fmincon, the wide kernels
  otherwise);
- `qp_kernel="pallas_mono"`: one launch per GN iteration — K3
  (ops/mono_kernel: K1's GN body and a cold K2 loop in one block per lane).
  The m=1 fmincon family at nz <= 32; qp_warm is ignored, as in the
  reference.
The kernel routes hand K2/K3 the QP right-hand side h = (h0 + Hp dx0) - G z
formed in one order (ops/qp_kernel.step_rhs), so pallas_mono and
pallas_full without qp_warm solve the same QPs bit for bit.

jac_mode="jacfwd" and the vmapped repair are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmpc_tpu_torch.controllers.condensed import CondensedQP
from lbmpc_tpu_torch.controllers.lbmpc import LBMPCWeights
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.ops.ipm_fused import build_fused_qp_solver
from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
from lbmpc_tpu_torch.ops.qp_kernel import (MI_MAX, NZ_MAX, NZ_MAX_WIDE, QPSolverH,
                                           step_rhs)

_ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)
_F32 = torch.float32


def _check_route(qp_kernel: str, family: str, qp: CondensedQP,
                 jac_mode: str) -> None:
    if jac_mode != "manual":
        raise ValueError(f"jac_mode={jac_mode!r} is not ported yet; the port "
                         "has the hand-derived Jacobian (jac_mode='manual')")
    if family not in ("fmincon", "casadi"):
        raise ValueError(f"family={family!r}: the fused SQP covers the "
                         "fmincon and casadi families")
    if qp_kernel == "xla":
        return
    if qp_kernel not in ("pallas", "pallas_full", "pallas_mono"):
        raise ValueError(f"qp_kernel={qp_kernel!r}: the port has 'xla', 'pallas', "
                         "'pallas_full' and 'pallas_mono'")
    mI = qp.G.shape[0]
    if qp.nz > NZ_MAX_WIDE or mI > MI_MAX:
        raise ValueError(
            f"qp_kernel={qp_kernel!r}: the QP kernels (K2, K2w) take nz <= "
            f"{NZ_MAX_WIDE} and mI <= {MI_MAX}, as the reference's; nz={qp.nz}, "
            f"mI={mI}: use qp_kernel='xla'")
    if qp_kernel == "pallas":
        return
    if qp.m != 1:
        raise ValueError(f"qp_kernel={qp_kernel!r} covers the m=1 model (K1, K1w, "
                         f"K3), as the reference's kernels; m={qp.m}")
    if qp_kernel == "pallas_full":
        return
    if family == "casadi":
        raise ValueError(
            "qp_kernel='pallas_mono' for the casadi family is not ported: at the "
            "DMS flagship's shape the reference's own fused kernel refuses to "
            "launch (pallas_gn.py:177-205, scoped-VMEM need 59.3M at nz_p=104, "
            "q_p=104, tile 128 exceeds its 60M grant budget); use "
            "qp_kernel='pallas_full' or 'pallas'")
    if qp.nz > NZ_MAX:
        raise ValueError(
            f"qp_kernel='pallas_mono' (K3) is ported for the fmincon family at "
            f"nz <= {NZ_MAX}; nz={qp.nz} is not ported yet: use "
            "qp_kernel='pallas_full' (K1w + K2w) or 'xla'")


class FusedSolver:
    """Returned by make_lbmpc_solver_fused. `solver(dx0, windows, z_ws)` ->
    (z (B, nz), conv (B,)) casts to float32 on the solver's device;
    `raw` takes float32 tensors as they are. On the routes with K2 ("pallas",
    "pallas_full") with qp_warm, `raw_qpwarm` (dx0, windows, z_ws,
    qp_state) -> (z, conv, qp_state) threads the QP kernel's interior (s, z)
    across solves, seeded by `init_qp_state`; the xla and pallas_mono routes
    ignore qp_warm, as the reference does."""

    def __init__(self, qp: CondensedQP, A, B, Ks, w: LBMPCWeights,
                 family: str = "fmincon", delta: float = 0.01,
                 bandwidth: float = 0.5, ridge: float = 0.001, dx_ref=None,
                 sqp_iters: int = 3, ipm_iters=20, tile: int | None = None,
                 rho: float = 1e4, jac_mode: str = "manual",
                 d_cap: float = 1e6, qp_kernel: str = "xla",
                 alphas: tuple = _ALPHAS, qp_warm: bool = False,
                 warm_eps: float = 1e-5, device=None, plain: bool = False):
        _check_route(qp_kernel, family, qp, jac_mode)
        del tile  # the reference's TPU lane tile; nothing to tile here
        self.device = dev = resolve_device(device)
        self.qp_kernel = qp_kernel
        self.sqp_iters = sqp_iters
        self.rho = rho
        self.alphas = alphas
        self.qp_warm = qp_warm
        self.plain = plain
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        self.G, self.h0, self.Hp = t(qp.G), t(qp.h0), t(qp.Hp)
        self.nz = qp.nz
        self.gn = GNPhase(qp, A, B, Ks, w, family=family, delta=delta,
                          bandwidth=bandwidth, ridge=ridge, dx_ref=dx_ref,
                          device=dev)
        # ipm_iters: an int, or a per-GN-iteration schedule like `alphas`
        sched = (tuple(ipm_iters) if isinstance(ipm_iters, (tuple, list))
                 else (int(ipm_iters),) * sqp_iters)
        self.ipm_sched = sched + (sched[-1],) * (sqp_iters - len(sched))
        self._qps = {}
        if qp_kernel == "xla":
            self._fused = {it: build_fused_qp_solver(None, qp.G, iters=it,
                                                     d_cap=d_cap, device=dev,
                                                     plain=plain)
                           for it in set(self.ipm_sched)}
            return
        if qp_kernel == "pallas_mono":
            self._mono = {it: MonoPhase(self.gn, self.G, self.h0, self.Hp, it,
                                        d_cap=d_cap)
                          for it in set(self.ipm_sched)}
            return
        # per-position variants: with qp_warm, QP i>0 consumes the previous
        # QP's interior state and QP i<last produces one; the receding-
        # horizon chain (loop mode) makes every position warm-in and warm-out
        for i in range(sqp_iters):
            keys = [(self.ipm_sched[i],) + self._wio(i)]
            if qp_warm:
                keys.append((self.ipm_sched[i], True, True))
            for key in keys:
                self._qps[key] = QPSolverH(
                    qp.G, iters=key[0], d_cap=d_cap, warm_in=key[1],
                    warm_out=key[2], warm_eps=warm_eps, device=dev,
                    plain=plain)

    def _wio(self, i: int) -> tuple:
        return (self.qp_warm and i > 0, self.qp_warm and i < self.sqp_iters - 1)

    def _gn(self, z, dx0, windows):
        kernel = self.qp_kernel == "pallas_full" and not self.plain
        return (self.gn if kernel else self.gn.plain)(z, dx0, windows)

    def cost(self, z, dx0, windows):
        e = self.gn.residual(z, dx0, windows)
        return (e * e).sum(dim=1)

    def __call__(self, dx0, windows: DataWindow, z_ws):
        dev = self.device
        return self.raw(dx0.to(dev, _F32), windows.to(_F32, dev),
                        z_ws.to(dev, _F32))

    def raw(self, dx0, windows: DataWindow, z):
        return self._solve(dx0, windows, z, None)[:2]

    def raw_qpwarm(self, dx0, windows: DataWindow, z, qp_state):
        if not (self.qp_warm and self.qp_kernel in ("pallas", "pallas_full")):
            raise ValueError("raw_qpwarm needs qp_warm=True on a route with K2 "
                             "(qp_kernel='pallas' or 'pallas_full')")
        return self._solve(dx0, windows, z, qp_state)

    def init_qp_state(self, dx0, z_ws):
        return QPSolverH.cold_state(step_rhs(self.h0, self.Hp, self.G, dx0.to(_F32),
                                             z_ws.to(_F32)))

    def _solve(self, dx0, windows: DataWindow, z, qp_state):
        loop = qp_state is not None
        G = self.G
        h = self.h0[None, :] + dx0 @ self.Hp.T
        per_gn = isinstance(self.alphas[0], (tuple, list))
        mu_last = torch.zeros(dx0.shape[0], dtype=_F32, device=dx0.device)
        warm_state = qp_state
        for it in range(self.sqp_iters):
            sched = (tuple(self.alphas[min(it, len(self.alphas) - 1)])
                     if per_gn else tuple(self.alphas))
            if self.qp_kernel == "xla":
                e, H, gb = self.gn.plain(z, dx0, windows)
                sub = self._fused[self.ipm_sched[it]].raw_with_H(
                    H, gb, h - z @ G.T)
                del H
                d, mu_last = sub.x, sub.mu
            elif self.qp_kernel == "pallas_mono":
                mono = self._mono[self.ipm_sched[it]]
                e, d, mu_last, gb = (mono.plain if self.plain else mono)(z, dx0, windows)
            else:
                e, H, gb = self._gn(z, dx0, windows)
                win, wout = (True, True) if loop else self._wio(it)
                qp = self._qps[(self.ipm_sched[it], win, wout)]
                out = qp.raw_packed(H, gb, step_rhs(self.h0, self.Hp, G, dx0, z),
                                    warm_state)
                d, mu_last = out[0], out[1]
                warm_state = out[2] if wout else None
            # merit at the current iterate reuses the GN phase's residual
            v0 = torch.clamp(z @ G.T - h, min=0.0).sum(dim=1)
            m0 = (e * e).sum(dim=1) + self.rho * v0
            dirderiv = (gb * d).sum(dim=1) - self.rho * v0
            # fixed Armijo ladder; if every alpha is rejected (e.g. a NaN
            # direction: NaN merits compare false) the lane takes NO step
            accepted = torch.zeros_like(m0, dtype=torch.bool)
            alpha_sel = torch.zeros_like(m0)
            for a in sched:
                za = z + a * d
                m_a = (self.cost(za, dx0, windows)
                       + self.rho * torch.clamp(za @ G.T - h, min=0.0).sum(dim=1))
                ok = ~accepted & (m_a <= m0 + 1e-4 * a * dirderiv)
                alpha_sel = torch.where(ok, a, alpha_sel)
                accepted = accepted | ok
            d = torch.where(torch.isfinite(d), d, 0.0)
            z = z + alpha_sel[:, None] * d
        # controller-level convergence: feasible, finite, sane last QP
        h_scale = 1.0 + h.abs().amax(dim=1)
        viol = (z @ G.T - h).amax(dim=1)
        conv = ((viol <= 2e-3 * h_scale) & torch.isfinite(z).all(dim=1)
                & (mu_last < 1e-2))
        return z, conv, warm_state


def make_lbmpc_solver_fused(qp: CondensedQP, A, B, Ks, w: LBMPCWeights,
                            **kw) -> FusedSolver:
    """The reference factory's name for FusedSolver (same keywords; `tile`
    is accepted and ignored, `device` and `plain` are the port's)."""
    return FusedSolver(qp, A, B, Ks, w, **kw)


class HybridSolver:
    """Fused batch SQP + a fixed-size compacted repair of flagged lanes
    (make_lbmpc_solver_hybrid, repair_backend="fused"): the K =
    round(B * repair_frac) lanes flagged first (stable order, as
    lax.top_k ranks ties) are gathered, re-solved through the same kernels
    with the repair budget from the fused iterate (repair_warm="fused"),
    and scattered back where a lane was flagged."""

    def __init__(self, qp: CondensedQP, A, B, Ks, w: LBMPCWeights,
                 family: str = "fmincon", delta: float = 0.01,
                 bandwidth: float = 0.5, ridge: float = 0.001, dx_ref=None,
                 sqp_iters: int = 3, ipm_iters=20, tile: int | None = None,
                 rho: float = 1e4,
                 repair_frac: float = 1.0 / 16.0, repair_ipm_iters: int = 30,
                 repair_sqp_iters: int | None = None, repair_warm: str = "ws",
                 qp_kernel: str = "xla", alphas: tuple = _ALPHAS,
                 repair_backend: str = "vmapped", qp_warm: bool = False,
                 device=None, plain: bool = False):
        if repair_backend != "fused" or repair_warm != "fused":
            raise ValueError(
                f"repair_backend={repair_backend!r}, repair_warm={repair_warm!r}: "
                "not ported yet; the port has the fused repair seeded at the "
                "fused iterate (repair_backend='fused', repair_warm='fused')")
        common = dict(family=family, delta=delta, bandwidth=bandwidth,
                      ridge=ridge, dx_ref=dx_ref, rho=rho,
                      qp_kernel=qp_kernel, device=device, plain=plain)
        self.fused = FusedSolver(qp, A, B, Ks, w, sqp_iters=sqp_iters,
                                 ipm_iters=ipm_iters, alphas=alphas,
                                 qp_warm=qp_warm, **common)
        self.repair = FusedSolver(qp, A, B, Ks, w,
                                  sqp_iters=repair_sqp_iters or sqp_iters,
                                  ipm_iters=repair_ipm_iters,
                                  alphas=(1.0, 0.5, 0.25), **common)
        self.device = self.fused.device
        self.repair_frac = repair_frac
        self.init_qp_state = self.fused.init_qp_state

    def _repair(self, z, conv, dx0, windows: DataWindow, z_ws):
        Bsz = dx0.shape[0]
        K = max(1, min(Bsz, int(round(Bsz * self.repair_frac))))
        flagged = ~conv
        idx = torch.argsort(flagged.to(_F32), descending=True, stable=True)[:K]
        take = flagged[idx]
        z_seed = torch.where(torch.isfinite(z[idx]), z[idx], z_ws[idx])
        z_r, conv_r = self.repair.raw(dx0[idx], windows.index(idx), z_seed)
        z_r = torch.where(torch.isfinite(z_r), z_r, 0.0)
        z = z.clone()
        conv = conv.clone()
        z[idx] = torch.where(take[:, None], z_r, z[idx])
        conv[idx] = torch.where(take, conv_r, conv[idx])
        return z, conv

    def __call__(self, dx0, windows: DataWindow, z_ws):
        dev = self.device
        return self.raw(dx0.to(dev, _F32), windows.to(_F32, dev),
                        z_ws.to(dev, _F32))

    def raw(self, dx0, windows: DataWindow, z_ws):
        z, conv = self.fused.raw(dx0, windows, z_ws)
        return self._repair(z, conv, dx0, windows, z_ws)

    def raw_qpwarm(self, dx0, windows: DataWindow, z_ws, qp_state):
        """Cross-step warm chain with the per-step repair riding along: the
        repair touches z and conv only; the carried interior state is the
        fused path's."""
        z, conv, qp_state = self.fused.raw_qpwarm(dx0, windows, z_ws, qp_state)
        z, conv = self._repair(z, conv, dx0, windows, z_ws)
        return z, conv, qp_state


def make_lbmpc_solver_hybrid(qp: CondensedQP, A, B, Ks, w: LBMPCWeights,
                             **kw) -> HybridSolver:
    """The reference factory's name for HybridSolver."""
    return HybridSolver(qp, A, B, Ks, w, **kw)
