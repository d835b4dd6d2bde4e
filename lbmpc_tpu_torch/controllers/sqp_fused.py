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
- `qp_kernel="pallas_mono"`: one launch per GN iteration — K3 or K3w
  (ops/mono_kernel: the GN body and a cold Mehrotra loop in one block per
  lane; K3 for the fmincon family at nz <= 32, K3w above it and for the
  casadi family). The m=1 model at nz <= 128 and mI <= 1024, wherever the
  reference's own scoped-VMEM model of its fused kernel lets it launch
  (check_mono_vmem: the DMS flagship's shape does not); qp_warm is ignored,
  as in the reference.
The kernel routes hand K2/K3 the QP right-hand side h = (h0 + Hp dx0) - G z
formed in one order (ops/qp_kernel.step_rhs), so pallas_mono and
pallas_full without qp_warm solve the same QPs bit for bit.

HybridSolver repairs the flagged lanes with the fused solver at the
compacted size (repair_backend="fused") or with the per-problem SQP of
controllers/lbmpc.make_lbmpc_solver on ops/ipm ("vmapped", the reference's
default); FleetSolver (make_lbmpc_solver_fleet) defers one vmapped repair
over R fused batches. jac_mode="jacfwd" takes the GN Jacobian of the
routes with the plain GN phase ("xla", "pallas") from torch.func.jacfwd of
one lane's residual, vmapped over the lanes (the reference's autodiff path,
lbmpc_tpu/controllers/sqp_fused.py:198-203); the kernel routes ignore it,
as the reference's do.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmpc_tpu_torch.controllers.condensed import CondensedQP
from lbmpc_tpu_torch.controllers.lbmpc import LBMPCWeights, make_lbmpc_solver
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.ops.ipm_fused import build_fused_qp_solver
from lbmpc_tpu_torch.ops.lanes import exact_rows, lane_sum
from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
from lbmpc_tpu_torch.ops.qp_kernel import (MI_MAX, NZ_MAX_WIDE, QPSolverH,
                                           step_rhs)

_ALPHAS = (1.0, 0.5, 0.25, 0.125, 0.0625)
_F32 = torch.float32


def _check_route(qp_kernel: str, family: str, qp: CondensedQP,
                 jac_mode: str) -> None:
    if jac_mode not in ("manual", "jacfwd"):
        raise ValueError(f"jac_mode={jac_mode!r}: 'manual' or 'jacfwd'")
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
                         f"K3, K3w), as the reference's kernels; m={qp.m}")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


MONO_TILE = 128              # the reference's mono lane-tile cap (LBMPC_MONO_TILE)
_VMEM_PAD = 6 << 20          # grant = need + 6M
_VMEM_BUDGET = 60 << 20


def mono_vmem_need(qp: CondensedQP, family: str, q: int, tile: int) -> int:
    """The scoped-VMEM bytes that the reference's fused GN + Mehrotra kernel
    models for itself (lbmpc_tpu/ops/pallas_gn.py:177-205, _vmem_grant with
    ipm): the resident elements of a lane tile of `tile` lanes at the padded
    shapes, times its 2.7 liveness calibration, in float32."""
    n = qp.n
    n_run = qp.N - 2 if family == "fmincon" else qp.N
    ne = n_run * (n + qp.m) + 2 * n
    nz_p, ne_p, q_p = _round_up(qp.nz, 8), _round_up(ne, 8), _round_up(q, 8)
    mI_p = _round_up(qp.G.shape[0], 128)
    d_in, d_out = 3, n
    el = (2 * (d_in + d_out) * q_p + 8 * q_p + n * nz_p + 2 * ne_p
          + 3 * nz_p * nz_p) * tile
    el += 6 * mI_p * tile + 2 * nz_p * mI_p + mI_p * 128
    return int(2.7 * el * 4)


def check_mono_vmem(qp: CondensedQP, family: str, q: int, tile: int) -> None:
    """Raise, with the reference's message, where the reference's fused
    kernel refuses to launch: its modelled need plus the 6M pad exceeds the
    60M grant budget (59.3M at the DMS flagship, nz_p=104, q_p=104, tile
    128). The port's kernels have no such budget; the route runs where the
    reference's runs, and nowhere else."""
    need = mono_vmem_need(qp, family, q, tile)
    if need + _VMEM_PAD > _VMEM_BUDGET:
        raise ValueError(
            f"pallas GN kernel scoped-VMEM need {need / 2**20:.1f}M "
            f"(nz_p={_round_up(qp.nz, 8)}, q_p={_round_up(q, 8)}, tile={tile}, "
            "ipm=True) exceeds the 60M grant budget; shrink the tile")


class FusedSolver:
    """Returned by make_lbmpc_solver_fused. `solver(dx0, windows, z_ws)` ->
    (z (B, nz), conv (B,)) casts to float32 on the solver's device;
    `raw` takes float32 tensors as they are. On the routes with K2 ("pallas",
    "pallas_full") with qp_warm, `raw_qpwarm` (dx0, windows, z_ws,
    qp_state) -> (z, conv, qp_state) threads the QP kernel's interior (s, z)
    across solves, seeded by `init_qp_state`; the xla and pallas_mono routes
    ignore qp_warm, as the reference does. The merit's and the flag's
    products with G and Hp take ops/lanes.exact_rows, whose rows do not
    depend on B (cuBLAS picks a matrix product's kernel by B): on
    pallas_full, where K1 and K2 give a lane the same bits at any B, a
    lane's bits then do not depend on the batch's size, and a split solve
    (runtime/sharding.split_solver) equals the whole one bit for bit."""

    def __init__(self, qp: CondensedQP, A, B, Ks, w: LBMPCWeights,
                 family: str = "fmincon", delta: float = 0.01,
                 bandwidth: float = 0.5, ridge: float = 0.001, dx_ref=None,
                 sqp_iters: int = 3, ipm_iters=20, tile: int | None = None,
                 rho: float = 1e4, jac_mode: str = "manual",
                 d_cap: float = 1e6, qp_kernel: str = "xla",
                 alphas: tuple = _ALPHAS, qp_warm: bool = False,
                 warm_eps: float = 1e-5, device=None, plain: bool = False):
        _check_route(qp_kernel, family, qp, jac_mode)
        self.device = dev = resolve_device(device)
        self.qp_kernel = qp_kernel
        # the reference's TPU lane tile: nothing is tiled here, but the
        # pallas_mono route runs only where the reference's VMEM model at its
        # mono tile admits it (checked per window size at the first solve)
        self.mono_tile = min(512 if tile is None else tile, MONO_TILE)
        self._qp, self._family, self._vmem_ok = qp, family, set()
        self.sqp_iters = sqp_iters
        self.rho = rho
        self.alphas = alphas
        self.qp_warm = qp_warm
        self.plain = plain
        self.jac_mode = jac_mode
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
        if self.qp_kernel == "pallas_full":
            return (self.gn.plain if self.plain else self.gn)(z, dx0, windows)
        return self.gn.plain(z, dx0, windows, self.jac_mode)

    def cost(self, z, dx0, windows):
        e = self.gn.residual(z, dx0, windows)
        return lane_sum(e * e)

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
        q = windows.X.shape[-2]
        if self.qp_kernel == "pallas_mono" and q not in self._vmem_ok:
            check_mono_vmem(self._qp, self._family, q, self.mono_tile)
            self._vmem_ok.add(q)
        loop = qp_state is not None
        G = self.G
        h = self.h0[None, :] + exact_rows(dx0, self.Hp)
        per_gn = isinstance(self.alphas[0], (tuple, list))
        mu_last = torch.zeros(dx0.shape[0], dtype=_F32, device=dx0.device)
        warm_state = qp_state
        for it in range(self.sqp_iters):
            sched = (tuple(self.alphas[min(it, len(self.alphas) - 1)])
                     if per_gn else tuple(self.alphas))
            if self.qp_kernel == "xla":
                e, H, gb = self.gn.plain(z, dx0, windows, self.jac_mode)
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
            v0 = lane_sum(torch.clamp(exact_rows(z, G) - h, min=0.0))
            m0 = lane_sum(e * e) + self.rho * v0
            dirderiv = (gb * d).sum(dim=1) - self.rho * v0
            # fixed Armijo ladder; if every alpha is rejected (e.g. a NaN
            # direction: NaN merits compare false) the lane takes NO step
            accepted = torch.zeros_like(m0, dtype=torch.bool)
            alpha_sel = torch.zeros_like(m0)
            for a in sched:
                za = z + a * d
                m_a = (self.cost(za, dx0, windows)
                       + self.rho * lane_sum(torch.clamp(exact_rows(za, G) - h, min=0.0)))
                ok = ~accepted & (m_a <= m0 + 1e-4 * a * dirderiv)
                alpha_sel = torch.where(ok, a, alpha_sel)
                accepted = accepted | ok
            d = torch.where(torch.isfinite(d), d, 0.0)
            z = z + alpha_sel[:, None] * d
        # controller-level convergence: feasible, finite, sane last QP
        h_scale = 1.0 + h.abs().amax(dim=1)
        viol = (exact_rows(z, G) - h).amax(dim=1)
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
    (make_lbmpc_solver_hybrid): the K = round(B * repair_frac) lanes flagged
    first (stable order, as lax.top_k ranks ties) are gathered, re-solved
    with the repair budget, and scattered back where a lane was flagged.
    repair_backend="vmapped" (the reference's default) re-solves them with
    the per-problem float32 SQP (controllers/lbmpc.make_lbmpc_solver on
    ops/ipm), "fused" through the fused solver's own route at the compacted
    size. repair_warm="ws" seeds the repair at the original warm start,
    "fused" at the fused iterate where it is finite."""

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
        if repair_backend not in ("vmapped", "fused"):
            raise ValueError(f"repair_backend={repair_backend!r}: 'vmapped' or 'fused'")
        if repair_warm not in ("ws", "fused"):
            raise ValueError(f"repair_warm={repair_warm!r}: 'ws' or 'fused'")
        model = dict(family=family, delta=delta, bandwidth=bandwidth, ridge=ridge,
                     dx_ref=dx_ref)
        common = dict(model, rho=rho, qp_kernel=qp_kernel, device=device, plain=plain)
        self.fused = FusedSolver(qp, A, B, Ks, w, sqp_iters=sqp_iters,
                                 ipm_iters=ipm_iters, tile=tile, alphas=alphas,
                                 qp_warm=qp_warm, **common)
        self.device = self.fused.device
        if repair_backend == "fused":
            self.repair = FusedSolver(qp, A, B, Ks, w,
                                      sqp_iters=repair_sqp_iters or sqp_iters,
                                      ipm_iters=repair_ipm_iters,
                                      alphas=(1.0, 0.5, 0.25), **common).raw
        else:
            self.repair = make_lbmpc_solver(
                qp, A, B, Ks, w, sqp_iters=repair_sqp_iters or sqp_iters,
                ipm_iters=repair_ipm_iters, dtype=_F32, device=self.device, **model)
        self.repair_backend = repair_backend
        self.repair_warm = repair_warm
        self.repair_frac = repair_frac
        self.init_qp_state = self.fused.init_qp_state

    def _repair(self, z, conv, dx0, windows: DataWindow, z_ws):
        K = max(1, min(dx0.shape[0], int(round(dx0.shape[0] * self.repair_frac))))
        return repair_lanes(self.repair, K, self.repair_warm == "fused", z, conv, dx0,
                            windows, z_ws)

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


def repair_pick(conv, K: int):
    """The K lanes a repair takes: those flagged first (~conv), by a stable
    descending sort of the flags (lax.top_k's order), then unflagged ones
    where fewer than K are flagged."""
    return torch.argsort((~conv).to(_F32), descending=True, stable=True)[:K]


def repair_lanes(repair, K: int, seed_fused: bool, z, conv, dx0,
                 windows: DataWindow, z_ws):
    """Re-solve the K lanes flagged first (repair_pick) with `repair` (dx0,
    windows, z_seed) -> (z, conv); see repair_at. Lanes past the K flagged
    first keep their result and their flag."""
    return repair_at(repair, repair_pick(conv, K), seed_fused, z, conv, dx0, windows,
                     z_ws)


def repair_at(repair, idx, seed_fused: bool, z, conv, dx0, windows: DataWindow, z_ws):
    """Re-solve the lanes `idx` with `repair`, seeded at z where finite
    (seed_fused) or at z_ws; scatter the results back where a lane was
    flagged, a non-finite repaired z as 0."""
    take = (~conv)[idx]
    z_seed = (torch.where(torch.isfinite(z[idx]), z[idx], z_ws[idx]) if seed_fused
              else z_ws[idx])
    z_r, conv_r = repair(dx0[idx], windows.index(idx), z_seed)
    z_r = torch.where(torch.isfinite(z_r), z_r, 0.0)
    z = z.clone()
    conv = conv.clone()
    z[idx] = torch.where(take[:, None], z_r, z[idx])
    conv[idx] = torch.where(take, conv_r, conv[idx])
    return z, conv


def make_lbmpc_solver_hybrid(qp: CondensedQP, A, B, Ks, w: LBMPCWeights,
                             **kw) -> HybridSolver:
    """The reference factory's name for HybridSolver."""
    return HybridSolver(qp, A, B, Ks, w, **kw)


class FleetSolver:
    """Returned by make_lbmpc_solver_fleet: the fused SQP over R independent
    batches, then ONE deferred compacted repair over all R B lanes with the
    per-problem float32 SQP, seeded at the fused iterate. `solver(dx0 (R, B,
    n), windows (R, B, ...), z_ws (R, B, nz))` -> (z (R, B, nz), conv (R, B))
    casts to float32 on the solver's device; `raw` takes float32 tensors as
    they are. Every solve is final when the call returns: a solve service,
    not a closed loop (that is HybridSolver's)."""

    def __init__(self, qp: CondensedQP, A, B, Ks, w: LBMPCWeights,
                 sqp_iters: int = 2, ipm_iters=16, repair_frac: float = 1.0 / 128.0,
                 repair_sqp_iters: int = 1, repair_ipm_iters: int = 20, **kw):
        self.fused = FusedSolver(qp, A, B, Ks, w, sqp_iters=sqp_iters,
                                 ipm_iters=ipm_iters, **kw)
        self.device = self.fused.device
        model = {k: v for k, v in kw.items()
                 if k in ("family", "delta", "bandwidth", "ridge", "dx_ref")}
        self.repair = make_lbmpc_solver(qp, A, B, Ks, w, sqp_iters=repair_sqp_iters,
                                        ipm_iters=repair_ipm_iters, dtype=_F32,
                                        device=self.device, **model)
        self.repair_frac = repair_frac

    def __call__(self, dx0, windows: DataWindow, z_ws):
        dev = self.device
        return self.raw(dx0.to(dev, _F32), windows.to(_F32, dev), z_ws.to(dev, _F32))

    def raw(self, dx0, windows: DataWindow, z_ws):
        R, Bsz = dx0.shape[:2]
        total = R * Bsz
        outs = [self.fused.raw(dx0[r], windows.index(r), z_ws[r]) for r in range(R)]
        z = torch.stack([o[0] for o in outs])
        conv = torch.stack([o[1] for o in outs])
        flat = lambda a: a.reshape((total,) + a.shape[2:])
        K = max(1, min(total, int(round(total * self.repair_frac))))
        zf, convf = repair_lanes(self.repair, K, True, flat(z), flat(conv), flat(dx0),
                                 DataWindow(*(flat(a) for a in windows)), flat(z_ws))
        return zf.reshape(z.shape), convf.reshape(conv.shape)


def make_lbmpc_solver_fleet(qp: CondensedQP, A, B, Ks, w: LBMPCWeights,
                            **kw) -> FleetSolver:
    """The reference factory's name for FleetSolver."""
    return FleetSolver(qp, A, B, Ks, w, **kw)
