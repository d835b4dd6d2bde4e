"""Scenario assembly: preset -> host matrices -> solver and episodes.

Port of lbmpc_tpu/runtime/scenario.py: `build_scenario` does the host setup
(DLTI, matOCP synthesis, the constraint set, the condensed QP, the
Gauss-Newton weights) of an LMPC, LBMPC or NMPC preset of the fmincon,
casadi or casadi_k family, and its Scenario builds, at first use, the
per-problem solver (controllers/lmpc on ops/ipm,
controllers/lbmpc.make_lbmpc_solver, or controllers/nmpc.make_nmpc_solver
with the tracking and regulation presets) and the single-scenario episodes
on the `condensed` backend (ref: examples/LBMPC_RunExample.m:10-107,
DMS_LBMPC_casadi.m:13-160). The stage-wise backends serve long horizons:
qp_backend="sparse" runs the casadi-family tracking LMPC on ops/sparse_ipm
and the LBMPC SQP's subproblems on ops/sparse_gn
(controllers/lbmpc.make_lbmpc_solver_sparse); "sparse_parallel" runs the
LMPC on the associative-scan Riccati. On CUDA their solves replay a CUDA
graph (graph_solve). `build_fleet_episode` runs a fmincon-family cohort
through the batch-level SQP.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from lbmpc_tpu_torch.config import REG_P, ScenarioConfig, make_preset
from lbmpc_tpu_torch.controllers.condensed import (CondensedQP, build_casadi_dms,
                                                   build_casadi_dms_k,
                                                   build_fmincon_lmpc)
from lbmpc_tpu_torch.controllers.lbmpc import (LBMPCWeights, make_casadi_warm_start,
                                               make_lbmpc_solver,
                                               make_lbmpc_solver_sparse)
from lbmpc_tpu_torch.controllers.lmpc import make_lmpc_solver
from lbmpc_tpu_torch.controllers.nmpc import _Graphed, make_nmpc_solver
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.models.mgcm import (mg2_dlti, mg2_ode, mgcm_dlti, rk4_step,
                                         rk23_step)
from lbmpc_tpu_torch.ops.sparse_ipm import make_stage_qp, peak_bytes, solve_sparse
from lbmpc_tpu_torch.oracle import DataWindow, init_window
from lbmpc_tpu_torch.runtime.closed_loop import (ClosedLoopResult, run_closed_loop,
                                                 run_closed_loop_batched)
from lbmpc_tpu_torch.sets.terminal import (ConstraintSet, get_cons,
                                           get_cons_poly, get_cons_robust_ks)
from lbmpc_tpu_torch.synthesis import OCPMatrices, mat_ocp


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Assembled scenario: the host matrices, constraint set, condensed QP
    and weights, and — built at first use on `device` — the per-step solver
    and the episodes:
    - solve(dx (B, n), window, z_ws (B, nz)) -> (z, converged), batched;
    - episode_from(dx_init (n,), window0, z0 (nz,), steps=cfg.iterations),
      episode_with_window(dx_init, window0) and episode(dx_init): one
      scenario's ClosedLoopResult (histories without a lane axis);
    - episode_from_batch(dx (B, n), window (B, ...), z (B, nz), steps=...):
      the batched counterpart of episode_from (histories batch-first);
    - run(dx_init=None) and run_batch(dx_inits (B, n)).
    The solver and episodes run in the preset's dtype (float32, or float64
    for "float64" and "mixed"); the NMPC's in float64, as the reference's."""

    cfg: ScenarioConfig
    A: np.ndarray
    B: np.ndarray
    ocp: OCPMatrices
    cs: ConstraintSet
    qp: CondensedQP
    w: LBMPCWeights
    ipm_iters: int | None = None
    device: object = None

    @property
    def nz(self) -> int:
        return self.qp.nz

    @functools.cached_property
    def _episode_parts(self) -> dict:
        return _episode_parts(self)

    @property
    def solve(self):
        return self._episode_parts["solve"]

    def episode_from(self, dx_init, window0: DataWindow, z0,
                     steps: int | None = None, x_abs=None) -> ClosedLoopResult:
        """Episode from an arbitrary carry (the resume path). x_abs: the
        absolute plant state to start from exactly (a checkpoint's), in
        place of x_wp + dx_init."""
        p = self._episode_parts
        c = lambda a: torch.as_tensor(a, dtype=p["dtype"], device=p["device"])
        return run_closed_loop(
            p["solve"], p["plant"], p["warm"], *p["consts"], c(dx_init), c(z0),
            window0.to(p["dtype"], p["device"]),
            self.cfg.iterations if steps is None else steps, learn=p["learn"],
            log_post_state=self.cfg.controller != "lbmpc",
            x_init=None if x_abs is None else c(x_abs))

    def episode_with_window(self, dx_init, window0: DataWindow) -> ClosedLoopResult:
        return self.episode_from(dx_init, window0, torch.zeros(self.nz))

    def episode(self, dx_init) -> ClosedLoopResult:
        p = self._episode_parts
        return self.episode_with_window(
            dx_init, init_window(self.cfg.oracle.q, d_out=self.cfg.oracle.d_out,
                                 dtype=p["dtype"], device=p["device"]))

    def _default_dx(self):
        if self.cfg.family == "casadi":
            return np.asarray(self.cfg.x_init_abs) - np.asarray(self.cfg.plant.x_wp)
        return np.asarray(self.cfg.dx_init)

    def run(self, dx_init=None) -> ClosedLoopResult:
        """One episode; the default initial state follows the family's
        convention (fmincon: delta dx_init; casadi: absolute x_init)."""
        return self.episode(self._default_dx() if dx_init is None else dx_init)

    def run_batch(self, dx_inits) -> ClosedLoopResult:
        """Independent episodes from the rows of dx_inits (B, n), advanced
        together (histories batch-first, as the reference's vmap), from the
        initial window and a zero warm start."""
        p = self._episode_parts
        Bsz = len(dx_inits)
        win = init_window(self.cfg.oracle.q, d_out=self.cfg.oracle.d_out,
                          dtype=p["dtype"], batch=(Bsz,), device=p["device"])
        return self.episode_from_batch(dx_inits, win, torch.zeros(Bsz, self.nz))

    def episode_from_batch(self, dx, window: DataWindow, z,
                           steps: int | None = None, x_abs=None) -> ClosedLoopResult:
        """Independent episodes from a batched carry (the batched resume
        path): dx (B, n), a window with the lane axis B leading, z (B, nz),
        and optionally x_abs (B, n) as in episode_from. sparse_parallel
        refuses a batch whose associative scan would not fit
        the card (sparse_parallel_limit)."""
        p = self._episode_parts
        c = lambda a: torch.as_tensor(a, dtype=p["dtype"], device=p["device"])
        dx = c(dx)
        if self.cfg.solver.qp_backend == "sparse_parallel":
            limit = sparse_parallel_limit(self, p["device"], p["dtype"])
            lane_stages = dx.shape[0] * self.cfg.ocp.N
            if limit is not None and lane_stages > limit:
                raise ValueError(
                    f"sparse_parallel: batch x N = {lane_stages} lane-stages "
                    f"exceeds the {limit} this device's memory holds "
                    f"({SPARSE_PARALLEL_MARGIN:.0%} of it for the solve); use "
                    "qp_backend='sparse' for large batches")
        return run_closed_loop_batched(
            p["solve"], p["plant"], p["warm"], *p["consts"], dx, c(z),
            window.to(p["dtype"], p["device"]),
            self.cfg.iterations if steps is None else steps, learn=p["learn"],
            log_post_state=self.cfg.controller != "lbmpc",
            x_init=None if x_abs is None else c(x_abs))


# The share of the card's memory a sparse_parallel batch may fill with its
# solve (the rest: the closed loop's histories, the allocator's slack and
# other work on the card).
SPARSE_PARALLEL_MARGIN = 0.5


def _device_memory(dev) -> int | None:
    """The card's memory in bytes; None off CUDA (no guard)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).total_memory


def sparse_parallel_limit(sc: Scenario, dev, dtype) -> int | None:
    """The most lane-stages (batch x N) a sparse_parallel solve may run on
    `dev`: SPARSE_PARALLEL_MARGIN of the card's memory over the solve's peak
    bytes per lane-stage (ops/sparse_ipm.peak_bytes: the associative scan's
    five element arrays at every level of its recursion, and the IPM's state
    beside them; chip_smoke.py holds the model to torch.cuda's peak at two
    batch sizes: the allocator's peak was 0.72 of the model at B = 256 and
    1024). On an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (85,017,493,504
    bytes) that is 5,600,050 lane-stages in float64 at N=50 (112,001 lanes)
    and 11,200,150 in float32 (chip_smoke.py phase 34); None off CUDA. The
    reference's limit (51,200) was a TPU worker's envelope and is not
    carried over."""
    total = _device_memory(dev)
    if total is None:
        return None
    N, n, m = sc.cfg.ocp.N, sc.qp.n, sc.qp.m
    itemsize = torch.empty((), dtype=dtype).element_size()
    rows = (len(sc.cs.h_x), len(sc.cs.h_u), len(sc.cs.h_w_N))
    per_lane = peak_bytes(1, N, n, m, np.atleast_2d(sc.ocp.LAMBDA).shape[1], rows,
                          itemsize, parallel=True)
    return int(SPARSE_PARALLEL_MARGIN * total // per_lane) * N


def graph_solve(solve, dtype, dev, window: bool):
    """A stage-wise backend's solve on CUDA, captured in a CUDA graph at its
    first call for each batch size and replayed after (controllers/nmpc
    ._Graphed): a solve is ~10^5 small operations in sequence, which the
    host's dispatch would otherwise bound, and none of them reads the
    device (the 1 x 1 Riccati and Schur pivots are divisions, the scan's
    linear solves check nothing on the host). window=False for the LMPC,
    which reads dx alone. The eager solve stays as `.eager`, on the same
    device."""

    def unpack(dx, *rest):
        return solve(dx, DataWindow(*rest[:4]), rest[4]) if window else solve(dx, None, None)

    g = _Graphed(lambda *a: (unpack(*a), torch.zeros((), dtype=torch.bool, device=dev)),
                 unpack)

    def graphed(dx, win, z_ws):
        dx = dx.to(dev, dtype)
        if not window:
            return g(dx)
        return g(dx, *win.to(dtype, dev), z_ws.to(dev, dtype))

    graphed.eager = solve
    return graphed


def check_backend(cfg: ScenarioConfig) -> None:
    """The reference's build-time refusals of a qp_backend
    (ref: scenario.py:79-96, :168-176): the stage-wise backends serve LMPC
    ('sparse', 'sparse_parallel'; the casadi-family tracking form with the
    terminal set at x_N and no tightened first step) and LBMPC ('sparse');
    not NMPC, and not dtype='mixed'."""
    backend = cfg.solver.qp_backend
    if backend == "condensed":
        return
    if backend not in ("sparse", "sparse_parallel"):
        raise ValueError(f"qp_backend={backend!r}")
    if cfg.controller == "nmpc" or (cfg.controller == "lbmpc"
                                    and backend == "sparse_parallel"):
        raise ValueError(
            f"qp_backend={backend!r} is not supported for "
            f"controller={cfg.controller!r}; sparse LBMPC uses "
            "qp_backend='sparse', NMPC uses 'condensed'")
    if cfg.solver.dtype == "mixed":
        raise ValueError(
            "dtype='mixed' (f32 IPM + f64 refinement) is a condensed-path "
            "feature; use dtype='float32' or 'float64' with sparse backends")
    if cfg.controller == "lmpc" and (cfg.family != "casadi" or cfg.ocp.terminal_at != "last"
                                     or cfg.ocp.tighten_first_step):
        raise ValueError(
            "sparse QP backend supports casadi-family tracking LMPC "
            "(terminal_at='last', tighten_first_step=False)")


def _episode_parts(sc: Scenario) -> dict:
    """The solver, plant, warm start and loop constants of build_scenario's
    episodes (ref: scenario.py:165-272), on the condensed or a stage-wise
    backend."""
    cfg, p = sc.cfg, sc.cfg.plant
    backend = cfg.solver.qp_backend
    dev = resolve_device(sc.device)
    mixed = cfg.solver.dtype == "mixed"
    dtype = (torch.float32 if cfg.solver.dtype == "float32" and cfg.controller != "nmpc"
             else torch.float64)
    ipm = sc.ipm_iters or cfg.solver.ipm_iters
    plant_ode = mg2_ode if p.model == "mg2" else None
    if cfg.family == "fmincon":
        plant = lambda x, u: rk23_step(x, u[:, 0], p.ts, ode=plant_ode)
    else:
        plant = lambda x, u: rk4_step(x, u[:, 0], p.ts, substeps=1, ode=plant_ode)
    warm = lambda z, dx_used, dx_next, window: z
    if cfg.family == "casadi":
        warm = make_casadi_warm_start(sc.qp, sc.A, sc.B, sc.ocp.Ks, dtype=dtype, device=dev)
    if cfg.controller == "lmpc":
        if backend != "condensed":
            # the stage-form Riccati IPM: the casadi-family tracking OCP with
            # the terminal set at x_N and no first-step tightening
            # (check_backend)
            stage_qp = make_stage_qp(sc.A, sc.B, sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T,
                                     sc.ocp.LAMBDA, sc.ocp.PSI, sc.cs, cfg.ocp.N,
                                     delta=p.ts, dtype=dtype, device=dev)
            par = backend == "sparse_parallel"

            def solve(dx, window, z_ws):
                sol = solve_sparse(stage_qp, dx, iters=ipm, parallel=par)
                return torch.cat([sol.U.flatten(1), sol.theta], dim=1), sol.converged

            if dev.type == "cuda":
                solve = graph_solve(solve, dtype, dev, window=False)
        else:
            lin_solve = make_lmpc_solver(sc.qp, ipm_iters=ipm, dtype=dtype, mixed=mixed,
                                         device=dev)

            def solve(dx, window, z_ws):
                z, sol = lin_solve(dx)
                return z, sol.converged

        # LMPC ignores the window; the MX_LBMPC variant still collects data
        learn = cfg.collect_data
    elif cfg.controller == "nmpc":
        solve = make_nmpc_solver(
            sc.cs, sc.ocp.Ks, sc.w, cfg.ocp.N, p.ts, np.asarray(p.x_wp), p.u_wp,
            family=cfg.family, dx_ref=np.asarray(cfg.dx_ref),
            sqp_iters=cfg.solver.sqp_iters, ipm_iters=ipm,
            prediction=cfg.solver.nmpc_prediction, AB=(sc.A, sc.B),
            regulation=cfg.ocp.regulation,
            P_term=np.asarray(REG_P) if cfg.ocp.regulation else None,
            ellipsoid_alpha=cfg.ocp.ellipsoid_alpha, dtype=dtype, device=dev)
        learn = False
    elif backend == "sparse":
        solve = make_lbmpc_solver_sparse(
            sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, sc.cs, family=cfg.family, delta=p.ts,
            bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
            dx_ref=np.asarray(cfg.dx_ref), sqp_iters=cfg.solver.sqp_iters, ipm_iters=ipm,
            terminal_at=cfg.ocp.terminal_at,
            tighten_first_step=cfg.ocp.tighten_first_step, dtype=dtype, device=dev)
        if dev.type == "cuda":
            solve = graph_solve(solve, dtype, dev, window=True)
        learn = cfg.learn_online
    else:
        solve = make_lbmpc_solver(
            sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family=cfg.family, delta=p.ts,
            bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
            dx_ref=np.asarray(cfg.dx_ref), sqp_iters=cfg.solver.sqp_iters, ipm_iters=ipm,
            dtype=dtype, mixed=mixed, device=dev)
        learn = cfg.learn_online
    t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
    Ks_eff = (sc.ocp.Ks if cfg.family in ("fmincon", "casadi_k")
              else np.zeros_like(sc.ocp.Ks))
    consts = (t(np.atleast_2d(Ks_eff)), t(sc.A), t(sc.B), t(sc.ocp.LAMBDA), t(p.x_wp),
              t([p.u_wp]))
    return dict(solve=solve, plant=plant, warm=warm, learn=learn, consts=consts,
                dtype=dtype, device=dev)


def build_scenario(name_or_cfg, ipm_iters: int | None = None, device=None) -> Scenario:
    """An LMPC, LBMPC or NMPC preset: the host setup now, the solver and
    episodes (on `device`, CUDA unless named) at first use. ipm_iters
    overrides the preset's IPM iteration count, as in the reference."""
    cfg = (name_or_cfg if isinstance(name_or_cfg, ScenarioConfig)
           else make_preset(name_or_cfg))
    if cfg.controller not in ("lbmpc", "lmpc", "nmpc"):
        raise ValueError(f"controller={cfg.controller!r}")
    check_backend(cfg)
    p = cfg.plant
    mg2 = p.model == "mg2"
    A, B, C, _ = (mg2_dlti if mg2 else mgcm_dlti)(p.ts)
    ocp = mat_ocp(A, B, C, poles=cfg.ocp.poles, T=cfg.ocp.T)
    common = dict(x_min=p.x_min, x_max=p.x_max, u_min=p.u_min, u_max=p.u_max,
                  x_wp=p.x_wp, u_wp=p.u_wp)
    if cfg.ocp.robust_tube:
        cs = get_cons_robust_ks(
            **common, state_uncert=p.tube_uncert or p.state_uncert,
            A=A, B=B, Ks=ocp.Ks, LAMBDA=ocp.LAMBDA, PSI=ocp.PSI,
            LAMBDA_0=ocp.LAMBDA_0, PSI_0=ocp.PSI_0)
    elif cfg.ocp.tighten_first_step:
        cs = get_cons_poly(
            **common, state_uncert=p.state_uncert, A=A, B=B, Q=ocp.Q, R=ocp.R,
            LAMBDA=ocp.LAMBDA, PSI=ocp.PSI, LAMBDA_0=ocp.LAMBDA_0,
            PSI_0=ocp.PSI_0)
    else:
        cs = get_cons(
            **common, A=A, B=B, K=ocp.Ks, LAMBDA=ocp.LAMBDA, PSI=ocp.PSI,
            LAMBDA_0=ocp.LAMBDA_0, PSI_0=ocp.PSI_0)
    mats = (ocp.Q, ocp.R, ocp.P, ocp.T, ocp.LAMBDA, ocp.PSI, cs, cfg.ocp.N)
    if cfg.family == "fmincon":
        qp = build_fmincon_lmpc(
            A, B, ocp.Ks, *mats, dx_ref=np.asarray(cfg.dx_ref),
            terminal_at=cfg.ocp.terminal_at,
            tighten_first_step=cfg.ocp.tighten_first_step)
    elif cfg.family == "casadi_k":
        qp = build_casadi_dms_k(A, B, ocp.Ks, *mats, delta=p.ts)
    else:
        qp = build_casadi_dms(A, B, *mats, delta=p.ts,
                              terminal_at=cfg.ocp.terminal_at,
                              tighten_first_step=cfg.ocp.tighten_first_step)
    w = LBMPCWeights.make(ocp.Q, ocp.R, ocp.P, ocp.T, ocp.LAMBDA, ocp.PSI)
    return Scenario(cfg=cfg, A=A, B=B, ocp=ocp, cs=cs, qp=qp, w=w, ipm_iters=ipm_iters,
                    device=device)


def build_fleet_episode(name_or_cfg, ipm_iters=None,
                        sqp_iters: int | None = None,
                        backend: str = "fused",
                        repair_frac: float = 1.0 / 85.0,
                        qp_kernel: str = "xla",
                        alphas=None,
                        qp_warm: bool = False,
                        warm_chain: bool = False,
                        device=None,
                        plain: bool = False,
                        mesh=None):
    """Batch-level fmincon-family LBMPC episode (float32).

    Returns (scenario, run) with run(dx_init (B, n)) -> ClosedLoopResult,
    histories batch-first. As in the reference, the route decides the rest:
    qp_kernel="xla" (the default: ops/ipm_fused on the K5 kernels) keeps the
    solver's Armijo ladder unless `alphas` is given and ignores qp_warm;
    the kernel routes — "pallas" (plain GN phase + K2), "pallas_full" (K1 +
    K2) and "pallas_mono" (K3, which ignores qp_warm) — take the ladder
    ((1,), (1, .5, .25)) and qp_warm. backend="hybrid" adds the compacted
    per-step repair (1 GN x 8 IPM, seeded at the fused iterate): the fused
    repair on "pallas_full", the vmapped one (controllers/lbmpc
    .make_lbmpc_solver on ops/ipm) on every other route. warm_chain
    threads K2's interior state across steps (needs qp_warm on "pallas" or
    "pallas_full"). plain=True runs
    the kernels' plain versions on the same device — the reference route for
    comparisons on the card. mesh: a scenario mesh (runtime/sharding) whose
    shards split every solve (sharding.split_solver: the fused solve per
    shard, the hybrid's repair over the whole batch); the episode carries
    it as `run.mesh`, so the mesh runners hand it their lanes whole. The
    solver's (FusedSolver) and the closed loop's products take forms whose
    lanes do not depend on the batch's size, so that on pallas_full a split
    fleet equals the whole one bit for bit.
    """
    from lbmpc_tpu_torch.controllers.sqp_fused import (make_lbmpc_solver_fused,
                                                       make_lbmpc_solver_hybrid)

    cfg = (name_or_cfg if isinstance(name_or_cfg, ScenarioConfig)
           else make_preset(name_or_cfg))
    if cfg.controller != "lbmpc" or cfg.family != "fmincon":
        raise ValueError("fused fleet episodes support fmincon-family LBMPC only")
    if backend not in ("fused", "hybrid"):
        raise ValueError(f"backend={backend!r}")
    if warm_chain and not (qp_warm and qp_kernel in ("pallas", "pallas_full")):
        raise ValueError("warm_chain needs qp_warm=True and a kernel route with "
                         "K2 (qp_kernel='pallas' or 'pallas_full')")
    sc = build_scenario(cfg)
    dev = resolve_device(device)
    p = cfg.plant
    plant_ode = mg2_ode if p.model == "mg2" else None
    extra = dict(qp_kernel=qp_kernel)
    if qp_kernel != "xla":
        extra.update(alphas=alphas or ((1.0,), (1.0, 0.5, 0.25)), qp_warm=qp_warm)
    elif alphas is not None:
        extra.update(alphas=alphas)
    if backend == "hybrid":
        factory = make_lbmpc_solver_hybrid
        extra.update(repair_frac=repair_frac, repair_sqp_iters=1,
                     repair_ipm_iters=8, repair_warm="fused",
                     repair_backend="fused" if qp_kernel == "pallas_full" else "vmapped")
    else:
        factory = make_lbmpc_solver_fused
    solver = factory(
        sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family="fmincon", delta=p.ts,
        bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
        dx_ref=np.asarray(cfg.dx_ref),
        sqp_iters=sqp_iters or cfg.solver.sqp_iters,
        ipm_iters=ipm_iters or cfg.solver.ipm_iters,
        device=dev, plain=plain, **extra)
    if mesh is not None:
        from lbmpc_tpu_torch.runtime.sharding import split_solver

        solver = split_solver(mesh, solver)
    f32 = torch.float32
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    Ks, A, B = t(np.atleast_2d(sc.ocp.Ks)), t(sc.A), t(sc.B)
    LAM, x_wp, u_wp = t(sc.ocp.LAMBDA), t(p.x_wp), t([p.u_wp])

    def plant(x, u):
        return rk23_step(x, u[:, 0], p.ts, ode=plant_ode)

    def run(dx_init) -> ClosedLoopResult:
        dx_init = torch.as_tensor(dx_init, dtype=f32, device=dev)
        B0 = dx_init.shape[0]
        windows0 = init_window(cfg.oracle.q, d_out=cfg.oracle.d_out, dtype=f32,
                               batch=(B0,), device=dev)
        chain_kw = {}
        if warm_chain:
            chain_kw = dict(qp_warm_solve=solver.raw_qpwarm,
                            qp_init_state=solver.init_qp_state)
        return run_closed_loop_batched(
            solver.raw, plant, lambda z, dxu, dxn, w_: z, Ks, A, B, LAM,
            x_wp, u_wp, dx_init, torch.zeros(B0, sc.nz, dtype=f32, device=dev),
            windows0, cfg.iterations, learn=cfg.learn_online,
            log_post_state=False, **chain_kw)

    run.solver = solver
    run.mesh = mesh
    return sc, run
