"""Typed configuration for plant, OCP, solver, and batching.

The reference copy-pastes constant blocks into every example script (e.g.
examples/LBMPC_RunExample.m:22-56 vs examples/DMS_LBMPC_casadi.m:29-94); here a
single frozen dataclass tree holds them once, with presets reproducing each
reference scenario.

The plant constants live here (not in models/mgcm.py) so that the
configuration surface imports numpy only.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

# Physical constants (ref: models/trueModel.m:32-35)
WN2 = 1000.0          # wn^2, wn = sqrt(1000) resonant frequency
TWO_ZETA_WN = float(2.0 * (1.0 / np.sqrt(2.0)) * np.sqrt(1000.0))  # 2*zeta*wn = sqrt(2000)
BETA2 = 1.0           # beta^2
X2_C = 0.0            # pressure constant

# Equilibrium / working point (ref: functions/mgcmDLTI.m:27-30, examples/DMS_LBMPC_casadi.m:76-77)
MGCM_EQ_X = np.array([0.5, 1.6875, 1.1547, 0.0])
MGCM_EQ_U = 1.1547

TS = 0.01  # sampling time (ref: functions/mgcmDLTI.m:37)

# 2-state Moore-Greitzer reduction (BASELINE config 1): same operating point
MG2_EQ_X = np.array([0.5, 1.6875])
MG2_EQ_U = MGCM_EQ_U  # 1.1547 = throttle opening at the operating point


@dataclasses.dataclass(frozen=True)
class MGCMConfig:
    """Plant-side constants (ref: examples/LBMPC_RunExample.m:22-56).

    model="mg2" selects the 2-state Moore-Greitzer reduction (throttle as
    direct input; BASELINE config 1) — override the box/working-point tuples
    with 2-vectors (see the MG2_* presets).
    """

    ts: float = TS
    # box constraints (absolute coordinates)
    x_min: tuple = (0.0, 1.1875, 0.1547, -20.0)
    x_max: tuple = (1.0, 2.1875, 2.1547, 20.0)
    u_min: float = 0.1547
    u_max: float = 2.1547
    # working point / equilibrium
    x_wp: tuple = tuple(MGCM_EQ_X)
    u_wp: float = MGCM_EQ_U
    # uncertainty bound (ref: LBMPC_RunExample.m:38)
    state_uncert: tuple = (0.02, 5e-4, 0.0, 0.0)
    # tube-certified residual disturbance (robust_tube presets): the bound the
    # Ks-consistent mRPIS absorbs. Defaults to state_uncert when None; the MG2
    # robust preset sets it to the measured near-equilibrium linearization
    # error ceiling (1.07e-4 at |dx|<0.1, rk23 vs DLTI; 1.5e-4 with margin) —
    # the post-oracle residual the tube actually needs to cover, since the
    # full state_uncert overruns the input budget on this plant for ANY
    # stabilizing gain (|Ks e| > 2 at the gentlest viable poles).
    tube_uncert: tuple | None = None
    model: Literal["mgcm4", "mg2"] = "mgcm4"

    @property
    def n(self) -> int:
        return len(self.x_wp)

    @property
    def m(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class OCPConfig:
    """OCP-side constants (ref: functions/matOCP.m, examples/*)."""

    N: int = 50
    poles: tuple = (0.75, 0.78, 0.98, 0.99)
    T: float = 1000.0
    # terminal-set application step: the reference applies the terminal set at
    # k=1 in LBMPC variants (constraintsLBMPC.m:26-31) and k=N in LMPC/NMPC
    # (constraintsLMPC.m:36-38) — both preserved behind this switch.
    terminal_at: Literal["first", "last"] = "last"
    tighten_first_step: bool = False  # F_x_d at k=1 (LBMPC robust variants)
    # Ks-consistent disturbance-invariant tube (sets/terminal.py
    # get_cons_robust_ks) instead of the reference's K_t-based robust stack —
    # the construction that actually contracts on the MG2 reduction
    robust_tube: bool = False
    # Regulation-to-equilibrium variants (ref: regular_NMPC_casadi.m,
    # regular_LMPC_casadi.m): theta pinned at 0, hard-coded terminal cost
    # REG_P, and — when ellipsoid_alpha is set — the quadratic terminal
    # region (x - x_eq)' P (x - x_eq) <= alpha (regular_NMPC_casadi.m:48-53).
    regulation: bool = False
    ellipsoid_alpha: float | None = None


# Hard-coded regulation terminal cost/region matrix
# (ref: examples/regular_NMPC_casadi.m:48-53, = examples/regular_LMPC_casadi.m:91-95)
REG_P = (
    (2379.75328799635, -1408.52636933972, 586.834405598336, 2.54452796979169),
    (-1408.52636933972, 1020.35695741999, -486.636840230204, -2.14515528702556),
    (586.834405598336, -486.636840230204, 376.289369319808, 1.71242577067112),
    (2.54452796979169, -2.14515528702556, 1.71242577067112, 1.01279182904087),
)


@dataclasses.dataclass(frozen=True)
class OracleConfig:
    """Nadaraya-Watson oracle (ref: functions/oracleL2NW.m:9-10, ocpLBMPC.m:19)."""

    q: int = 100          # moving-window size
    bandwidth: float = 0.5
    ridge: float = 0.001
    d_in: int = 3         # xi = [dx1; dx2; du]
    d_out: int = 4


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Device solver knobs: fixed iteration counts keep every lane in step."""

    ipm_iters: int = 25
    ipm_tol: float = 1e-9         # used for masking, not for early exit
    sqp_iters: int = 4
    # "mixed": f32 IPM + f64 warm-started refinement (ops.ipm.solve_qp_mixed)
    # — f32 device speed with <1e-5 solution error (ROADMAP perf item 3)
    dtype: Literal["float32", "float64", "mixed"] = "float64"
    plant_integrator: Literal["rk4", "rk23", "rk4_fine"] = "rk23"
    # NMPC prediction-model transcription: substepped RK4 of the true ODE,
    # implicit Legendre collocation (ref: collocation_regular_NMPC_test.m),
    # or the nominal DLTI (the regulation-LMPC model, regular_LMPC_casadi.m)
    nmpc_prediction: Literal["rk4", "collocation", "dlti"] = "rk4"
    # QP backend for the LMPC path. "condensed" (default) eliminates states
    # up front — best at short horizons. "sparse" keeps the stage form and
    # factors each Newton system by a Riccati sweep (ops/sparse_ipm) — wins
    # for long horizons; "sparse_parallel" uses the associative-scan Riccati
    # (O(log N) depth). Casadi-family tracking semantics only.
    qp_backend: Literal["condensed", "sparse", "sparse_parallel"] = "condensed"


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    """A full closed-loop scenario = plant + OCP + oracle + solver + episode."""

    name: str
    plant: MGCMConfig
    ocp: OCPConfig
    oracle: OracleConfig
    solver: SolverConfig
    controller: Literal["lmpc", "lbmpc", "nmpc"] = "lmpc"
    # "casadi_k": the explicit-prestabilization split u = Ks x + c of
    # DMS_tracking_LMPC_casadi_K.m (condensed.build_casadi_dms_k)
    family: Literal["fmincon", "casadi", "casadi_k"] = "fmincon"
    # BASELINE config 2: LBMPC with a FIXED (pretrained) oracle — no online
    # window updates; pair with a pretrained window via oracle_pretrain_npz
    learn_online: bool = True
    # collect oracle data even when the controller does not consume it —
    # the LBMPC_casadi.m variant optimizes against the NOMINAL dynamics
    # (its learned constraint is commented out at :292-293) while still
    # acquiring the oracle window every step (:195-198)
    collect_data: bool = False
    iterations: int = 1000
    # fmincon family: delta-coordinate init (ref: LBMPC_RunExample.m:41-44)
    dx_init: tuple = (-0.35, -0.4, 0.0, 0.0)
    dx_ref: tuple = (0.0, 0.0, 0.0, 0.0)
    # casadi family: absolute init (ref: DMS_LBMPC_casadi.m:94)
    x_init_abs: tuple = (0.15, 1.2875, 1.1547, 0.0)


_PRESETS = {}


def _register(s: ScenarioConfig) -> ScenarioConfig:
    _PRESETS[s.name] = s
    return s


def make_preset(name: str, **overrides) -> ScenarioConfig:
    """Presets reproducing the reference scenarios (BASELINE.json configs)."""
    if not _PRESETS:
        base_plant = MGCMConfig()
        base_oracle = OracleConfig()
        base_solver = SolverConfig()
        for N in (20, 40, 50, 60, 80, 100):
            _register(
                ScenarioConfig(
                    name=f"LMPC_N{N}", plant=base_plant,
                    ocp=OCPConfig(N=N, terminal_at="last"),
                    oracle=base_oracle, solver=base_solver,
                    controller="lmpc", family="fmincon",
                )
            )
            _register(
                ScenarioConfig(
                    name=f"LBMPC_N{N}", plant=base_plant,
                    ocp=OCPConfig(N=N, terminal_at="first", tighten_first_step=True),
                    oracle=base_oracle, solver=base_solver,
                    controller="lbmpc", family="fmincon",
                )
            )
            _register(
                ScenarioConfig(
                    name=f"NMPC_N{N}", plant=base_plant,
                    ocp=OCPConfig(N=N, terminal_at="last"),
                    oracle=base_oracle, solver=base_solver,
                    controller="nmpc", family="fmincon",
                )
            )
        for q in (10, 50, 100, 200, 500):
            _register(
                ScenarioConfig(
                    name=f"DMS_LBMPC_q{q}", plant=base_plant,
                    ocp=OCPConfig(N=100, terminal_at="first", tighten_first_step=True),
                    oracle=OracleConfig(q=q),
                    solver=dataclasses.replace(base_solver, plant_integrator="rk4"),
                    controller="lbmpc", family="casadi", iterations=500,
                )
            )
        # BASELINE config 1: nominal linear tracking MPC on the 2-state
        # Moore-Greitzer model, N=20, box input/state constraints
        mg2_plant = MGCMConfig(
            x_min=(0.0, 1.1875), x_max=(1.0, 2.1875),
            x_wp=tuple(MG2_EQ_X), u_wp=MG2_EQ_U,
            state_uncert=(0.02, 5e-4), model="mg2",
        )
        mg2_oracle = OracleConfig(d_out=2)
        _register(
            ScenarioConfig(
                name="MG2_LMPC_N20", plant=mg2_plant,
                ocp=OCPConfig(N=20, poles=(0.75, 0.78), terminal_at="last"),
                oracle=mg2_oracle, solver=base_solver,
                controller="lmpc", family="fmincon",
                dx_init=(-0.35, -0.4), dx_ref=(0.0, 0.0),
                x_init_abs=(0.15, 1.2875),
            )
        )
        # NOTE: the reference's LBMPC constraint quirks (K_t-based robust
        # terminal set applied at k=1, getCONSPOLY.m:38-69) destabilize the
        # reduced plant: its linearization has unstable complex poles and the
        # K_t set does not contract under the actual Ks prestabilizer — the
        # closed loop limit-cycles along the state box. The MG2 preset uses
        # the standard layout instead: Ks-consistent MPIS terminal set at k=N
        # (verified converging; see test_mg2_lbmpc_converges).
        _register(
            ScenarioConfig(
                name="MG2_LBMPC_N20", plant=mg2_plant,
                ocp=OCPConfig(N=20, poles=(0.75, 0.78), terminal_at="last",
                              tighten_first_step=False),
                oracle=mg2_oracle, solver=base_solver,
                controller="lbmpc", family="fmincon",
                dx_init=(-0.35, -0.4), dx_ref=(0.0, 0.0),
                x_init_abs=(0.15, 1.2875),
            )
        )
        # MG2 robust variant: Ks-consistent tube (ROADMAP robustness item 10)
        # — mRPIS tube around the actual prestabilizer, tightened stage sets,
        # Ks-consistent terminal MPIS. The true-plant model error acts as the
        # bounded disturbance.
        _register(
            ScenarioConfig(
                name="MG2_LBMPC_N20_robust",
                plant=dataclasses.replace(mg2_plant,
                                          tube_uncert=(1.5e-4, 1.5e-4)),
                ocp=OCPConfig(N=20, poles=(0.75, 0.78), terminal_at="last",
                              robust_tube=True),
                oracle=mg2_oracle, solver=base_solver,
                controller="lbmpc", family="fmincon",
                dx_init=(-0.35, -0.4), dx_ref=(0.0, 0.0),
                x_init_abs=(0.15, 1.2875),
            )
        )
        _register(
            ScenarioConfig(
                name="DMS_LMPC", plant=base_plant,
                ocp=OCPConfig(N=50, terminal_at="last"),
                oracle=base_oracle,
                solver=dataclasses.replace(base_solver, plant_integrator="rk4"),
                controller="lmpc", family="casadi", iterations=500,
            )
        )
        # LBMPC_casadi.m (MX single-shooting-ish variant): cost rolls out the
        # NOMINAL dynamics (the learned constraint is commented out in the
        # reference, :292-293) while the oracle window is still acquired
        # online (:195-198) — i.e. tracking LMPC + data collection.
        _register(
            ScenarioConfig(
                name="MX_LBMPC", plant=base_plant,
                ocp=OCPConfig(N=100, terminal_at="first",
                              tighten_first_step=True),
                oracle=base_oracle,
                solver=dataclasses.replace(base_solver, plant_integrator="rk4"),
                controller="lmpc", family="casadi", iterations=500,
                collect_data=True,
            )
        )
        # Explicit-c decision split (ref: DMS_tracking_LMPC_casadi_K.m:78-87
        # — N = N_t/delta = 100, 500 iterations, y = [x; c; u; theta] with
        # u = Kstabil x + c as an equality; condensed exactly in
        # controllers/condensed.build_casadi_dms_k)
        _register(
            ScenarioConfig(
                name="DMS_LMPC_K", plant=base_plant,
                ocp=OCPConfig(N=100, terminal_at="last"),
                oracle=base_oracle,
                solver=dataclasses.replace(base_solver, plant_integrator="rk4"),
                controller="lmpc", family="casadi_k", iterations=500,
            )
        )
        # Regulation presets (ref: regular_NMPC_casadi.m / regular_LMPC_casadi.m
        # — N = T/delta = 100, x_init = [0.15;1.2875;1.1547;0], Q = R = I,
        # terminal cost REG_P). The ellipsoidal region alpha=0.7 is defined at
        # regular_NMPC_casadi.m:48-53 but its application is COMMENTED OUT in
        # the reference run (:220-222) — and measurably so: from this x_init
        # the unconstrained N=100 optimum terminates at x'Px ~ 26-39 >> 0.7,
        # i.e. the hard region is infeasible during the transient. The preset
        # therefore matches the executed reference (ellipsoid_alpha=None);
        # setting ellipsoid_alpha enables the region as an elastic
        # nonlinear-constraint row (tests/test_regulation.py exercises it).
        _register(
            ScenarioConfig(
                name="REG_NMPC", plant=base_plant,
                ocp=OCPConfig(N=100, terminal_at="last", regulation=True),
                oracle=base_oracle,
                solver=dataclasses.replace(base_solver, plant_integrator="rk4"),
                controller="nmpc", family="casadi", iterations=500,
            )
        )
        _register(
            ScenarioConfig(
                name="REG_LMPC", plant=base_plant,
                ocp=OCPConfig(N=100, terminal_at="last", regulation=True),
                oracle=base_oracle,
                solver=dataclasses.replace(base_solver, plant_integrator="rk4",
                                           nmpc_prediction="dlti"),
                controller="nmpc", family="casadi", iterations=600,
            )
        )
    cfg = _PRESETS[name]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
