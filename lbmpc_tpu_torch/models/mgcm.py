"""Moore-Greitzer Compressor Model (MGCM): continuous ODE, integrators, DLTI.

Port of the reference plant layer to batched torch:
  - continuous dynamics  (ref: matlab/LBMPC/models/trueModel.m:20-42)
  - fixed-step RK4       (ref: examples/DMS_LBMPC_casadi.m:337-344 `dynamic`)
  - adaptive RK23 (Bogacki-Shampine pair, the algorithm behind MATLAB `ode23`,
    ref: models/trueModel.m:14-17), batched: every lane keeps its own step
    size and the masked loop runs while any lane is still short of dt.
  - exact discretization Ad = expm(A*Ts), Bd = (Ad - I) A^-1 B around the
    equilibrium (ref: functions/mgcmDLTI.m:24-41), in float64 numpy.

States are (..., n) tensors, inputs (..., 1), (...) or a Python float.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lbmpc_tpu_torch.config import (BETA2, MG2_EQ_U, MG2_EQ_X, MGCM_EQ_U,
                                    MGCM_EQ_X, TS, TWO_ZETA_WN, WN2, X2_C)


def _input(u, x: torch.Tensor) -> torch.Tensor:
    u = torch.as_tensor(u, dtype=x.dtype, device=x.device)
    if u.ndim == x.ndim:  # (..., 1) input layout
        u = u[..., 0]
    return u


def mgcm_ode(x: torch.Tensor, u) -> torch.Tensor:
    """Continuous-time MGCM dynamics f(x, u).

    x[...,0] mass flow, x[...,1] pressure rise, x[...,2] throttle opening,
    x[...,3] throttle opening rate; scalar input u (throttle command).
    Ref: models/trueModel.m:36-41.
    """
    x1, x2, x3, x4 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    u = _input(u, x)
    f1 = -x2 + X2_C + 1.0 + 3.0 * (x1 / 2.0) - (x1**3) / 2.0
    f2 = (x1 + 1.0 - x3 * torch.sqrt(x2)) / BETA2
    f3 = x4
    f4 = -WN2 * x3 - TWO_ZETA_WN * x4 + WN2 * u
    return torch.stack([f1, f2, f3, f4], dim=-1)


def mgcm_ode_jac(x: torch.Tensor) -> torch.Tensor:
    """Closed-form Jacobian of mgcm_ode in (x, u): (..., 4, 5), the last
    column d f / d u. Built from differentiable torch operations, so forward
    derivatives of a Newton solve that uses it exist (the NMPC's collocation
    prediction differentiates through its Newton iterations)."""
    x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
    r = torch.sqrt(x2)
    # the three entries that depend on x; the rest is constant
    v = torch.stack([1.5 - 1.5 * x1**2, -x3 / (2.0 * r) / BETA2, -r / BETA2], dim=-1)
    base, place = _jac_consts(x.dtype, x.device)
    return base + (v @ place).unflatten(-1, (4, 5))


@functools.lru_cache(maxsize=None)
def _jac_consts(dtype, device):
    """mgcm_ode_jac's constant part and placement, made once (a CUDA graph
    may not copy them from the host while it captures)."""
    return (torch.tensor(_JAC_BASE, dtype=dtype, device=device),
            torch.tensor(_JAC_PLACE, dtype=dtype, device=device))


_JAC_BASE = ((0.0, -1.0, 0.0, 0.0, 0.0),
             (1.0 / BETA2, 0.0, 0.0, 0.0, 0.0),
             (0.0, 0.0, 0.0, 1.0, 0.0),
             (0.0, 0.0, -WN2, -TWO_ZETA_WN, WN2))
# rows of v placed at (0, 0), (1, 1) and (1, 2)
_JAC_PLACE = tuple(tuple(1.0 if k == e else 0.0 for k in range(20))
                   for e in (0, 6, 7))


def mg2_ode(x: torch.Tensor, u) -> torch.Tensor:
    """Continuous-time 2-state Moore-Greitzer dynamics f(x, u): the throttle
    opening is the direct input (ref: models/trueModel.m:36-38)."""
    x1, x2 = x[..., 0], x[..., 1]
    u = _input(u, x)
    f1 = -x2 + X2_C + 1.0 + 3.0 * (x1 / 2.0) - (x1**3) / 2.0
    f2 = (x1 + 1.0 - u * torch.sqrt(x2)) / BETA2
    return torch.stack([f1, f2], dim=-1)


def rk4_step(x: torch.Tensor, u, dt: float, substeps: int = 1,
             ode=None) -> torch.Tensor:
    """Classic RK4 over one sample period with `substeps` sub-intervals
    (substeps=1 is the CasADi-family plant, DMS_LBMPC_casadi.m:337-344)."""
    h = dt / substeps
    f = mgcm_ode if ode is None else ode
    for _ in range(substeps):
        k1 = f(x, u)
        k2 = f(x + h / 2.0 * k1, u)
        k3 = f(x + h / 2.0 * k2, u)
        k4 = f(x + h * k3, u)
        x = x + h / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


# Bogacki-Shampine 3(2) coefficients — the pair used by MATLAB ode23.
_BS_A2 = 0.5
_BS_A3 = 0.75
_BS_B = (2.0 / 9.0, 1.0 / 3.0, 4.0 / 9.0)            # 3rd-order weights
_BS_E = (-5.0 / 72.0, 1.0 / 12.0, 1.0 / 9.0, -1.0 / 8.0)  # b3 - b2hat


def rk23_step(
    x: torch.Tensor,
    u,
    dt: float,
    rtol: float = 1e-3,
    atol: float = 1e-6,
    max_steps: int = 64,
    ode=None,
) -> torch.Tensor:
    """Integrate over [0, dt] with adaptive Bogacki-Shampine RK23 — MATLAB
    `ode23` as the fmincon-family plant step uses it (ref:
    models/trueModel.m:14-17, RelTol=1e-3, AbsTol=1e-6, hmax = 0.1 dt).

    Batched over the leading axes of x: each lane adapts its own step
    sequence with masked updates, and the loop runs while any lane is
    active. The loop test reads one flag from the device per sub-step.
    """
    fode = mgcm_ode if ode is None else ode
    threshold = atol / rtol
    hmax = 0.1 * dt
    t_end = dt * (1 - 1e-12)

    f = fode(x, u)
    scale0 = torch.clamp(x.abs(), min=threshold)
    rh = (f / scale0).abs().amax(dim=-1) / (0.8 * rtol ** (1.0 / 3.0))
    h = torch.clamp(1.0 / torch.clamp(rh, min=1e-30), max=hmax)
    t = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    y = x
    for _ in range(max_steps):
        active = t < t_end
        if not bool(active.any()):
            break
        h_eff = torch.minimum(h, dt - t)
        he = h_eff[..., None]
        k1 = f
        k2 = fode(y + he * _BS_A2 * k1, u)
        k3 = fode(y + he * _BS_A3 * k2, u)
        ynew = y + he * (_BS_B[0] * k1 + _BS_B[1] * k2 + _BS_B[2] * k3)
        k4 = fode(ynew, u)
        e = he * (_BS_E[0] * k1 + _BS_E[1] * k2 + _BS_E[2] * k3
                  + _BS_E[3] * k4)
        scale = torch.clamp(torch.maximum(y.abs(), ynew.abs()), min=threshold)
        err = (e / scale).abs().amax(dim=-1)
        accept = err <= rtol
        do = active & accept
        y = torch.where(do[..., None], ynew, y)
        f = torch.where(do[..., None], k4, f)  # FSAL
        t = torch.where(do, t + h_eff, t)
        # step-size update (MATLAB ode23 controller)
        ratio = 0.8 * (rtol / torch.clamp(err, min=1e-30)) ** (1.0 / 3.0)
        grow = h_eff * torch.clamp(ratio, max=5.0)
        shrink = h_eff * torch.clamp(ratio, min=0.1)
        h_new = torch.clamp(torch.where(accept, grow, shrink), max=hmax)
        h = torch.where(active, h_new, h)
    return y


@functools.lru_cache(maxsize=None)
def mgcm_dlti(ts: float = TS) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Exact DLTI discretization of the MGCM linearized at the equilibrium.

    Returns (Ad, Bd, C, D) as float64 numpy arrays (ref: functions/mgcmDLTI.m:
    Jacobian at [0.5, 1.6875, 1.1547, 0], Ad=expm(A*Ts), Bd=(Ad-I)A^-1 B).
    """
    import scipy.linalg

    x1, x2, x3, _x4 = MGCM_EQ_X
    A = np.array(
        [
            [1.5 - 1.5 * x1**2, -1.0, 0.0, 0.0],
            [1.0, -x3 / (2.0 * np.sqrt(x2)), -np.sqrt(x2), 0.0],
            [0.0, 0.0, 0.0, 1.0],
            [0.0, 0.0, -WN2, -TWO_ZETA_WN],
        ]
    )
    B = np.array([[0.0], [0.0], [0.0], [WN2]])
    Ad = scipy.linalg.expm(A * ts)
    Bd = np.linalg.solve(A, (Ad - np.eye(4)) @ B)
    return Ad, Bd, np.eye(4), np.zeros((4, 1))


def nominal_step(x: torch.Tensor, u: torch.Tensor, Ad: torch.Tensor,
                 Bd: torch.Tensor) -> torch.Tensor:
    """One step of the nominal DLTI model x+ = Ad x + Bd u (delta
    coordinates; ref: models/nominalModel.m:28). Batched: x (..., n), u
    (..., m)."""
    return x @ Ad.T + u @ Bd.T


@functools.lru_cache(maxsize=None)
def mg2_dlti(ts: float = TS) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Exact DLTI discretization of the 2-state model at its equilibrium
    (the mgcm_dlti recipe applied to the reduced dynamics)."""
    import scipy.linalg

    x1, x2 = MG2_EQ_X
    A = np.array(
        [
            [1.5 - 1.5 * x1**2, -1.0],
            [1.0, -MG2_EQ_U / (2.0 * np.sqrt(x2))],
        ]
    )
    B = np.array([[0.0], [-np.sqrt(x2)]])
    Ad = scipy.linalg.expm(A * ts)
    Bd = np.linalg.solve(A, (Ad - np.eye(2)) @ B)
    return Ad, Bd, np.eye(2), np.zeros((2, 1))
