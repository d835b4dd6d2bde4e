"""Generic DLTI model container + the double-integrator tracking sandbox.

Port of lbmpc_tpu/models/linear.py, host-side numpy as there. Ref:
matlab/trackingMPC/RunExample.m:20-22 defines the 2-state, 2-input double
integrator of the didactic tracking-MPC subtree; it is carried as a second
plant family beside the MGCM's DLTI.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DLTIModel:
    """Discrete LTI model x+ = A x + B u, y = C x (+ D u)."""

    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    D: np.ndarray
    ts: float

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def m(self) -> int:
        return self.B.shape[1]

    @property
    def o(self) -> int:
        return self.C.shape[0]


def double_integrator() -> DLTIModel:
    """The trackingMPC sandbox system (ref: trackingMPC/RunExample.m:20-22)."""
    A = np.array([[1.0, 1.0], [0.0, 1.0]])
    B = np.array([[0.0, 0.5], [1.0, 0.5]])
    C = np.array([[1.0, 0.0]])
    D = np.zeros((1, 2))
    return DLTIModel(A=A, B=B, C=C, D=D, ts=1.0)


def mgcm_dlti_model() -> DLTIModel:
    """The MGCM's exact discretization at TS as a DLTIModel."""
    from lbmpc_tpu_torch.config import TS
    from lbmpc_tpu_torch.models.mgcm import mgcm_dlti

    Ad, Bd, C, D = mgcm_dlti(TS)
    return DLTIModel(A=Ad, B=Bd, C=C, D=D, ts=TS)
