"""Carry the reference package's objects across to the port.

`from_reference(obj)` takes an object of the JAX package — duck-typed by its
attribute names, never imported — and returns the port's version: the host
objects (OCPMatrices, ConstraintSet, CondensedQP, LBMPCWeights, DLTIModel,
Polytope, the tracking sandbox's TrackingSetup) as float64 numpy, a
checkpoint's EpisodeState as numpy copies of its arrays, a DataWindow and
the stage-form data (StageQP, StageGNQP) as tensors on the given device (N
and kT stay ints). Tests use it to feed both packages the same matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmpc_tpu_torch.controllers.condensed import CondensedQP
from lbmpc_tpu_torch.controllers.lbmpc import LBMPCWeights
from lbmpc_tpu_torch.controllers.tracking_sandbox import TrackingSetup
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.models.linear import DLTIModel
from lbmpc_tpu_torch.ops.sparse_gn import StageGNQP
from lbmpc_tpu_torch.ops.sparse_ipm import StageQP
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.runtime.checkpoint import EpisodeState
from lbmpc_tpu_torch.sets.polytope import Polytope
from lbmpc_tpu_torch.sets.terminal import ConstraintSet
from lbmpc_tpu_torch.synthesis import OCPMatrices


def _np(a):
    return None if a is None else np.array(a, dtype=np.float64)


def _has(obj, *names) -> bool:
    return all(hasattr(obj, n) for n in names)


def from_reference(obj, device=None, dtype=None):
    """The port's counterpart of a reference object (see module docstring).
    `device` and `dtype` apply to the tensors of a DataWindow, StageQP or
    StageGNQP; dtype defaults to the precision the arrays arrive in."""
    for cls, names in ((StageGNQP, ("cost_mask", "kT", "TLL")),
                       (StageQP, ("Qb", "Tb", "Fw_th"))):
        if _has(obj, *names):
            dev = resolve_device(device)

            def f(a):
                a = np.asarray(a)
                dt = dtype or (torch.float64 if a.dtype == np.float64 else torch.float32)
                return torch.as_tensor(np.array(a), dtype=dt, device=dev)

            return cls(**{k: (int(getattr(obj, k)) if k in ("N", "kT")
                              else f(getattr(obj, k))) for k in cls._fields})
    if _has(obj, "Klqr", "Mtheta", "LAMBDA_0"):
        return OCPMatrices(**{f: (float(getattr(obj, f)) if f == "T"
                                  else _np(getattr(obj, f)))
                              for f in OCPMatrices.__dataclass_fields__})
    if _has(obj, "F_w_N", "h_w_N"):
        return ConstraintSet(**{f: _np(getattr(obj, f))
                                for f in ConstraintSet.__dataclass_fields__})
    if _has(obj, "Gg", "Sx", "Hp"):
        return CondensedQP(H=_np(obj.H), Gg=_np(obj.Gg), g0=_np(obj.g0),
                           G=_np(obj.G), h0=_np(obj.h0), Hp=_np(obj.Hp),
                           Sx=_np(obj.Sx), Sc=_np(obj.Sc), N=int(obj.N),
                           n=int(obj.n), m=int(obj.m))
    if _has(obj, "Lq", "sqrtT"):
        return LBMPCWeights(Lq=_np(obj.Lq), Lr=_np(obj.Lr), Lp=_np(obj.Lp),
                            sqrtT=float(obj.sqrtT), LAMBDA=_np(obj.LAMBDA),
                            PSI=_np(obj.PSI))
    if _has(obj, "x_abs", "window_X", "z_warm"):
        return EpisodeState(**{f: (int(obj.step) if f == "step"
                                   else None if getattr(obj, f) is None
                                   else np.array(getattr(obj, f)))
                               for f in EpisodeState.__dataclass_fields__})
    if _has(obj, "Gp", "Gr", "term", "mais"):
        fields = TrackingSetup.__dataclass_fields__
        return TrackingSetup(**{f: (int(obj.N) if f == "N"
                                    else from_reference(getattr(obj, f))
                                    if f in ("model", "Xc", "Uc", "term", "mais", "Xf")
                                    else _np(getattr(obj, f))) for f in fields})
    if _has(obj, "F", "h") and not _has(obj, "G"):
        return Polytope(_np(obj.F), _np(obj.h))
    if _has(obj, "A", "B", "C", "D", "ts"):
        return DLTIModel(A=_np(obj.A), B=_np(obj.B), C=_np(obj.C), D=_np(obj.D),
                         ts=float(obj.ts))
    if _has(obj, "X", "Y", "valid", "count"):
        dev = resolve_device(device)
        X = np.asarray(obj.X)
        dt = dtype or (torch.float64 if X.dtype == np.float64 else torch.float32)
        f = lambda a: torch.as_tensor(np.array(a), dtype=dt, device=dev)
        return DataWindow(f(obj.X), f(obj.Y), f(obj.valid),
                          torch.as_tensor(np.array(obj.count, np.int32),
                                          device=dev))
    raise TypeError(f"no port counterpart for {type(obj).__name__}")
