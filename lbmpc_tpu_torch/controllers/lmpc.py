"""Linear tracking MPC (LMPC): the condensed QP solved by the batched IPM.

Port of lbmpc_tpu/controllers/lmpc.py. The reference replaces fmincon's SQP
over blackbox closures (ref: functions/ocpLMPC.m:11-39) with one dense QP
per step; here the steps of a batch of lanes are one batched solve
(ops/ipm).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lbmpc_tpu_torch.controllers.condensed import CondensedQP
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.ops.ipm import IPMSolution, solve_qp, solve_qp_mixed
from lbmpc_tpu_torch.ops.lanes import lane_mm, on_min_lanes


class QPDevice(NamedTuple):
    """A CondensedQP as tensors on the solver's device."""

    H: torch.Tensor
    Gg: torch.Tensor
    g0: torch.Tensor
    G: torch.Tensor
    h0: torch.Tensor
    Hp: torch.Tensor

    @classmethod
    def from_condensed(cls, qp: CondensedQP, dtype=torch.float64,
                       device=None) -> "QPDevice":
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=dev)
        return cls(H=t(qp.H), Gg=t(qp.Gg), g0=t(qp.g0), G=t(qp.G), h0=t(qp.h0),
                   Hp=t(qp.Hp))


def make_lmpc_solver(qp: CondensedQP, ipm_iters: int = 30, dtype=torch.float64,
                     mixed: bool = False, device=None):
    """Returns solve(dx (B, n)) -> (z (B, nz), IPMSolution): the QP
    min 1/2 z'Hz + (Gg dx + g0)'z s.t. G z <= h0 + Hp dx per lane.
    mixed=True routes through solve_qp_mixed (float32 IPM + float64
    refinement, on float64 tensors). A lane's bits do not depend on the
    batch's size (ops/lanes.lane_mm here, ops/ipm's forms, and on the card
    at least ops/lanes.MIN_LANES lanes: on_min_lanes)."""
    dev = QPDevice.from_condensed(qp, torch.float64 if mixed else dtype, device)

    def solve(dx: torch.Tensor) -> tuple[torch.Tensor, IPMSolution]:
        return on_min_lanes(solve_lanes, dx.to(dev.G.device, dev.G.dtype))

    def solve_lanes(dx: torch.Tensor) -> tuple[torch.Tensor, IPMSolution]:
        g = lane_mm(dx, dev.Gg) + dev.g0
        h = dev.h0 + lane_mm(dx, dev.Hp)
        if mixed:
            sol = solve_qp_mixed(dev.H, g, dev.G, h, f32_iters=ipm_iters)
        else:
            sol = solve_qp(dev.H, g, dev.G, h, iters=ipm_iters)
        return sol.x, sol

    return solve
