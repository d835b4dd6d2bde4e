"""Step-response metrics: settling time, overshoot, tracking error, energy.

Port of lbmpc_tpu/analysis/metrics.py (ref: saved_data+plots/utilities/
response_info.m, compute_ctrl_error.m, compute_ctrl_energy.m,
compute_overshoot.m, compute_ss_time.m) on tensors: every function batches
over the leading axes, time is the last axis, and results keep the input's
dtype and device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ResponseInfo(NamedTuple):
    settling_time: torch.Tensor   # time to stay within tol band of final value
    overshoot_pct: torch.Tensor   # peak overshoot percentage
    ctrl_error: torch.Tensor      # integral of squared tracking error
    ctrl_energy: torch.Tensor     # integral of squared input
    final_error: torch.Tensor     # |x - ref| at the end


def ctrl_error(x: torch.Tensor, ref: torch.Tensor, ts: float) -> torch.Tensor:
    """Cumulative tracking error integral sum((x - ref)^2) * ts
    (ref: compute_ctrl_error.m:1-6)."""
    return torch.sum((x - ref) ** 2, dim=-1) * ts


def ctrl_energy(u: torch.Tensor, ts: float) -> torch.Tensor:
    """Control energy integral sum(u^2) * ts (ref: compute_ctrl_energy.m:1-6)."""
    return torch.sum(u ** 2, dim=-1) * ts


def overshoot_pct(x: torch.Tensor, ref_final: torch.Tensor) -> torch.Tensor:
    """Peak overshoot percentage past the final reference
    (ref: compute_overshoot.m:1-3)."""
    x0 = x[..., 0]
    span = ref_final - x0
    span = torch.where(span.abs() < 1e-12, torch.full_like(span, 1e-12), span)
    peak = torch.amax((x - ref_final[..., None]) * torch.sign(span)[..., None], dim=-1)
    return 100.0 * torch.clamp(peak, min=0.0) / span.abs()


def settling_time(x: torch.Tensor, ref_final: torch.Tensor, ts: float,
                  tol: float = 0.02) -> torch.Tensor:
    """Time after which |x - ref| stays within tol * |x0 - ref| forever
    (ref: compute_ss_time.m:1-8, 2% band)."""
    x0 = x[..., 0]
    band = tol * torch.clamp((ref_final - x0).abs(), min=1e-12)
    inside = (x - ref_final[..., None]).abs() <= band[..., None]
    # last index where we were OUTSIDE the band
    idx = torch.arange(x.shape[-1], device=x.device)
    last_out = torch.amax(torch.where(~inside, idx, -1), dim=-1)
    return (last_out + 1).to(x.dtype) * ts


def response_info(x: torch.Tensor, u: torch.Tensor, ref: torch.Tensor,
                  ts: float) -> ResponseInfo:
    """Full metric bundle for one output channel (batchable).

    x: (..., T) output trajectory; u: (..., T) input; ref: (..., T) reference.
    Ref: saved_data+plots/utilities/response_info.m:1-7.
    """
    ref_final = ref[..., -1]
    return ResponseInfo(
        settling_time=settling_time(x, ref_final, ts),
        overshoot_pct=overshoot_pct(x, ref_final),
        ctrl_error=ctrl_error(x, ref, ts),
        ctrl_energy=ctrl_energy(u, ts),
        final_error=(x[..., -1] - ref_final).abs(),
    )
