"""Solve-time statistics: the reference's 5x500 measurement protocol.

Port of lbmpc_tpu/analysis/solve_stats.py (ref: saved_data+plots/
solve_stats.m — 5 repeated runs of 500 MPC iterations, mean solve time with
95% t-confidence intervals). The statistics stay numpy and scipy;
`measure_batched_solver` times a batched solver on any device.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SolveStats:
    mean_ms: float
    median_ms: float
    p99_ms: float
    max_ms: float
    ci95_ms: tuple[float, float]
    n: int

    @classmethod
    def from_samples(cls, seconds: np.ndarray) -> "SolveStats":
        """seconds: (runs, iters) or flat array of per-solve wall times."""
        import scipy.stats

        s = np.asarray(seconds, float).ravel() * 1e3
        mean = float(np.mean(s))
        sem = scipy.stats.sem(s)
        lo, hi = scipy.stats.t.interval(0.95, len(s) - 1, loc=mean, scale=max(sem, 1e-12))
        return cls(
            mean_ms=mean,
            median_ms=float(np.median(s)),
            p99_ms=float(np.percentile(s, 99)),
            max_ms=float(np.max(s)),
            ci95_ms=(float(lo), float(hi)),
            n=len(s),
        )

    def violates_budget(self, budget_ms: float = 10.0) -> bool:
        """The reference's own real-time check: Ts = 10 ms per step."""
        return self.p99_ms > budget_ms


def _complete(out) -> None:
    """Wait until the call's work is done: torch.cuda.synchronize() on the
    device of its (first) output when that is a CUDA tensor; a CPU result is
    complete when the call returns."""
    leaf = out[0] if isinstance(out, (tuple, list)) else out
    if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def measure_batched_solver(fn, args, reps: int = 25, warmup: int = 2) -> np.ndarray:
    """Wall-time samples of repeated calls fn(*args), each ended by
    torch.cuda.synchronize() when the call returns CUDA tensors (nothing on
    the CPU). Returns seconds per call, shape (reps,)."""
    for _ in range(warmup):
        _complete(fn(*args))
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _complete(fn(*args))
        samples.append(time.perf_counter() - t0)
    return np.asarray(samples)
