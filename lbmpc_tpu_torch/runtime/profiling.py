"""Tracing / profiling: per-stage timers, the 5x500 protocol, device traces.

Port of lbmpc_tpu/runtime/profiling.py. The reference's instrumentation is
tic/toc around each solve accumulated into solve_times arrays
(ref: examples/DMS_LBMPC_casadi.m:168-190) analyzed by solve_stats.m. Here:
a stage timer for host-side phases, the same runs x iterations protocol
against a batched solver (analysis/solve_stats.measure_batched_solver), and
a torch.profiler trace of a code region.
"""

from __future__ import annotations

import collections
import contextlib
import pathlib
import time
from typing import Callable

import numpy as np
import torch

from lbmpc_tpu_torch.analysis.solve_stats import SolveStats, measure_batched_solver


class StageTimer:
    """Accumulates wall time per named stage (host-side tic/toc)."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }


def solve_time_protocol(
    fn: Callable, args, runs: int = 5, iters: int = 25
) -> tuple[SolveStats, np.ndarray]:
    """The reference's repeated-runs protocol (solve_stats.m: 5 x 500)
    applied to a batched solver: `runs` independent measurement series of
    `iters` calls each; returns pooled stats + the (runs, iters) samples."""
    series = [measure_batched_solver(fn, args, reps=iters, warmup=1) for _ in range(runs)]
    samples = np.stack(series)
    return SolveStats.from_samples(samples), samples


@contextlib.contextmanager
def device_trace(logdir):
    """torch.profiler over a code region: the CPU activity, and the CUDA
    activity when a card is available. Yields the profiler (read
    `key_averages()` after the region); on exit writes a Chrome trace,
    `logdir/trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    logdir = pathlib.Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(logdir / "trace.json"))
