"""PyTorch port, runtime/profiling: the stage timer, the solve-time
protocol's shape and statistics, and a CPU device trace written to disk."""

import json
import time

import numpy as np
import torch

from lbmpc_tpu_torch.analysis.solve_stats import SolveStats, measure_batched_solver
from lbmpc_tpu_torch.runtime.profiling import StageTimer, device_trace, solve_time_protocol


def test_stage_timer_counts():
    timer = StageTimer()
    for _ in range(3):
        with timer.stage("solve"):
            time.sleep(0.001)
    with timer.stage("push"):
        pass
    s = timer.summary()
    assert s["solve"]["count"] == 3 and s["push"]["count"] == 1
    assert s["solve"]["total_s"] >= 0.003
    assert s["solve"]["mean_ms"] == 1e3 * s["solve"]["total_s"] / 3


def test_stage_timer_counts_a_stage_that_raises():
    timer = StageTimer()
    try:
        with timer.stage("bad"):
            raise ValueError
    except ValueError:
        pass
    assert timer.summary()["bad"]["count"] == 1


def test_solve_time_protocol_shape():
    """runs x iters samples (and one warm-up call a run), pooled into the
    reference's statistics."""
    calls = []
    H = torch.eye(8).expand(4, 8, 8)

    def solve(g):
        calls.append(1)
        return torch.linalg.solve(H, g), g.sum()

    stats, samples = solve_time_protocol(solve, (torch.ones(4, 8),), runs=3, iters=7)
    assert samples.shape == (3, 7) and (samples > 0).all()
    assert len(calls) == 3 * (7 + 1)
    assert stats == SolveStats.from_samples(samples) and stats.n == 21
    assert measure_batched_solver(solve, (torch.ones(4, 8),), reps=4, warmup=0).shape == (4,)


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    a = torch.ones(16, 32, 32)
    with device_trace(tmp_path / "trace") as prof:
        torch.bmm(a, a).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::bmm" in names
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(ev.get("name") == "aten::bmm" for ev in trace["traceEvents"])
    assert np.isfinite(sum(e.cpu_time_total for e in prof.key_averages()))
