#!/usr/bin/env python3
"""Where a stage-wise solve's time goes on the card (~2 minutes).

Traces one eager solve and one CUDA-graph replay with torch.profiler for
the sparse LMPC (DMS_LMPC, N=50, B=1024, float64 and float32) and the sparse
LBMPC at the DMS flagship's width (N=100, q=100, B=1024, float32, sqp 2,
ipm 16), and prints for each: the wall time (host clock around the call and
a synchronize), the device kernels launched and their summed device time
(the busy share of the wall time), and the five costliest kernels by name.

    python3 tools/sparse_profile.py            # needs one card
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def profile(fn, label: str, tag: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    n = sum(r[2] for r in rows)
    print(f"{label}: wall {wall:.3f} ms, {n} device kernels, busy {busy:.3f} ms "
          f"({100 * busy / wall:.1f} %), {1e3 * busy / max(n, 1):.2f} us a kernel {tag}",
          flush=True)
    for key, ms, cnt in rows[:5]:
        print(f"    {ms:9.3f} ms {cnt:7d}x  {key[:90]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sparse_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = torch.device("cuda", 0)
    tag = f"[{cs.card_line()}]"
    base = lt.make_preset("DMS_LMPC")
    for dt, tdt in (("float64", torch.float64), ("float32", torch.float32)):
        cfg = dataclasses.replace(base, solver=dataclasses.replace(
            base.solver, qp_backend="sparse", dtype=dt))
        sc = build_scenario(cfg, device=dev)
        dx = torch.as_tensor(cs.sparse_states(base, cs.SPARSE_BATCH, 21), dtype=tdt,
                             device=dev)
        profile(lambda: sc.solve.eager(dx, None, None), f"sparse LMPC {dt} eager", tag)
        profile(lambda: sc.solve(dx, None, None), f"sparse LMPC {dt} graph replay", tag)
    dcfg = lt.make_preset("DMS_LBMPC_q100")
    dcfg = dataclasses.replace(dcfg, solver=dataclasses.replace(
        dcfg.solver, qp_backend="sparse", dtype="float32", sqp_iters=2, ipm_iters=16))
    ds = build_scenario(dcfg, device=dev)
    rng = np.random.default_rng(3)
    _, dwin, _ = cs.bench_inputs(rng, cs.DMS_BATCH, ds.nz, dev)
    x0 = np.asarray(dcfg.x_init_abs) - np.asarray(dcfg.plant.x_wp)
    ddx = torch.as_tensor(x0 + 0.01 * rng.standard_normal((cs.DMS_BATCH, 4)),
                          dtype=torch.float32, device=dev)
    dz0 = torch.zeros(cs.DMS_BATCH, ds.nz, dtype=torch.float32, device=dev)
    profile(lambda: ds.solve.eager(ddx, dwin, dz0), "sparse LBMPC DMS float32 eager", tag)
    profile(lambda: ds.solve(ddx, dwin, dz0), "sparse LBMPC DMS float32 graph replay", tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
