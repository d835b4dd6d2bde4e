#!/usr/bin/env python3
"""Calibrate runtime/sharding.estimate_fleet_budget's constants on the card.

For each backend of the model — "fused_xla" (the fused SQP on the port's
xla route: ops/ipm_fused on K5) and "pallas_full" (K1 + K2, with and
without the warm chain) — runs a fleet episode (LBMPC_N40 cut to N=20,
q=32, float32, sqp 2, ipm 16 or the chain's (4, 2): examples/fleet_100k's
configuration) of STEPS steps at each cohort of COHORTS, and reads the
allocator's peak above what was allocated before it
(torch.cuda.max_memory_allocated). A lane's bytes are the slope between the
first two cohorts; each backend's coefficient is the one that puts the
model's per-lane work on that slope (kkt_copies for fused_xla, staging for
pallas_full, chain for the warm chain's extra rows). The third cohort checks
the fit: its measured slope from the second beside the model's. Prints the
card, every peak, the slopes and the fitted table as one JSON line
(last), for sharding.FLEET_BUDGET.

    python3 tools/fleet_budget_calibration.py            # the card, ~2 min
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
COHORTS = (1024, 8192, 32768)
STEPS = 2
N, Q = 20, 32


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fleet_budget_calibration: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    cfg = lt.make_preset("LBMPC_N40", iterations=STEPS)
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
        solver=dataclasses.replace(cfg.solver, dtype="float32", sqp_iters=2, ipm_iters=16),
        oracle=dataclasses.replace(cfg.oracle, q=Q))
    runs = {"fused_xla": dict(qp_kernel="xla"),
            "pallas_full": dict(qp_kernel="pallas_full", qp_warm=True),
            "pallas_full_chain": dict(qp_kernel="pallas_full", qp_warm=True, warm_chain=True,
                                      ipm_iters=(4, 2))}
    rng = np.random.default_rng(0)
    dx = np.array([-0.35, -0.4, 0.0, 0.0]) + rng.uniform(-0.02, 0.02, (max(COHORTS), 4))
    peaks = {}
    sc = None
    for name, kw in runs.items():
        sc, run = build_fleet_episode(cfg, backend="fused", device=dev, **kw)
        run(dx[:64])                                   # load the kernels
        peaks[name] = {}
        for C in COHORTS:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            res = run(dx[:C])
            torch.cuda.synchronize()
            peaks[name][C] = torch.cuda.max_memory_allocated(dev) - base
            conv = res.solver_converged.float().mean().item()
            del res
            print(f"{name}: cohort {C}: peak {peaks[name][C]} bytes above the base, "
                  f"{peaks[name][C] / C:.1f} a lane, conv {conv:.4f}", flush=True)
    a, b, c = COHORTS
    slope = {k: (p[b] - p[a]) / (b - a) for k, p in peaks.items()}
    check = {k: (p[c] - p[b]) / (c - b) for k, p in peaks.items()}
    cs = sc.cs
    mI = ((N - 1) * (cs.F_x.shape[0] + cs.F_u.shape[0]) + cs.F_w_N.shape[0]
          + (cs.F_x_d.shape[0] if cs.F_x_d is not None else 0))
    n, m, nth = 4, 1, 1
    nz = N * m + nth
    ne = (N - 2) * (n + m) + 2 * n
    wb = 4
    rest_xla = ne * nz + 4 * nz * nz + 2 * mI + Q * 8 + 4 * ne
    kkt_copies = (slope["fused_xla"] / wb - rest_xla) / (mI * nz)
    staging = (slope["pallas_full"] / wb - Q * 8 - 8 * nz) / (nz * nz + mI + ne)
    chain = (slope["pallas_full_chain"] - slope["pallas_full"]) / (wb * mI)
    table = {"fused_xla": dict(kkt_copies=round(kkt_copies, 3), validated_to=c),
             "pallas_full": dict(staging=round(staging, 3), chain=round(max(chain, 0.0), 3),
                                 validated_to=c)}
    print(f"mI={mI} nz={nz} ne={ne}; bytes a lane (cohorts {a} -> {b}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in slope.items())
          + f"; check ({b} -> {c}): " + ", ".join(f"{k} {v:.1f}" for k, v in check.items()),
          flush=True)
    print(json.dumps({"card": card, "torch": torch.__version__, "cohorts": COHORTS,
                      "steps": STEPS, "mI": int(mI), "peaks": peaks, "slope": slope,
                      "check_slope": check, "FLEET_BUDGET": table}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
