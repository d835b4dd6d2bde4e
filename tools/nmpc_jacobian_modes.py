#!/usr/bin/env python3
"""The NMPC's SQP Jacobians three ways, timed on the card (or the CPU).

controllers/nmpc.make_nmpc_solver needs, every SQP iteration, the Jacobian
of its residual stack (~5 rows a stage) and of its constraint stack (~10
rows a stage) in z (N + 1 decisions). This tool times, at NMPC_N50
(fmincon, RK4 prediction with 4 substeps) and the casadi NMPC at N=100:
- `tangent`: the hand forward pass that carries the value and the nz
  tangents of the rollout in one tensor (the solver's);
- `forward`: torch.func.vmap over the nz unit tangents of torch.func.jvp
  over the plain rollout (the reference's jacfwd);
- `reverse`: torch.func.jacrev over the lane sum (one pass per row);
one Jacobian evaluation each at B = 1 and B = 1024 lanes, each against the
tangent pass's J and Jc; then one whole solve (4 SQP x 25 IPM), eager and
replayed from its CUDA graph, and a short episode. Prints one JSON line.

    python tools/nmpc_jacobian_modes.py [--device cpu] [--steps 3]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def timed(fn, dev, reps: int = 1):
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3 / reps


def reverse_jac(fn, z):
    """d fn / d z per lane by reverse mode over the lane sum: one pass per
    row of fn. fn (B, nz) -> (B, r); returns (B, r, nz)."""
    import torch

    return torch.func.jacrev(lambda zz: fn(zz).sum(dim=0))(z).transpose(0, 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--batches", default="1,1024")
    ap.add_argument("--modes", default="tangent,forward,reverse")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers import nmpc, sqp
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = lt.resolve_device(args.device)
    out = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "torch": torch.__version__, "cases": []}
    cases = [("NMPC_N50", {}), ("NMPC_N50", {"family": "casadi", "N": 100})]
    for name, kw in cases:
        cfg = lt.make_preset(name, iterations=args.steps)
        if kw:
            cfg = dataclasses.replace(cfg, family=kw["family"],
                                      ocp=dataclasses.replace(cfg.ocp, N=kw["N"]))
        sc = build_scenario(cfg, device=dev)
        p, N = cfg.plant, cfg.ocp.N
        row = {"case": f"{name} {cfg.family} N={N}", "nz": sc.nz, "jac_ms": {}, "max_abs_diff": {}}
        for B in (int(b) for b in args.batches.split(",")):
            rng = np.random.default_rng(0)
            dx0 = torch.tensor(np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal(
                (B, 4)), device=dev)
            z = torch.tensor(0.05 * rng.standard_normal((B, sc.nz)), device=dev)
            ref = None
            parts = sc.solve.parts
            for mode in args.modes.split(","):
                if mode == "tangent":
                    fn = lambda: parts["jac"](z, dx0)
                else:
                    jac = sqp._forward_jac if mode == "forward" else reverse_jac
                    fn = lambda: (None, jac(lambda zz: parts["values"](zz, dx0)[0], z), None,
                                  jac(lambda zz: parts["values"](zz, dx0)[1], z))
                res, ms = timed(fn, dev)
                row["jac_ms"][f"{mode} B={B}"] = round(ms, 3)
                if ref is None:
                    ref = res
                else:
                    row["max_abs_diff"][f"{mode} B={B}"] = max(
                        float((res[1] - ref[1]).abs().max()), float((res[3] - ref[3]).abs().max()))
                log = f"{row['case']} B={B} {mode}: {ms:.3f} ms"
                print(log, file=sys.stderr, flush=True)
            solver = nmpc.make_nmpc_solver(
                sc.cs, sc.ocp.Ks, sc.w, N, p.ts, np.asarray(p.x_wp), p.u_wp,
                family=cfg.family, sqp_iters=cfg.solver.sqp_iters,
                ipm_iters=cfg.solver.ipm_iters, device=dev)
            for graph in (False, True):
                # the solver's own entry replays its graph on the card
                solve = solver if graph else (lambda d, w, zw: solver.parts["eager"](d, zw))
                t0 = time.perf_counter()
                zg, _ = solve(dx0, None, torch.zeros_like(z))
                sync(dev)
                first = (time.perf_counter() - t0) * 1e3
                _, ms = timed(lambda: solve(dx0, None, torch.zeros_like(z)), dev, reps=3)
                tag = "graph" if graph else "eager"
                row[f"solve_ms {tag} B={B}"] = round(ms, 3)
                row[f"first_call_ms {tag} B={B}"] = round(first, 3)
                if graph:
                    row[f"graph_vs_eager_max_abs_dz B={B}"] = float((zg - ze).abs().max())
                    graphed = solver.parts["graphed"]          # None off the card
                    row[f"graph_replays B={B}"] = graphed.replays if graphed else None
                else:
                    ze = zg
                print(f"{row['case']} B={B} solve {tag}: {ms:.3f} ms (first {first:.0f})",
                      file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        res = sc.run()
        sync(dev)
        row["episode_ms_per_step"] = round((time.perf_counter() - t0) * 1e3 / args.steps, 3)
        row["episode_conv"] = bool(res.solver_converged.all())
        out["cases"].append(row)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
