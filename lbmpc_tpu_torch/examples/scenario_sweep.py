"""A batched scenario sweep on one host.

Port of examples/scenario_sweep.py: 4096 initial conditions of the LBMPC
closed loop, batched and split over the scenario mesh (every local card),
with the all-reduced fleet statistics and the step-response metrics of
analysis/metrics.response_info — the batched form of the reference's
one-at-a-time RunExample scripts. The last line is one JSON object with
the sweep's numbers.

    python -m lbmpc_tpu_torch.examples.scenario_sweep [--scenarios 4096] [--steps 100]
    python -m lbmpc_tpu_torch.examples.scenario_sweep --cpu --scenarios 8 --steps 2
"""

import argparse
import dataclasses
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--N", type=int, default=20)
    ap.add_argument("--cpu", action="store_true", help="run on device='cpu'")
    args = ap.parse_args(argv)

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.analysis.metrics import response_info
    from lbmpc_tpu_torch.runtime.scenario import build_scenario
    from lbmpc_tpu_torch.runtime.sharding import (global_solve_stats, scenario_mesh,
                                                  shard_scenarios, sharded_episode_runner)

    device = "cpu" if args.cpu else None
    dev = lt.resolve_device(device)
    cfg = lt.make_preset("LBMPC_N40", iterations=args.steps)
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=args.N),
        solver=dataclasses.replace(cfg.solver, dtype="float32", sqp_iters=2),
        oracle=dataclasses.replace(cfg.oracle, q=32))
    sc = build_scenario(cfg, device=device)

    rng = np.random.default_rng(0)
    dx0 = torch.as_tensor(np.array([-0.35, -0.4, 0.0, 0.0])
                          + rng.uniform(-0.02, 0.02, (args.scenarios, 4)),
                          dtype=torch.float64)
    mesh = scenario_mesh(devices=[dev] if args.cpu else None)
    runner = sharded_episode_runner(sc.run_batch, mesh)
    parts = shard_scenarios(mesh, dx0)

    t0 = time.perf_counter()
    res = runner(parts)
    final = res.sys_history[:, -1, :].cpu()           # waits for the device
    wall = time.perf_counter() - t0

    n_conv, n_tot = global_solve_stats(mesh, res.solver_converged.all(dim=-1))
    x1 = res.sys_history[:, :, 0]
    u = res.sys_history[:, :, 4]
    info = response_info(x1, u, torch.zeros_like(x1), cfg.plant.ts)
    steps_per_s = args.scenarios * args.steps / wall
    settle = info.settling_time.median().item()
    err = info.ctrl_error.median().item()
    far = final[:, 0].abs().max().item()
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{args.scenarios} scenarios x {args.steps} steps on {mesh.size} shard(s) of "
          f"{name}: {wall:.1f}s ({steps_per_s:.0f} MPC steps/s)")
    print(f"converged scenarios: {n_conv}/{n_tot}")
    print(f"fleet metrics: settling p50={settle:.2f}s, ctrl_error p50={err:.4f}, "
          f"final |dx1| max={far:.4f}")
    print(json.dumps({
        "metric": "scenario_sweep_steps_per_s", "value": round(steps_per_s, 1),
        "scenarios": args.scenarios, "steps": args.steps,
        "converged": n_conv, "total": n_tot, "settling_p50_s": settle,
        "ctrl_error_p50": err, "final_dx1_max": far,
        "devices": mesh.size, "device": name,
    }), flush=True)


if __name__ == "__main__":
    main()
