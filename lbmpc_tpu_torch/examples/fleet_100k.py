"""100k+ concurrent receding-horizon LBMPC instances.

Port of examples/fleet_100k.py: a fleet of independent closed-loop LBMPC
instances swept through the scenario mesh in cohorts of `--chunk`
(runtime/sharding.fleet_runner), the convergence statistics all-reduced
over the mesh (global_solve_stats). With --multihost every rank joins one
torch.distributed group (torchrun's environment): each keeps its shard of
every cohort, and only the statistics cross between ranks. The last line
is one JSON object: fleet_closed_loop_solves_per_s and its keys, and the
device's name.

    python -m lbmpc_tpu_torch.examples.fleet_100k                  # the card
    python -m lbmpc_tpu_torch.examples.fleet_100k --fused --qp-kernel pallas_full --warm-chain
    python -m lbmpc_tpu_torch.examples.fleet_100k --cpu --instances 512 --chunk 64 --steps 3
    torchrun --nproc-per-node 4 -m lbmpc_tpu_torch.examples.fleet_100k --multihost
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instances", type=int, default=131072)
    ap.add_argument("--chunk", type=int, default=0,
                    help="cohort size; 0 = pick from the device-memory budget model "
                         "(runtime/sharding.estimate_fleet_budget)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--N", type=int, default=20)
    ap.add_argument("--ipm-iters", type=int, default=16,
                    help="IPM iterations per GN step")
    ap.add_argument("--cpu", action="store_true", help="run on device='cpu'")
    ap.add_argument("--multihost", action="store_true",
                    help="join a torch.distributed group (torchrun's environment)")
    ap.add_argument("--fused", action="store_true",
                    help="batch-level episodes on the fused SQP "
                         "(runtime/scenario.build_fleet_episode)")
    ap.add_argument("--backend", default="hybrid", choices=["fused", "hybrid"],
                    help="fused cohort solver; 'hybrid' (default) adds the compacted "
                         "per-step repair")
    ap.add_argument("--qp-kernel", default="xla", choices=["xla", "pallas", "pallas_full"],
                    help="the fused SQP's route; 'pallas_full' = the GN and QP kernels")
    ap.add_argument("--warm-chain", action="store_true",
                    help="carry the QP kernel's interior state across steps and run "
                         "the short (4, 2) IPM schedule (kernel routes)")
    args = ap.parse_args(argv)

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario
    from lbmpc_tpu_torch.runtime.sharding import (estimate_fleet_budget, fleet_runner,
                                                  global_solve_stats, initialize_multihost,
                                                  scenario_mesh)

    if args.multihost:
        initialize_multihost()
    device = "cpu" if args.cpu else None
    dev = lt.resolve_device(device)
    cfg = lt.make_preset("LBMPC_N40", iterations=args.steps)
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=args.N),
        solver=dataclasses.replace(cfg.solver, dtype="float32", sqp_iters=2,
                                   ipm_iters=args.ipm_iters),
        oracle=dataclasses.replace(cfg.oracle, q=32))
    sc = build_scenario(cfg, device=device)
    mesh = scenario_mesh(devices=[dev] if args.cpu else None)

    if not args.chunk:
        # the exact constraint-row count of this scenario's condensed stack
        cs = sc.cs
        mI = ((args.N - 1) * (cs.F_x.shape[0] + cs.F_u.shape[0]) + cs.F_w_N.shape[0]
              + (cs.F_x_d.shape[0] if cs.F_x_d is not None else 0))
        kernels = args.fused and args.qp_kernel == "pallas_full"
        hbm = (os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") if args.cpu
               else None)
        budget = estimate_fleet_budget(
            n=4, m=1, nth=1, N=args.N, q=cfg.oracle.q, iterations=args.steps,
            fleet=args.instances, mI=int(mI), hbm_bytes=hbm,
            backend="pallas_full" if kernels else "fused_xla",
            warm_chain=kernels and args.warm_chain)
        if not budget["fits"]:
            sys.exit(f"fleet does not fit the device's memory: {budget}")
        args.chunk = min(budget["max_chunk"], args.instances)
        print(f"chunk auto-picked: {args.chunk} (budget {budget})", flush=True)

    rng = np.random.default_rng(0)
    dx0 = torch.as_tensor(np.array([-0.35, -0.4, 0.0, 0.0])
                          + rng.uniform(-0.02, 0.02, (args.instances, 4)),
                          dtype=torch.float64)

    if args.fused:
        chain_kw = (dict(ipm_iters=(4, 2), qp_warm=True, warm_chain=True)
                    if args.warm_chain else {})
        # the hybrid's repair picks its lanes over the whole cohort, so the
        # episode splits its solver over the mesh itself
        _, run_cohort = build_fleet_episode(
            cfg, backend=args.backend, qp_kernel=args.qp_kernel, device=device,
            mesh=mesh if args.backend == "hybrid" else None, **chain_kw)
        run = fleet_runner(run_cohort, mesh, chunk=args.chunk)
        # warm-up: load (or build) the kernels before timing
        warm = run(dx0[:args.chunk])
        warm.sys_history[:1, -1, 0].cpu()
    else:
        run = fleet_runner(sc.run_batch, mesh, chunk=args.chunk)

    t0 = time.perf_counter()
    res = run(dx0)
    final = res.sys_history[:, -1, 0].cpu().numpy()     # waits for the device
    wall = time.perf_counter() - t0

    n_conv, n_tot = global_solve_stats(mesh, res.solver_converged.all(dim=-1))
    hosts = mesh.world
    solves = args.instances * args.steps
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"fleet: {args.instances} concurrent LBMPC instances x {args.steps} "
          f"receding-horizon steps on {mesh.size} shard(s) [{hosts} process(es)] of {name}")
    print(f"wall {wall:.1f}s -> {solves / wall:.0f} MPC solves/s; converged instances: "
          f"{n_conv}/{n_tot}; final |dx1| p99: {float(np.percentile(np.abs(final), 99)):.4f}")
    print(json.dumps({
        "metric": "fleet_closed_loop_solves_per_s",
        "value": round(solves / wall, 1),
        "instances": args.instances, "steps": args.steps,
        "chunk": args.chunk, "fused": bool(args.fused),
        "converged_frac": round(int(n_conv) / max(int(n_tot), 1), 4),
        "devices": mesh.size, "hosts": hosts, "device": name,
    }), flush=True)


if __name__ == "__main__":
    main()
