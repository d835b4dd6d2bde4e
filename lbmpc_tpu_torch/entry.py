"""The port's entry points: the flagship batched solve and a multi-device
dry run.

Port of the reference's __graft_entry__.py:
- entry(device=None) -> (fn, example_args): one batched LBMPC OCP solve
  (the SQP over the learned-model cost with the nominal constraint stack),
  LBMPC_N40 cut to N=20, q=32, sqp 2, batch 8;
- dryrun_multichip(n_devices, devices=None): the reference's four stages on
  an n-shard mesh, each with the reference's gate — float64 episodes split
  over the scenario axis with the all-reduced solve statistics; the bench
  flagship hybrid (N=20, q=100, pallas_full, the fused repair) split
  against unsplit; fleet_runner cohorts; the stage-sharded Riccati against
  the single-device sweep.

    python -m lbmpc_tpu_torch.entry          # on the cards (at least 2 shards)
    python -m lbmpc_tpu_torch.entry --cpu    # 2 CPU shards, the plain versions
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

DX_INIT = np.array([-0.35, -0.4, 0.0, 0.0])


def _flagship(batch: int, N: int = 20, iters: int = 2, device=None):
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.oracle import init_window
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
        solver=dataclasses.replace(cfg.solver, sqp_iters=iters),
        oracle=dataclasses.replace(cfg.oracle, q=32))
    sc = build_scenario(cfg, device=device)
    dtype = torch.float32 if cfg.solver.dtype == "float32" else torch.float64
    dev = lt.resolve_device(device)
    window = init_window(cfg.oracle.q, dtype=dtype, batch=(batch,), device=dev)
    z_ws = torch.zeros(batch, sc.nz, dtype=dtype, device=dev)

    def step(dx):
        return sc.solve(dx, window, z_ws)

    dx0 = torch.as_tensor(
        np.tile(DX_INIT, (batch, 1))
        + 0.01 * np.random.default_rng(0).standard_normal((batch, 4)), dtype=dtype,
        device=dev)
    return step, (dx0,)


def entry(device=None):
    """(fn, example_args): the batched LBMPC solve step and its input,
    dx (8, 4); fn(dx) -> (z (8, nz), converged (8,)). On the card unless
    `device` names another."""
    return _flagship(batch=8, device=device)


def _states(rng, B: int, scale: float, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(DX_INIT + scale * rng.standard_normal((B, 4)), dtype=dtype,
                           device=dev)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Run the sharded paths on an n-shard mesh and gate each as the
    reference does (__graft_entry__.py:58-248). `devices` names the shards
    (e.g. ["cpu"] * 2); without it the local CUDA devices, repeated in turn
    where there are fewer than n_devices (the printed line says so).
    Returns each stage's numbers."""
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_hybrid
    from lbmpc_tpu_torch.oracle import DataWindow
    from lbmpc_tpu_torch.ops.riccati_sharded import lqr_cross_sharded, stage_mesh
    from lbmpc_tpu_torch.ops.sparse_gn import _riccati_cross
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario
    from lbmpc_tpu_torch.runtime.sharding import (fleet_runner, global_solve_stats,
                                                  scenario_mesh, shard_scenarios,
                                                  sharded_episode_runner, split_solver)

    rng = np.random.default_rng(1)
    mesh = scenario_mesh(n_devices, devices=devices)
    dev = mesh.devices[0]
    distinct = len(set(mesh.devices))
    where = (f"{n_devices} shards on {distinct} device(s) "
             f"({', '.join(str(d) for d in mesh.devices)})")
    if distinct < n_devices:
        where += ": fewer devices than shards, so the shards repeat them"
    out = {}

    # ---- 1. float64 episodes split over the scenario axis ------------------
    cfg = lt.make_preset("LBMPC_N40", iterations=2)
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
        solver=dataclasses.replace(cfg.solver, sqp_iters=1, ipm_iters=8, dtype="float64"),
        oracle=dataclasses.replace(cfg.oracle, q=16))
    sc = build_scenario(cfg, device=dev)
    batch = 2 * n_devices
    dx0 = _states(rng, batch, 0.005, torch.float64, dev)
    res = sharded_episode_runner(sc.run_batch, mesh)(shard_scenarios(mesh, dx0))
    n_conv, n_tot = global_solve_stats(mesh, res.solver_converged.all(dim=-1))
    assert res.sys_history.shape[0] == batch and n_tot == batch, (n_conv, n_tot)
    out["stage1"] = dict(converged=n_conv, total=n_tot)
    print(f"dryrun_multichip stage 1 OK (float64 episodes): {where}, {batch} scenarios, "
          f"{n_conv}/{n_tot} converged", flush=True)

    # ---- 2. the bench flagship hybrid, split against unsplit ---------------
    N, q = 20, 100
    cfg_f = lt.make_preset("LBMPC_N40")
    cfg_f = dataclasses.replace(
        cfg_f, ocp=dataclasses.replace(cfg_f.ocp, N=N),
        oracle=dataclasses.replace(cfg_f.oracle, q=q),
        solver=dataclasses.replace(cfg_f.solver, sqp_iters=2, ipm_iters=16,
                                   dtype="float32"))
    sc_f = build_scenario(cfg_f)
    Bf = 2 * n_devices
    hybrid = make_lbmpc_solver_hybrid(
        sc_f.qp, sc_f.A, sc_f.B, sc_f.ocp.Ks, sc_f.w, family="fmincon",
        delta=cfg_f.plant.ts, bandwidth=cfg_f.oracle.bandwidth, ridge=cfg_f.oracle.ridge,
        dx_ref=np.asarray(cfg_f.dx_ref), sqp_iters=2, ipm_iters=16,
        repair_frac=2.0 / Bf, repair_sqp_iters=1, repair_ipm_iters=8, repair_warm="fused",
        qp_kernel="pallas_full", alphas=((1.0,), (1.0, 0.5, 0.25)),
        repair_backend="fused", device=dev)
    f32 = torch.float32
    dxf = _states(rng, Bf, 0.01, f32, dev)
    winf = DataWindow(
        X=torch.as_tensor(0.1 * rng.standard_normal((Bf, q, 3)), dtype=f32, device=dev),
        Y=torch.as_tensor(0.001 * rng.standard_normal((Bf, q, 4)), dtype=f32, device=dev),
        valid=torch.ones(Bf, q, dtype=f32, device=dev),
        count=torch.full((Bf,), q, dtype=torch.int32, device=dev))
    zf = torch.zeros(Bf, sc_f.nz, dtype=f32, device=dev)
    z_un, conv_un = hybrid(dxf, winf, zf)
    z_sh, conv_sh = split_solver(mesh, hybrid)(dxf, winf, zf)
    d = (z_sh - z_un).abs().max().item()
    # the reference's gate: its sharded XLA program fuses and reduces in
    # another order, and the float32 Mehrotra iteration amplifies that
    assert d < 5e-3, f"split != unsplit flagship solve (max diff {d})"
    n_conv, n_tot = global_solve_stats(mesh, conv_sh)
    out["stage2"] = dict(max_diff=d, converged=n_conv, total=n_tot)
    print(f"dryrun_multichip stage 2 OK (flagship N={N}/q={q} hybrid solve, pallas_full, "
          f"fused repair): split vs unsplit max diff {d:.3e}, {n_conv}/{n_tot} converged",
          flush=True)

    # ---- 3. fleet_runner cohorts at the flagship shape ----------------------
    _, run_cohort = build_fleet_episode(
        dataclasses.replace(cfg_f, iterations=3), backend="hybrid",
        repair_frac=2.0 / (2 * n_devices), device=dev, mesh=mesh)
    F, chunk = 4 * n_devices, 2 * n_devices
    res_fleet = fleet_runner(run_cohort, mesh, chunk)(_states(rng, F, 0.01, f32, dev))
    flat_conv = res_fleet.solver_converged.all(dim=-1)
    n_conv, n_tot = global_solve_stats(mesh, flat_conv[:chunk])
    assert res_fleet.sys_history.shape[0] == F and n_tot == chunk
    out["stage3"] = dict(converged=n_conv, total=n_tot)
    print(f"dryrun_multichip stage 3 OK (fleet cohorts): {F} instances in {F // chunk} "
          f"chunks of {chunk}, all-reduced stats {n_conv}/{n_tot}", flush=True)

    # ---- 4. the stage-sharded Riccati against the single-device sweep ------
    smesh = stage_mesh(n_devices, devices=devices)
    Nst, nw, m_, K = 6 * n_devices, 8, 1, 3
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    As = t(0.9 * rng.standard_normal((Nst, nw, nw)) / np.sqrt(nw))
    Bs = t(rng.standard_normal((Nst, nw, m_)))
    Mq = rng.standard_normal((Nst, nw, nw)) / np.sqrt(nw)
    Qs = t(Mq @ Mq.transpose(0, 2, 1) + 0.1 * np.eye(nw))
    Rs = t(np.broadcast_to(np.eye(m_), (Nst, m_, m_)).copy())
    Ss = t(0.05 * rng.standard_normal((Nst, nw, m_)))
    qs, rs = t(rng.standard_normal((Nst, nw, K))), t(rng.standard_normal((Nst, m_, K)))
    Mp = rng.standard_normal((nw, nw)) / np.sqrt(nw)
    PN, pN = t(Mp @ Mp.T + 0.1 * np.eye(nw)), t(rng.standard_normal((nw, K)))
    W_sh, _ = lqr_cross_sharded(smesh, As, Bs, Qs, Ss, Rs, qs, rs, PN, pN)
    W_ref, _ = _riccati_cross(*(a[None] for a in (As, Bs, Qs, Ss, Rs)), qs[None, ..., 0],
                              rs[None, ..., 0], PN[None], pN[None, ..., 0])
    d_sp = ((W_sh[..., 0] - W_ref[0]).abs().max() / (W_ref.abs().max() + 1.0)).item()
    assert d_sp < 1e-9, f"stage-sharded != single-device Riccati ({d_sp})"
    out["stage4"] = dict(rel_diff=d_sp)
    print(f"dryrun_multichip stage 4 OK (stage-sharded Riccati): {Nst} stages over "
          f"{n_devices} shards, K={K} right-hand sides, split vs single-device "
          f"{d_sp:.3e}", flush=True)
    print(f"dryrun_multichip OK: {where}", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's entry and multi-device dry run")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    fn, example = entry(device=device)
    z, conv = fn(*example)
    print("entry OK:", tuple(z.shape), tuple(conv.shape), flush=True)
    n = 2 if args.cpu else max(2, torch.cuda.device_count())
    dryrun_multichip(n, devices=["cpu"] * n if args.cpu else None)


if __name__ == "__main__":
    main()
