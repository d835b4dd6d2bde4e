#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lbmpc_tpu_torch) on one NVIDIA GPU.

Builds the two CUDA kernels from lbmpc_tpu_torch/csrc/ with nvcc (sm_90a),
holds each against its plain PyTorch version at the main path's shapes, runs
the fused LBMPC SQP solve at batch 2048 and the warm-chain hybrid fleet
closed loop at a cohort of 8192 (N=20, q=100 — the bench configuration of
bench.py), counts the kernel launches of that fleet run, and times the
kernels, their plain versions, the solve and the fleet step with CUDA
events.

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --stop-after 3  # build + kernel checks only
    python3 chip_smoke.py --profile       # + a torch.profiler trace of 3 fleet steps

Exits non-zero, and prints no result, without CUDA or outside a checkout
of the repository; any failed phase raises. The last line of standard output
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
N, Q, BATCH, COHORT, STEPS = 20, 100, 2048, 8192, 20
LADDER = ((1.0,), (1.0, 0.5, 0.25))
IPM_SCHED = (8, 2)
REPAIR_K = 24


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    """A gate: log it, and stop the script (exit 1) when it fails."""
    log(f"  check {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gn_work(B: int, N_: int, q: int, ne: int, nz: int, n_const: int):
    """(bytes, float32 operations) the GN phase must move and do: inputs
    read once, outputs written once; per window point and stage 50
    operations (distance, exp counted as one, 20 running sums), the
    sensitivity update, and the unique entries of 2J'J and 2J'e."""
    n = 4
    by = 4 * (B * nz + B * n + B * q * 8 + n_const + B * (ne + nz * nz + nz))
    per_stage = 50 * q + n * nz * 16 + (n + 1) * nz * 2 * n
    rows = (N_ - 2) * (n + 1) + n
    fl = B * (N_ * per_stage + rows * (nz * (nz + 1) + 2 * nz))
    return by, fl


def qp_work(B: int, mI: int, nz: int, iters: int, warm_in: bool, warm_out: bool):
    """(bytes, float32 operations) of one Mehrotra solve: G, H, g, h (and a
    warm state) read once, x, mu (and the state) written once; per
    iteration the symmetric assembly (3 operations per row and unique
    entry), five G / G' products, the factorization, four triangular
    solves and the per-row updates."""
    by = 4 * (mI * nz + B * (nz * nz + nz + mI + nz + 1)
              + (2 * B * mI if warm_in else 0) + (2 * B * mI if warm_out else 0))
    pairs = nz * (nz + 1) // 2
    per_it = 3 * mI * pairs + 10 * mI * nz + 20 * mI + nz ** 3 // 3 + 6 * nz * nz
    return by, B * iters * per_it


def bound_ms(by: float, fl: float) -> tuple:
    tb, tf = by / PEAK_BYTES * 1e3, fl / PEAK_F32_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def bench_inputs(rng, B: int, nz: int, device):
    import torch

    from lbmpc_tpu_torch.oracle import DataWindow

    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    dx = f(np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((B, 4)))
    win = DataWindow(X=f(0.1 * rng.standard_normal((B, Q, 3))),
                     Y=f(0.001 * rng.standard_normal((B, Q, 4))),
                     valid=f(np.ones((B, Q))),
                     count=torch.full((B,), Q, dtype=torch.int32, device=device))
    z = f(0.02 * rng.standard_normal((B, nz)))
    return dx, win, z


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stop-after", type=int, default=7,
                    help="last phase to run (1-7)")
    ap.add_argument("--profile", action="store_true",
                    help="after the timings, trace 3 fleet steps with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "lbmpc_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(lbmpc_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return run_phases(dev, card_line(), torch.cuda.get_device_name(0), args)


def run_phases(dev, card: str, kind: str, args) -> int:
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops import _cuda, gn_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.qp_kernel import QPSolverH, mehrotra_h, mehrotra_h_plain
    from lbmpc_tpu_torch.controllers.sqp_fused import (make_lbmpc_solver_fused,
                                                       make_lbmpc_solver_hybrid)
    from lbmpc_tpu_torch.oracle import push_batched
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

    tag = f"[{card}]"
    t_start = time.time()
    kernels = {"gn_phase": dict(name="gn_phase", route="cuda",
                                source="lbmpc_tpu_torch/csrc/gn_phase.cu",
                                replaces="lbmpc_tpu/ops/pallas_gn.py:587",
                                library_ms=None),
               "mehrotra_h": dict(name="mehrotra_h", route="cuda",
                                  source="lbmpc_tpu_torch/csrc/mehrotra_h.cu",
                                  replaces="lbmpc_tpu/ops/pallas_ipm.py:567",
                                  library_ms=None)}

    # ---- phase 1: card, versions, build -------------------------------------
    log("phase 1: card, versions, kernel build")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} "
        f"precision={torch.get_float32_matmul_precision()}")
    t0 = time.time()
    logs = _cuda.build_all([gn_kernel.KERNEL, qp_kernel.KERNEL], verbose=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "error")):
                log(f"  {name}: {line.strip()}")
    log(f"  built both kernels in parallel in {time.time() - t0:.1f} s")
    require(gn_kernel.KERNEL.library_path().exists()
            and qp_kernel.KERNEL.library_path().exists(), "kernels built")
    if args.stop_after < 2:
        return finish(card, kind, kernels, args)

    # ---- setup at the bench shape ---------------------------------------------
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
        oracle=dataclasses.replace(cfg.oracle, q=Q),
        solver=dataclasses.replace(cfg.solver, sqp_iters=2, dtype="float32"))
    sc = build_scenario(cfg)
    qp = sc.qp
    mI, nz = qp.G.shape
    log(f"bench shape: N={N} q={Q} nz={nz} G=({mI}, {nz}) "
        f"ne={(N - 2) * 5 + 8} batch={BATCH} cohort={COHORT}")
    gn = GNPhase(qp, sc.A, sc.B, sc.ocp.Ks, sc.w, delta=cfg.plant.ts,
                 bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                 dx_ref=np.asarray(cfg.dx_ref), device=dev)
    rng = np.random.default_rng(0)
    dx, win, z = bench_inputs(rng, BATCH, nz, dev)

    # ---- phase 2: K1 against its plain version -------------------------------
    log("phase 2: K1 gn_phase vs plain")
    e_k, H_k, g_k = gn(z, dx, win)
    e_p, H_p, g_p = gn.plain(z, dx, win)
    torch.cuda.synchronize()
    hmax = H_p.abs().max().item()
    errs = [(a - b).abs().max().item() for a, b in ((e_k, e_p), (H_k, H_p), (g_k, g_p))]
    log(f"  max|H|={hmax:.6g} max err e={errs[0]:.3e} H={errs[1]:.3e} g={errs[2]:.3e} "
        f"(relative to max|H|: {max(errs) / hmax:.3e})")
    require(all(np.isfinite(errs)) and max(errs) <= 1e-5 * hmax,
            "K1 e, H, g within 1e-5 * max|H| of the plain version")
    require(bool(torch.equal(H_k, H_k.transpose(1, 2))),
            "K1 H is exactly symmetric (B, nz, nz)")
    kernels["gn_phase"]["max_abs_err"] = max(errs)
    if args.stop_after < 3:
        return finish(card, kind, kernels, args)

    # ---- phase 3: K2 against its plain version -------------------------------
    log("phase 3: K2 mehrotra_h vs plain (bench QP from K1's H and g)")
    G = torch.as_tensor(qp.G, dtype=torch.float32, device=dev)
    h0 = torch.as_tensor(qp.h0, dtype=torch.float32, device=dev)
    Hp = torch.as_tensor(qp.Hp, dtype=torch.float32, device=dev)
    hq = (h0[None] + dx @ Hp.T - z @ G.T).contiguous()
    k2_err = 0.0
    for B in (BATCH, REPAIR_K):
        H_b, g_b, h_b = H_k[:B].contiguous(), g_k[:B].contiguous(), hq[:B].contiguous()
        xk, muk, stk = mehrotra_h(G, H_b, g_b, h_b, IPM_SCHED[0], want_state=True)
        xp, mup, _ = mehrotra_h_plain(G, H_b, g_b, h_b, IPM_SCHED[0])
        dxs = (xk - xp).abs()
        dmu = (muk - mup).abs().max().item()
        log(f"  B={B} cold {IPM_SCHED[0]} iters: |dx| median={dxs.median().item():.3e} "
            f"max={dxs.max().item():.3e} |dmu| max={dmu:.3e}")
        require(dxs.median().item() < 1e-6 and dxs.max().item() < 5e-2
                and dmu < 1e-3, f"K2 cold B={B} (median<1e-6, max<5e-2, dmu<1e-3)")
        if B == BATCH:
            k2_err = max(k2_err, dxs.max().item())
        xw, muw, _ = mehrotra_h(G, H_b, g_b, h_b, IPM_SCHED[1], warm=stk)
        xwp, muwp, _ = mehrotra_h_plain(G, H_b, g_b, h_b, IPM_SCHED[1], warm=stk)
        dxs = (xw - xwp).abs()
        dmu = (muw - muwp).abs().max().item()
        log(f"  B={B} warm-in {IPM_SCHED[1]} iters: |dx| median={dxs.median().item():.3e} "
            f"max={dxs.max().item():.3e} |dmu| max={dmu:.3e}")
        require(dxs.median().item() < 1e-6 and dxs.max().item() < 5e-2
                and dmu < 1e-3, f"K2 warm B={B}")
        xc, muc, _ = mehrotra_h(G, H_b, g_b, h_b, IPM_SCHED[0],
                                warm=QPSolverH.cold_state(h_b))
        require(bool(torch.equal(xc, xk) and torch.equal(muc, muk)),
                f"K2 cold_state warm-in equals the cold solve bit for bit (B={B})")
    kernels["mehrotra_h"]["max_abs_err"] = k2_err
    if args.stop_after < 4:
        return finish(card, kind, kernels, args)

    # ---- phase 4: the fused solve, kernel route vs plain route ---------------
    log("phase 4: fused SQP solve at the bench configuration, kernel vs plain route")
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2,
              ipm_iters=IPM_SCHED, alphas=LADDER, qp_warm=True, device=dev)
    hyb_kw = dict(repair_frac=REPAIR_K / BATCH, repair_sqp_iters=1, repair_ipm_iters=8,
                  repair_warm="fused", repair_backend="fused")
    z0 = torch.zeros(BATCH, nz, dtype=torch.float32, device=dev)
    solvers = {}
    for name, factory, extra in (("fused", make_lbmpc_solver_fused, {}),
                                 ("hybrid", make_lbmpc_solver_hybrid, hyb_kw)):
        sk = factory(qp, sc.A, sc.B, sc.ocp.Ks, sc.w, **kw, **extra)
        sp = factory(qp, sc.A, sc.B, sc.ocp.Ks, sc.w, plain=True, **kw, **extra)
        solvers[name] = (sk, sp)
        n1, n2 = gn_kernel.KERNEL.launches, qp_kernel.KERNEL.launches
        zk, ck = sk(dx, win, z0)
        torch.cuda.synchronize()
        l1, l2 = gn_kernel.KERNEL.launches - n1, qp_kernel.KERNEL.launches - n2
        zp, cp = sp(dx, win, z0)
        dz = (zk - zp).abs()
        fk, fp = ck.float().mean().item(), cp.float().mean().item()
        log(f"  {name}: |dz| median={dz.median().item():.3e} max={dz.max().item():.3e} "
            f"conv kernel={fk:.6f} plain={fp:.6f} launches K1={l1} K2={l2}")
        require(bool(torch.isfinite(zk).all()), f"{name} solve finite")
        require(abs(fk - fp) <= 0.005, f"{name} conv within 0.5 pp of the plain route")
        want = 2 if name == "fused" else 3
        require(l1 == want and l2 == want,
                f"{name} launches K1={want} and K2={want} per solve")
    if args.stop_after < 5:
        return finish(card, kind, kernels, args)

    # ---- phase 5: the main path — warm-chain hybrid fleet ---------------------
    log(f"phase 5: warm-chain hybrid fleet, cohort {COHORT}, {STEPS} steps (main path)")
    fcfg = dataclasses.replace(cfg, iterations=STEPS)
    fleet_kw = dict(backend="hybrid", ipm_iters=IPM_SCHED, sqp_iters=2, qp_warm=True,
                    warm_chain=True, device=dev)
    _, run_k = build_fleet_episode(fcfg, **fleet_kw)
    _, run_p = build_fleet_episode(fcfg, plain=True, **fleet_kw)
    dx_init = (np.array([-0.35, -0.4, 0.0, 0.0])
               + np.random.default_rng(1).uniform(-0.02, 0.02, (COHORT, 4)))
    torch.cuda.synchronize()
    gn_kernel.KERNEL.launches = 0
    qp_kernel.KERNEL.launches = 0
    t0 = time.time()
    res = run_k(dx_init)
    torch.cuda.synchronize()
    fleet_s = time.time() - t0
    launches = {"gn_phase": gn_kernel.KERNEL.launches,
                "mehrotra_h": qp_kernel.KERNEL.launches}
    for k, v in launches.items():
        kernels[k]["launches"] = v
    sysH = res.sys_history
    conv = res.solver_converged.float().mean().item()
    log(f"  {fleet_s * 1e3 / STEPS:.3f} ms/step (host clock, first run, incl. warm-up) "
        f"conv={conv:.6f} launches {launches} {tag}")
    require(tuple(sysH.shape) == (COHORT, STEPS + 1, 5)
            and bool(torch.isfinite(sysH).all()), "fleet history finite, (B, T+1, 5)")
    require(all(v > 0 for v in launches.values()),
            "K1 and K2 launched on the main path")
    require(conv >= 0.99, "fleet conv >= 0.99")
    res_p = run_p(dx_init[:256])
    d = (sysH[:256] - res_p.sys_history).abs()
    worst = np.unravel_index(int(d.argmax()), tuple(d.shape))
    log(f"  first 256 lanes vs plain route: |d sys_history| median={d.median().item():.3e} "
        f"max={d.max().item():.3e} at (lane, step, column)={tuple(int(i) for i in worst)}; "
        f"lanes above 1e-4: {int((d.amax(dim=(1, 2)) > 1e-4).sum())}; "
        f"plain conv={res_p.solver_converged.float().mean().item():.6f}")
    # the tolerance class of one solve (K2 vs its plain version: the f32
    # hard lanes of the Mehrotra iteration differ by up to 5e-2, and
    # du = Ks dx + c_0 carries that into the history)
    require(d.median().item() < 1e-6 and d.max().item() < 5e-2,
            "fleet sys_history vs the plain route: median < 1e-6, max < 5e-2")
    if args.stop_after < 6:
        return finish(card, kind, kernels, args)

    # ---- phase 6: timings (CUDA events, after warm-up) ------------------------
    log("phase 6: timings")
    t = {}
    t["k1"] = cuda_ms(lambda: gn(z, dx, win))
    t["k1_plain"] = cuda_ms(lambda: gn.plain(z, dx, win), reps=5)
    Hb, gb = H_k.contiguous(), g_k.contiguous()
    t["k2_8"] = cuda_ms(lambda: mehrotra_h(G, Hb, gb, hq, IPM_SCHED[0], want_state=True))
    st = mehrotra_h(G, Hb, gb, hq, IPM_SCHED[0], want_state=True)[2]
    t["k2_2"] = cuda_ms(lambda: mehrotra_h(G, Hb, gb, hq, IPM_SCHED[1], warm=st))
    t["k2_8_plain"] = cuda_ms(lambda: mehrotra_h_plain(G, Hb, gb, hq, IPM_SCHED[0]), reps=3)
    t["k2_2_plain"] = cuda_ms(lambda: mehrotra_h_plain(G, Hb, gb, hq, IPM_SCHED[1], warm=st),
                              reps=3)
    for name, (sk, sp) in solvers.items():
        t[f"{name}_solve"] = cuda_ms(lambda: sk(dx, win, z0), reps=5)
        t[f"{name}_solve_plain"] = cuda_ms(lambda: sp(dx, win, z0), reps=2, warmup=1)
    t0 = time.time()
    run_k(dx_init)
    torch.cuda.synchronize()
    t["fleet_step"] = (time.time() - t0) * 1e3 / STEPS
    from lbmpc_tpu_torch.models.mgcm import rk23_step

    xr = torch.as_tensor(np.asarray(fcfg.plant.x_wp) + dx_init, dtype=torch.float32,
                         device=dev)
    ur = torch.full((COHORT,), float(fcfg.plant.u_wp), device=dev)
    t["fleet_rk23"] = cuda_ms(lambda: rk23_step(xr, ur, fcfg.plant.ts), reps=5)
    # where a solve and a fleet step go: one merit rollout of the ladder at
    # the batch; the warm-chain hybrid solve and the window push at the cohort
    sf = solvers["fused"][0]
    t["merit_rollout"] = cuda_ms(lambda: sf.cost(z0, dx, win), reps=10)
    hyb = run_k.solver
    dxc, winc, _ = bench_inputs(np.random.default_rng(2), COHORT, nz, dev)
    zc = torch.zeros(COHORT, nz, dtype=torch.float32, device=dev)
    stc = hyb.init_qp_state(dxc, zc)
    t["fleet_solve"] = cuda_ms(lambda: hyb.raw_qpwarm(dxc, winc, zc, stc), reps=3,
                               warmup=1)
    xi_c = dxc[:, :3].contiguous()
    t["fleet_push"] = cuda_ms(lambda: push_batched(winc, xi_c, dxc), reps=10)
    for k, v in t.items():
        log(f"  time {k} = {v:.4f} ms {tag}")
    ne = (N - 2) * 5 + 8
    by, fl = gn_work(BATCH, N, Q, ne, nz, gn.cst.numel())
    b1, b1_by = bound_ms(by, fl)
    by2, fl2 = qp_work(BATCH, mI, nz, IPM_SCHED[0], False, True)
    b2, b2_by = bound_ms(by2, fl2)
    kernels["gn_phase"].update(ms=t["k1"], plain_ms=t["k1_plain"], bound_ms=b1,
                               bound_by=b1_by)
    kernels["mehrotra_h"].update(ms=t["k2_8"], plain_ms=t["k2_8_plain"], bound_ms=b2,
                                 bound_by=b2_by)
    by22, fl22 = qp_work(BATCH, mI, nz, IPM_SCHED[1], True, False)
    log(f"  bound K1 {b1:.4f} ms ({b1_by}; {by} B, {fl:.4g} flop); K2 8 iters "
        f"{b2:.4f} ms ({b2_by}; {by2} B, {fl2:.4g} flop); K2 2 iters "
        f"{bound_ms(by22, fl22)[0]:.4f} ms {tag}")
    if args.profile:
        profile_fleet(dataclasses.replace(fcfg, iterations=3), fleet_kw, dx_init, tag)
    log(f"  wall time so far {time.time() - t_start:.1f} s")
    return finish(card, kind, kernels, args)


def profile_fleet(cfg, fleet_kw: dict, dx_init, tag: str) -> None:
    """torch.profiler over a 3-step fleet episode at the cohort: device time
    by kernel name and the device's busy share of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    _, run = build_fleet_episode(cfg, **fleet_kw)
    run(dx_init)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(dx_init)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    # device-side events only: an op's row (aten::sum) repeats the time of
    # the kernels it launched
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    n_launch = sum(r[2] for r in rows)
    log(f"  profile: {cfg.iterations} steps, wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.2f}%), {n_launch} device ops {tag}")
    for key, ms, cnt in rows[:12]:
        log(f"    {ms:9.3f} ms  {cnt:6d}x  {key[:90]}")


def finish(card: str, kind: str, kernels: dict, args) -> int:
    import torch

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "lbmpc_tpu"
                    or m.startswith("lbmpc_tpu."))
    require(not leaked, f"no jax / lbmpc_tpu module imported ({leaked[:3]})")
    if args.stop_after >= 7:
        log("phase 7: kernels")
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        rows = [{k: v.get(k) for k in keys} for v in kernels.values()]
        require(all(r[k] is not None for r in rows for k in keys if k != "library_ms"),
                "every kernel row complete")
        log(card)
        log(json.dumps({"kernels": rows}))
    else:
        log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
