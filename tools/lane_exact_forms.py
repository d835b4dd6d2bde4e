#!/usr/bin/env python3
"""Forms of the fused solver's row products (v @ M.T) whose rows do not
depend on the batch's size, measured on the card against the plain product.

controllers/sqp_fused.FusedSolver computes h = h0 + dx0 @ Hp' and the
merit's and the flag's z @ G' (G (214, 21) at the bench shape) once or more
an SQP iteration. cuBLAS picks a (B, 21) x (21, 214) product's kernel by B,
so a lane's bits there depend on the batch's size (tools/split_lane_bits.py).
This holds each candidate form to three questions:

  1. exact: at every B of a range, are a batch's rows (its head and the
     next B rows) equal bit for bit to the same rows of the largest batch?
     At G's, Hp's and Ks' shapes; with each form's time (CUDA events);
  2. cost: the bench fused solve at B=2048 and 131072 (pallas_full,
     qp_warm, sqp 2, ipm (8, 2)) and a fleet at cohort 8192 (the warm chain), host clock,
     the forms interleaved; and whether the split solve (2 shards of the
     card) equals the whole one bit for bit, and a fleet's first half its
     own run;
  3. the golden envelope: chip_smoke's phase 29 float32 pallas_mono hybrid
     (LBMPC_N50, 8 identical lanes, every flagged lane repaired, 300 steps)
     with each form, against tests/golden within the reference's bounds;
  4. (--n40) phase 22's comparison: the uncut LBMPC_N40 warm-chain hybrid
     fleet on pallas_full (K1w, K2w) at cohort 8192, 20 steps, against its
     plain route on the first 256 lanes, with mm and the package's form,
     beside the same runs at the other batch size.

"mm" is the plain product (the closed loop keeps its one form), "package" is
ops/lanes.exact_rows as the package has it; question 3 runs mm and the
forms found exact. Needs K1, K2, K3w, K1w and K2w (built here from the
checkout).

    python3 tools/lane_exact_forms.py [--reps 7] [--golden] [--n40] [--forms mm,rows,...]
        [--skip 1,2] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import statistics
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
CHUNK = 2048        # chunk_mm, chunk_bmm: every product (CHUNK, c) x (c, r), zero-padded


def forms():
    import torch
    import torch.nn.functional as F_

    from lbmpc_tpu_torch.ops.lanes import exact_rows

    def rows(v, M):
        out = M[:, 0] * v[:, :1]
        for j in range(1, M.shape[1]):
            out = out + M[:, j] * v[:, j, None]
        return out

    def fma(v, M):
        out = M[:, 0] * v[:, :1]
        for j in range(1, M.shape[1]):
            out = torch.addcmul(out, M[:, j], v[:, j, None])
        return out

    def padded(v):
        return F_.pad(v, (0, 0, 0, -v.shape[0] % CHUNK))

    def chunk_mm(v, M):
        vp = padded(v)
        out = vp.new_empty(vp.shape[0], M.shape[0])
        for i in range(0, vp.shape[0], CHUNK):
            torch.mm(vp[i:i + CHUNK], M.T, out=out[i:i + CHUNK])
        return out[:v.shape[0]]

    def chunk_bmm(v, M):
        vp = padded(v).unflatten(0, (-1, CHUNK))
        return torch.bmm(vp, M.T.expand(vp.shape[0], *M.T.shape)).flatten(0, 1)[:v.shape[0]]

    return {
        "mm": lambda v, M: v @ M.T,
        "package": exact_rows,
        "rows": rows,
        "mulsum": lambda v, M: (v[:, None, :] * M).sum(-1),
        "bmm2": lambda v, M: torch.bmm(M.expand(v.shape[0], *M.shape),
                                       F_.pad(v[..., None], (0, 1)))[..., 0],
        "fma": fma,
        "chunk_mm": chunk_mm,
        "chunk_bmm": chunk_bmm,
    }


def exactness(dev, shapes: dict, batches, cs, names) -> set:
    """The forms whose rows are equal at every B, at every shape."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    bmax = max(batches)
    exact = set(names)
    for what, M in shapes.items():
        v = torch.randn(2 * bmax, M.shape[1], device=dev, generator=g)
        for name in names:
            f = forms()[name]
            ref = f(v, M)
            bad = [B for B in batches
                   if not (torch.equal(f(v[:B], M), ref[:B])
                           and torch.equal(f(v[B:2 * B], M), ref[B:2 * B]))]
            ms = ({B: cs.cuda_ms(lambda B=B: f(v[:B], M)) for B in (2048, 8192, 131072)}
                  if v.is_cuda else {})
            d = (ref - v @ M.T).abs().max().item()
            print(f"  {what} {tuple(M.shape)} {name}: B where rows differ {bad}; ms "
                  f"{ {k: round(x, 4) for k, x in ms.items()} }; max |form - mm| {d:.3e}",
                  flush=True)
            if bad:
                exact.discard(name)
            del ref
    return exact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--golden", action="store_true", help="also question 3")
    ap.add_argument("--device", default="cuda", help="cpu: a rehearsal at small sizes")
    ap.add_argument("--forms", default=None, help="comma-separated; default: every form")
    ap.add_argument("--n40", action="store_true", help="also question 4")
    ap.add_argument("--skip", default="", help="questions to skip, e.g. 1,2")
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers import sqp_fused
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.ops import _cuda, gn_kernel, mono_kernel, qp_kernel
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario
    from lbmpc_tpu_torch.runtime.sharding import scenario_mesh, split_solver

    dev = torch.device(args.device)
    card = dev.type == "cuda"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    if card:
        print(cs.card_line(), flush=True)
        t0 = time.time()
        _cuda.build_all((gn_kernel.KERNEL, qp_kernel.KERNEL, mono_kernel.KERNEL_WIDE,
                         gn_kernel.KERNEL_WIDE, qp_kernel.KERNEL_WIDE))
        print(f"build {time.time() - t0:.1f} s", flush=True)

    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=20),
                              oracle=dataclasses.replace(cfg.oracle, q=100),
                              solver=dataclasses.replace(cfg.solver, sqp_iters=2,
                                                         dtype="float32"))
    sc = build_scenario(cfg)
    t = lambda a: torch.as_tensor(np.atleast_2d(np.asarray(a, np.float32)), device=dev)
    names = args.forms.split(",") if args.forms else list(forms())
    skip = set(args.skip.split(","))
    exact = set(names)
    if "1" not in skip:
        print("1. exact rows at every B", flush=True)
        exact = exactness(dev, {"G": t(sc.qp.G), "Hp": t(sc.qp.Hp), "Ks": t(sc.ocp.Ks)},
                          (1, 2, 3, 4, 7, 16, 64, 100, 256, 1000, 1024, 2048, 4096, 8192,
                           16384, 65536, 131072) if card else (1, 2, 3, 16, 64), cs, names)

    orig = sqp_fused.exact_rows

    def use(name: str) -> None:
        sqp_fused.exact_rows = orig if name == "package" else forms()[name]

    B = cs.BATCH if card else 16
    dx, win, _ = cs.bench_inputs(np.random.default_rng(0), B, sc.nz, dev)
    z0 = torch.zeros(B, sc.nz, dtype=torch.float32, device=dev)
    solver = make_lbmpc_solver_fused(
        sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family="fmincon", delta=cfg.plant.ts,
        bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
        dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2, ipm_iters=cs.IPM_SCHED,
        alphas=cs.LADDER, qp_warm=True, qp_kernel="pallas_full", device=dev)
    split = split_solver(scenario_mesh(devices=[dev] * 2), solver)
    steps, cohort = (5, 8192) if card else (2, 16)
    _, run = build_fleet_episode(dataclasses.replace(cfg, iterations=steps), backend="fused",
                                 ipm_iters=cs.IPM_SCHED, sqp_iters=2, qp_warm=True,
                                 warm_chain=True, qp_kernel="pallas_full", device=dev)
    dx_f = torch.as_tensor(np.array([-0.35, -0.4, 0.0, 0.0])
                           + np.random.default_rng(1).uniform(-0.02, 0.02, (cohort, 4)),
                           dtype=torch.float32, device=dev)
    sync = torch.cuda.synchronize if card else (lambda: None)
    if "2" not in skip:
        print(f"2. cost and split: the bench fused solve at B={B}, the warm-chain fleet at "
              f"cohort {cohort} ({steps} steps), host clock, {args.reps} interleaved reps",
              flush=True)
        base = {}
        for name in names:
            use(name)
            z, c = solver(dx, win, z0)
            zs, cs_ = split(dx, win, z0)
            a, h = run(dx_f), run(dx_f[:cohort // 2].clone())
            half = all(torch.equal(x[:cohort // 2], y) for x, y in zip(
                (a.sys_history, a.final_z, a.solver_converged),
                (h.sys_history, h.final_z, h.solver_converged)))
            base.setdefault("z", z)
            base.setdefault("sys", a.sys_history)
            print(f"  {name}: split vs whole |dz| max {(zs - z).abs().max().item():.3e}, bit for "
                  f"bit {torch.equal(zs, z) and torch.equal(cs_, c)}; fleet's first half equal its "
                  f"own run {half}; conv {c.float().mean().item():.6f}; from mm: |dz| max "
                  f"{(z - base['z']).abs().max().item():.3e}, fleet |d sys| max "
                  f"{(a.sys_history - base['sys']).abs().max().item():.3e}", flush=True)
        if card:
            big = 131072
            dx_b, win_b, _ = cs.bench_inputs(np.random.default_rng(2), big, sc.nz, dev)
            z0_b = torch.zeros(big, sc.nz, dtype=torch.float32, device=dev)
            big_ms = {n: [] for n in names}
            for _ in range(3):
                for name in names:
                    use(name)
                    sync()
                    t0 = time.perf_counter()
                    solver(dx_b, win_b, z0_b)
                    sync()
                    big_ms[name].append((time.perf_counter() - t0) * 1e3)
            for name in names:
                print(f"  {name}: the fused solve at B={big}: "
                      f"{[round(x, 2) for x in big_ms[name]]} ms", flush=True)
            del dx_b, win_b, z0_b
        solve_ms = {n: [] for n in names}
        fleet_ms = {n: [] for n in names}
        for _ in range(args.reps):
            for name in names:
                use(name)
                sync()
                t0 = time.perf_counter()
                solver(dx, win, z0)
                sync()
                solve_ms[name].append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                run(dx_f)
                sync()
                fleet_ms[name].append((time.perf_counter() - t0) * 1e3 / steps)
        for name in names:
            print(f"  {name}: solve median {statistics.median(solve_ms[name]):.2f} ms "
                  f"(min {min(solve_ms[name]):.2f}); fleet step median "
                  f"{statistics.median(fleet_ms[name]):.2f} ms (min {min(fleet_ms[name]):.2f})",
                  flush=True)

    if args.golden:
        print("3. phase 29's float32 hybrid against the golden envelope", flush=True)
        gold = dict(np.load(ROOT / "tests" / "golden" / "LBMPC_N50.npz"))
        steps, held = cs.GOLDEN_F32_STEPS, cs.GOLDEN_F32_HELD
        gcfg = lt.make_preset("LBMPC_N50", iterations=steps)
        _, grun = build_fleet_episode(gcfg, backend="hybrid", qp_kernel="pallas_mono",
                                      ipm_iters=cs.XLA_SCHED, sqp_iters=2, repair_frac=1.0,
                                      device=dev)
        dx0 = np.broadcast_to(np.asarray(gcfg.dx_init), (cs.GOLDEN_B, 4)).copy()
        for name in [n for n in names if n == "mm" or n in exact]:
            use(name)
            t0 = time.time()
            res = grun(dx0)
            sync()
            conv = res.solver_converged[0].cpu().numpy()
            err = np.abs(res.sys_history[0].cpu().numpy().T - gold["sysH"][:, :steps + 1])
            out = np.nonzero((err.max(axis=0) > 2e-2) | (err[:2].max(axis=0) > 2e-3))[0]
            parted = (res.sys_history != res.sys_history[:1]).any(dim=2).any(dim=0).nonzero()
            ok = (conv[:held].all() and err[:, :held + 1].max() < 2e-2
                  and err[:2, :held + 1].max() < 2e-3 and not parted.numel())
            print(f"  {name}: over {held} steps max {err[:, :held + 1].max():.3e}, first two "
                  f"states {err[:2, :held + 1].max():.3e}, conv {conv[:held].mean():.6f}; first "
                  f"step out of the envelope {int(out[0]) if out.size else None}; lanes part at "
                  f"{int(parted[0]) if parted.numel() else None}; phase 29's gates "
                  f"{'hold' if ok else 'FAIL'}; {time.time() - t0:.1f} s", flush=True)
    if args.n40:
        cohort, nsteps, h = (cs.COHORT, cs.STEPS, 256) if card else (16, 2, 8)
        print("4. phase 22: the uncut LBMPC_N40 warm-chain hybrid fleet on pallas_full, cohort "
              f"{cohort}, {nsteps} steps, against the plain route", flush=True)
        ncfg = lt.make_preset("LBMPC_N40")
        ncfg = dataclasses.replace(ncfg, iterations=nsteps, solver=dataclasses.replace(
            ncfg.solver, sqp_iters=2, dtype="float32"))
        fkw = dict(backend="hybrid", ipm_iters=cs.IPM_SCHED, sqp_iters=2, qp_warm=True,
                   warm_chain=True, qp_kernel="pallas_full", device=dev)
        _, run_k = build_fleet_episode(ncfg, **fkw)
        _, run_p = build_fleet_episode(ncfg, plain=True, **fkw)
        dxi = torch.as_tensor(np.array([-0.35, -0.4, 0.0, 0.0]) + np.random.default_rng(1)
                              .uniform(-0.02, 0.02, (cohort, 4)), dtype=torch.float32,
                              device=dev)
        for name in [n for n in names if n in ("mm", "package")]:
            use(name)
            rk, rp = run_k(dxi), run_p(dxi[:h])
            rk256, rp_all = run_k(dxi[:h]), run_p(dxi)
            for what, a, b, ca, cb in (
                    ("kernel B vs plain 256 (phase 22)", rk.sys_history[:h], rp.sys_history,
                     rk.solver_converged[:h], rp.solver_converged),
                    ("kernel B vs kernel 256", rk.sys_history[:h], rk256.sys_history,
                     rk.solver_converged[:h], rk256.solver_converged),
                    ("plain B vs plain 256", rp_all.sys_history[:h], rp.sys_history,
                     rp_all.solver_converged[:h], rp.solver_converged),
                    ("kernel B vs plain B", rk.sys_history, rp_all.sys_history,
                     rk.solver_converged, rp_all.solver_converged)):
                d = (a - b).abs()
                lane, step, col = np.unravel_index(int(d.argmax()), tuple(d.shape))
                per_lane = d.amax(dim=(1, 2))
                print(f"  {name}, {what}: median {d.median().item():.3e} max "
                      f"{d.max().item():.3e} at (lane, step, column) ({lane}, {step}, {col}); "
                      f"lanes above 5e-2 {(per_lane > 5e-2).nonzero().flatten().tolist()[:20]}; "
                      f"that lane's unconverged steps {(~ca[lane]).nonzero().flatten().tolist()}"
                      f" / {(~cb[lane]).nonzero().flatten().tolist()}; bit for bit "
                      f"{torch.equal(a, b)}", flush=True)

    use("package")
    return 0


if __name__ == "__main__":
    sys.exit(main())
