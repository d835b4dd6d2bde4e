#!/usr/bin/env python3
"""Which operations give a lane other bits when the batch is split.

runtime/sharding.split_solver runs each shard's lanes through the batch
solver on its own, so a split equals the unsplit call bit for bit only
where every operation gives a lane the same bits at every batch size. This
runs the bench fused solve (LBMPC_N40 cut to N=20, q=100, pallas_full, sqp
2, ipm (8, 2), qp_warm, the ladder ((1,), (1, .5, .25))) at batch B and on
its first B/2 lanes, each under a dispatch mode that records every aten
operation's output, and names the operations whose inputs agree on those
lanes while their outputs do not (the origins), with the shapes, in order;
then the same for a fleet episode of --steps steps on that route (the warm
chain, build_fleet_episode).

--per-problem sweeps the per-problem stack instead (build_scenario's
solver for LBMPC_N40 uncut: controllers/lbmpc.make_lbmpc_solver on
controllers/sqp, ops/ipm and ops/chol) at the batch sizes of --batches:
  1. its operations at their shapes (the products with a shared matrix, the
     per-lane products, the Cholesky factor and triangular solves, the row
     sums, the NW value and Jacobian), each in its candidate forms: the B
     where a batch's rows (its head, and the next B rows) differ from the
     same rows of a batch of twice the largest B, and each form's time at
     the largest B (CUDA events);
  2. the solve in float64 and in float32: lanes 0, B/2 and B-1 of a batch
     of B against each lane's solve alone, bit for bit, with the origins
     (as above) at the first B that parts, up to B=256;
  3. a 5-step episode (run_batch): the lanes of a batch against their runs
     alone.
--cost times what the exact forms cost (host clock, CUDA synchronized):
phase 38's float64 run_batch (256 lanes), phase 27's N=20 hybrid fleets
with the vmapped repair (xla and pallas_mono, cohort 8192) and phase 26's
N40 pallas_mono one, and fleet_100k --instances 4096 --chunk 2048 on the
per-problem stack; --package-root DIR times another tree's package (an
earlier commit unpacked with git archive) with this checkout's kernels;
--trace adds a torch.profiler trace of one run of the N=20 pallas_mono
fleet: its operations by device and by host time.

    python3 tools/split_lane_bits.py [--batch 2048] [--steps 2] [--device cuda]
    python3 tools/split_lane_bits.py --per-problem [--batches 1,2,...] [--device cpu]
    python3 tools/split_lane_bits.py --cost [--package-root DIR] [--trace]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def record(fn):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Rec(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.log = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            keep = lambda a: a.detach().clone() if isinstance(a, torch.Tensor) else None
            self.log.append((str(func), [keep(a) for a in args],
                             keep(out) if isinstance(out, torch.Tensor) else None))
            return out

    with Rec() as rec:
        fn()
    return rec.log


def rows_equal(a, b, B: int, h: int) -> bool:
    """a (from the batch of B) against b (from its first h lanes): on the
    lanes where the shapes say so, else whole."""
    import torch

    if a is None or b is None:
        return True
    if a.ndim and a.shape[0] == B and b.shape[0] == h:
        a = a[:h]
    if a.shape != b.shape:
        return True
    return bool(torch.equal(a, b)) if not a.is_floating_point() else bool(
        torch.equal(torch.nan_to_num(a, nan=1.5), torch.nan_to_num(b, nan=1.5)))


def report(what: str, B: int, h: int, full: list, half: list) -> None:
    print(f"{what}: {len(full)} / {len(half)} operations at B={B} / {h}", flush=True)
    origins, first_diff = [], None
    for i, ((fa, aa, oa), (fb, ab, ob)) in enumerate(zip(full, half)):
        if fa != fb:
            print(f"  the operation sequences part at {i}: {fa} / {fb}")
            break
        if "empty" in fa or oa is None or rows_equal(oa, ob, B, h):
            continue
        first_diff = i if first_diff is None else first_diff
        if all(rows_equal(x, y, B, h) for x, y in zip(aa, ab)):
            shapes = [tuple(x.shape) if x is not None else None for x in aa]
            d = (oa[:h] if oa.shape[0] == B else oa).float() - ob.float()
            origins.append((i, fa, shapes, d.abs().nan_to_num().max().item()))
    print(f"  first operation whose lanes differ: {first_diff}; origins (inputs equal on "
          f"the lanes, outputs not; uninitialized allocations left out): {len(origins)}",
          flush=True)
    for i, f, shapes, d in origins[:40]:
        print(f"    {i}: {f} {shapes} max |d| {d:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--per-problem", action="store_true",
                    help="sweep the per-problem stack instead of the fused solver")
    ap.add_argument("--batches", default="1,2,3,4,8,16,32,64,128,256,1000,1024,2048,8192",
                    help="--per-problem: the batch sizes")
    ap.add_argument("--cost", action="store_true", help="time the per-problem stack")
    ap.add_argument("--package-root", default=None,
                    help="--cost: import lbmpc_tpu_torch from this tree")
    ap.add_argument("--trace", action="store_true",
                    help="--cost: trace a run of the N=20 pallas_mono fleet (torch.profiler)")
    args = ap.parse_args(argv)
    if args.per_problem:
        return per_problem(args)
    if args.cost:
        return cost(args)
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.ops import _cuda, gn_kernel, qp_kernel
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(cs.card_line(), flush=True)
        _cuda.build_all((gn_kernel.KERNEL, qp_kernel.KERNEL))
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=20),
                              oracle=dataclasses.replace(cfg.oracle, q=100),
                              solver=dataclasses.replace(cfg.solver, sqp_iters=2,
                                                         dtype="float32"))
    sc = build_scenario(cfg)
    B, h = args.batch, args.batch // 2
    dx, win, z = cs.bench_inputs(np.random.default_rng(0), B, sc.nz, dev)
    solver = make_lbmpc_solver_fused(
        sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family="fmincon", delta=cfg.plant.ts,
        bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
        dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2, ipm_iters=(8, 2),
        alphas=((1.0,), (1.0, 0.5, 0.25)), qp_warm=True, qp_kernel="pallas_full",
        device=dev)
    z0 = torch.zeros(B, sc.nz, dtype=torch.float32, device=dev)
    halves = (dx[:h].clone(), type(win)(*(a[:h].clone() for a in win)), z0[:h].clone())
    solver(dx, win, z0)
    report("fused solve", B, h, record(lambda: solver(dx, win, z0)),
           record(lambda: solver(*halves)))
    if args.steps:
        _, run = build_fleet_episode(
            dataclasses.replace(cfg, iterations=args.steps), backend="fused",
            ipm_iters=(8, 2), sqp_iters=2, qp_warm=True, warm_chain=True,
            qp_kernel="pallas_full", device=dev)
        dx_init = torch.as_tensor(np.array([-0.35, -0.4, 0.0, 0.0])
                                  + np.random.default_rng(1).uniform(-0.02, 0.02, (B, 4)),
                                  dtype=torch.float32, device=dev)
        run(dx_init)
        a, b = run(dx_init), run(dx_init[:h].clone())
        same = all(torch.equal(x[:h], y) for x, y in zip(
            (a.sys_history, a.final_x, a.final_z, a.solver_converged),
            (b.sys_history, b.final_x, b.final_z, b.solver_converged)))
        print(f"fleet episode, {args.steps} steps: the first {h} lanes equal bit for bit: "
              f"{same}", flush=True)
        if not same:
            report("fleet episode", B, h, record(lambda: run(dx_init)),
                   record(lambda: run(dx_init[:h].clone())))
    return 0


PER_PROBLEM_FORMS = """the candidate forms, by operation:
  rows (v @ M.T, M shared): mm (plain), lane_mm (the package: on the card
    a product, then FMAs in order, up to CHAIN_TERMS terms, else
    exact_rows), exact_rows, fma (that chain at any length), unfused (each
    product and sum rounded in order: the GN phase's, fused=False);
  per lane (A @ X): bmm (plain, the package), min2 (at least MIN_LANES
    lanes: the solvers' padding on the card), chunk (the batched product in
    zero-padded chunks of 2048 lanes);
  per-lane matrix-vector: bmm, exact_mv (the package);
  factor and solves: plain, min2 (the package);
  the NW value and Jacobian, its sums over the window: sum (v.sum(dim)),
    exact (exact_sum over the axis moved last), split (split_sum over the
    axis moved last: lanes.lane_sum_dim)."""


def _chunked(fn, chunk: int, *xs):
    """fn on zero-padded chunks of `chunk` lanes (identity matrices where a
    factorization needs them): every call sees the same batch count."""
    import torch
    import torch.nn.functional as F_

    B = xs[0].shape[0]
    pads = [F_.pad(x, (0, 0) * (x.ndim - 1) + (0, -B % chunk)) for x in xs]
    outs = [fn(*(p[i:i + chunk] for p in pads)) for i in range(0, pads[0].shape[0], chunk)]
    return torch.cat(outs)[:B]


def _min_lanes(fn, *xs):
    """fn on at least MIN_LANES lanes, the last lane copied (the solvers'
    ops/lanes.on_min_lanes, on any device)."""
    from lbmpc_tpu_torch.ops.lanes import MIN_LANES, on_lanes

    return fn(*xs) if xs[0].shape[0] >= MIN_LANES else on_lanes(fn, MIN_LANES, *xs)


def _nw_with(wsum, xi, window):
    """oracle.nw_estimate_and_jac with its sums over the window taken by
    wsum(v, dim), value and Jacobian flattened side by side."""
    import torch

    from lbmpc_tpu_torch import oracle

    keep, oracle.lane_sum_dim = oracle.lane_sum_dim, wsum
    try:
        return torch.cat([a.flatten(1) for a in oracle.nw_estimate_and_jac(xi, window)], dim=1)
    finally:
        oracle.lane_sum_dim = keep


def per_problem_ops(dev, batches, cs, sc, dtype):
    """Question 1: each operation's forms at the stack's shapes."""
    import torch

    from lbmpc_tpu_torch.ops import lanes
    from lbmpc_tpu_torch.oracle import DataWindow

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=g, dtype=dtype)
    bmax = 2 * max(batches)
    card = dev.type == "cuda"
    t = lambda a: torch.as_tensor(np.atleast_2d(np.asarray(a, float)), dtype=dtype, device=dev)
    G, Hp, Ks, A, Bd = t(sc.qp.G), t(sc.qp.Hp), t(sc.ocp.Ks), t(sc.A), t(sc.B)
    mI, nz = G.shape
    ne = 198 if sc.qp.N == 40 else 5 * (sc.qp.N - 2) + 8
    rows = {"mm": lambda v, M: v @ M.T, "lane_mm": lanes.lane_mm,
            "exact_rows": lambda v, M: lanes.exact_rows(v.contiguous(), M),
            "fma": lambda v, M: lanes._term_chain(lambda j: v[..., j:j + 1],
                                                  lambda j: M[:, j], v.shape[-1], True),
            "unfused": lambda v, M: lanes._term_chain(lambda j: v[..., j:j + 1],
                                                      lambda j: M[:, j], v.shape[-1], False)}
    cases, plains = [], {}
    for what, M in (("Ks", Ks), ("A", A), ("B'", Bd.T), ("Hp", Hp), ("G", G), ("G'", G.T)):
        v = rnd(bmax, M.shape[1])
        plains[f"{what} {tuple(M.shape)}"] = lambda sl, v=v, M=M: v[sl] @ M.T
        for name, f in rows.items():
            cases.append((f"{what} {tuple(M.shape)}", name, lambda v=v, M=M, f=f, sl=None:
                           f(v[sl], M), v))
    # the assembly's fold: a lane's nz rows of mI entries against G
    GtD = rnd(bmax, nz, mI)
    for name in ("mm", "lane_mm", "exact_rows"):
        f = rows[name]
        cases.append((f"(G' D) G fold ({nz}, {mI}) x ({mI}, {nz}) a lane", name,
                      lambda f=f, sl=None: f(GtD[sl].reshape(-1, mI), G.T).reshape(-1, nz, nz),
                      GtD))
    J, e = rnd(bmax, ne, nz), rnd(bmax, ne)
    Jg, dxi = rnd(bmax, 4, 3), rnd(bmax, 3, nz)
    per_lane = {"bmm": lambda a, x: a @ x, "min2": lambda a, x: _min_lanes(
                    lambda p, q: p @ q, a, x),
                "chunk": lambda a, x: _chunked(lambda p, q: p @ q, 2048, a, x)}
    for what, a, x in ((f"J'J ({nz}, {ne}) x ({ne}, {nz})", J.mT, J),
                       (f"Jg dxi/dz (4, 3) x (3, {nz})", Jg, dxi)):
        for name, f in per_lane.items():
            cases.append((what, name, lambda a=a, x=x, f=f, sl=None: f(a[sl], x[sl]), a))
    Hs = rnd(bmax, nz, nz)
    spd = Hs @ Hs.mT + nz * torch.eye(nz, dtype=dtype, device=dev)
    for what, a, x in ((f"J'e ({nz}, {ne})", J.mT, e), (f"H x ({nz}, {nz})", spd, rnd(bmax, nz))):
        for name, f in (("bmm", lambda a, x: (a @ x[..., None])[..., 0]),
                        ("exact_mv", lanes.exact_mv)):
            cases.append((what, name, lambda a=a, x=x, f=f, sl=None: f(a[sl], x[sl]), a))
    L = torch.linalg.cholesky(spd)
    b = rnd(bmax, nz, 1)
    for name, wrap in (("plain", lambda fn, *xs: fn(*xs)), ("min2", _min_lanes)):
        cases.append((f"cholesky_ex ({nz}, {nz})", name,
                      lambda wrap=wrap, sl=None: wrap(lambda m: torch.linalg.cholesky_ex(m)[0],
                                                     spd[sl]), spd))
        cases.append((f"solve_triangular ({nz}, {nz}) lower", name,
                      lambda wrap=wrap, sl=None: wrap(lambda l, r: torch.linalg.solve_triangular(
                          l, r, upper=False), L[sl], b[sl]), L))
        cases.append((f"solve_triangular ({nz}, {nz}) upper", name,
                      lambda wrap=wrap, sl=None: wrap(lambda l, r: torch.linalg.solve_triangular(
                          l.mT, r, upper=True), L[sl], b[sl]), L))
    for n in (mI, ne, 100, nz):
        v = rnd(bmax, n)
        for name, f in (("sum", lambda x: x.sum(-1)), ("lane_sum", lanes.lane_sum),
                        ("exact_sum", lanes.exact_sum)):
            cases.append((f"row sum of {n}", name, lambda v=v, f=f, sl=None: f(v[sl]), v))
    q = 100
    win = DataWindow(0.1 * rnd(bmax, q, 3), 0.001 * rnd(bmax, q, 4),
                     torch.ones(bmax, q, dtype=dtype, device=dev),
                     torch.full((bmax,), q, dtype=torch.int32, device=dev))
    xi = 0.1 * rnd(bmax, 3)
    for name, wsum in (("sum", lambda v, d: v.sum(d)),
                       ("exact", lambda v, d: lanes.exact_sum(v.movedim(d, -1))),
                       ("split", lambda v, d: lanes.split_sum(v.movedim(d, -1)))):
        cases.append((f"nw_estimate_and_jac (q={q})", name,
                      lambda sl=None, wsum=wsum: _nw_with(wsum, xi[sl],
                                                          DataWindow(*(w[sl] for w in win))),
                      xi))

    for what, name, fn, _ in cases:
        ref = torch.nan_to_num(fn(sl=slice(0, bmax)), nan=1.5)
        bad = [B for B in batches
               if not all(torch.equal(torch.nan_to_num(fn(sl=slice(lo, lo + B)), nan=1.5),
                                      ref[lo:lo + B]) for lo in (0, B))]
        ms = (cs.cuda_ms(lambda: fn(sl=slice(0, max(batches))), reps=5, warmup=1) if card
              else None)
        plain = plains.get(what)
        same = ("" if plain is None else
                f"; equal to the plain product at B = "
                f"{[B for B in (8, 256, 2048) if torch.equal(fn(sl=slice(0, B)), plain(slice(0, B)))]}")
        print(f"  {dtype} {what} {name}: B where a lane differs {bad}; "
              f"ms at B={max(batches)} {None if ms is None else round(ms, 4)}{same}", flush=True)
        del ref


def per_problem(args) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.oracle import DataWindow
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = torch.device(args.device)
    card = dev.type == "cuda"
    if card:
        print(cs.card_line(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    batches = [int(b) for b in args.batches.split(",")]
    print(PER_PROBLEM_FORMS, flush=True)
    base = lt.make_preset("LBMPC_N40", iterations=5)
    for dt in ("float64", "float32"):
        cfg = dataclasses.replace(base, solver=dataclasses.replace(base.solver, dtype=dt))
        if not card:
            cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
                                      oracle=dataclasses.replace(cfg.oracle, q=8),
                                      solver=dataclasses.replace(cfg.solver, sqp_iters=2,
                                                                 ipm_iters=10))
        sc = build_scenario(cfg, device=dev)
        f = torch.float64 if dt == "float64" else torch.float32
        t0 = time.time()
        print(f"1. operations, {dt}", flush=True)
        per_problem_ops(dev, batches, cs, sc, f)
        print(f"  ({time.time() - t0:.1f} s)", flush=True)

        print(f"2. the solve, {dt}: N={cfg.ocp.N}, q={cfg.oracle.q}, sqp "
              f"{cfg.solver.sqp_iters}, ipm {cfg.solver.ipm_iters}", flush=True)
        rng = np.random.default_rng(5)
        bmax, q = max(batches), cfg.oracle.q
        T = lambda a: torch.as_tensor(a, dtype=f, device=dev)
        dx = T(np.asarray(cfg.dx_init) + 0.01 * rng.standard_normal((bmax, 4)))
        win = DataWindow(T(0.1 * rng.standard_normal((bmax, q, 3))),
                         T(0.001 * rng.standard_normal((bmax, q, 4))),
                         T(np.ones((bmax, q))), torch.full((bmax,), q, dtype=torch.int32,
                                                           device=dev))
        z = T(0.01 * rng.standard_normal((bmax, sc.nz)))
        lanes_of = lambda i, j: (dx[i:j], DataWindow(*(a[i:j] for a in win)), z[i:j])
        solo = {}
        first_bad = None
        for B in batches:
            t0 = time.time()
            zb, cb = sc.solve(*lanes_of(0, B))
            if card:
                torch.cuda.synchronize()
            t_b = time.time() - t0
            diffs = {}
            for i in sorted({0, B // 2, B - 1}):
                if i not in solo:
                    solo[i] = sc.solve(*lanes_of(i, i + 1))
                zs, cs_ = solo[i]
                diffs[i] = (None if torch.equal(zb[i], zs[0]) and bool(cb[i] == cs_[0])
                            else (zb[i] - zs[0]).abs().max().item())
            same = all(v is None for v in diffs.values())
            if not same and first_bad is None:
                first_bad = B
            print(f"  B={B}: lanes {sorted(diffs)} equal their solves alone bit for bit "
                  f"{same} {'' if same else diffs}; conv {cb.float().mean().item():.4f}; "
                  f"{t_b:.2f} s", flush=True)
        if first_bad is not None and first_bad <= 256:   # the record holds every output
            report(f"origins, {dt} solve", first_bad, 1, record(lambda: sc.solve(
                *lanes_of(0, first_bad))), record(lambda: sc.solve(*lanes_of(0, 1))))

        print(f"3. a 5-step episode, {dt}", flush=True)
        ep = (1, 2, 3, 16, 256) if card else (1, 2, 3, 16)
        dxe = (np.asarray(cfg.dx_init) + 0.005 * np.random.default_rng(38)
               .standard_normal((max(ep), 4)))
        full = sc.run_batch(dxe)
        for B in ep[:-1]:
            r = sc.run_batch(dxe[:B])
            same = torch.equal(r.sys_history, full.sys_history[:B])
            d = (r.sys_history - full.sys_history[:B]).abs().max().item()
            print(f"  lanes of {B} against the same lanes of {max(ep)}: bit for bit {same}"
                  f" (max |d| {d:.3e})", flush=True)
    return 0


def cost(args) -> int:
    import torch

    root = pathlib.Path(args.package_root).resolve() if args.package_root else ROOT
    sys.path.insert(0, str(root))
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.examples import fleet_100k
    from lbmpc_tpu_torch.ops import _cuda, chol_kernel, mono_kernel
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    dev = torch.device(args.device)
    card = dev.type == "cuda"
    lanes, cohort = (256, cs.COHORT) if card else (8, 16)
    print(f"{cs.card_line() if card else 'cpu'}; package {pathlib.Path(lt.__file__).parent}",
          flush=True)
    if card:
        _cuda.BUILD_DIR = ROOT / "build" / "lbmpc_tpu_torch"
        _cuda.build_all(tuple(chol_kernel.KERNELS) + (mono_kernel.KERNEL,
                                                      mono_kernel.KERNEL_WIDE))
    sync = torch.cuda.synchronize if card else (lambda: None)
    cfg = lt.make_preset("LBMPC_N40", iterations=4)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, dtype="float64"))
    if not card:
        cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
                                  oracle=dataclasses.replace(cfg.oracle, q=8))
    dx = (np.asarray(cfg.dx_init) + 0.005 * np.random.default_rng(38)
          .standard_normal((lanes, 4)))
    sc = build_scenario(cfg, device=dev)
    sc.run_batch(dx[:2])
    sync()
    t0 = time.time()
    sc.run_batch(dx)
    sync()
    print(f"  phase 38's run_batch (LBMPC_N40 float64, {lanes} lanes): "
          f"{(time.time() - t0) * 1e3 / cfg.iterations:.1f} ms/step", flush=True)
    n20 = lt.make_preset("LBMPC_N40", iterations=3)
    n20 = dataclasses.replace(n20, ocp=dataclasses.replace(n20.ocp, N=20),
                              oracle=dataclasses.replace(n20.oracle, q=100),
                              solver=dataclasses.replace(n20.solver, sqp_iters=2,
                                                         dtype="float32"))
    n40 = dataclasses.replace(lt.make_preset("LBMPC_N40", iterations=3),
                              solver=dataclasses.replace(n20.solver))
    dx_init = torch.as_tensor(np.array([-0.35, -0.4, 0.0, 0.0]) + np.random.default_rng(1)
                              .uniform(-0.02, 0.02, (cohort, 4)), dtype=torch.float32,
                              device=dev)
    fleets = (("n20_xla", n20, {}), ("n20_pallas_mono", n20, dict(qp_kernel="pallas_mono")),
              ("n40_mono", n40, dict(qp_kernel="pallas_mono")))
    for what, fcfg, kw in fleets if card else fleets[:1]:
        _, run = build_fleet_episode(fcfg, backend="hybrid", ipm_iters=cs.XLA_SCHED,
                                     sqp_iters=2, device=dev, **kw)
        run(dx_init[:16])
        sync()
        t0 = time.time()
        res = run(dx_init)
        sync()
        print(f"  {what} hybrid fleet (vmapped repair), cohort {cohort}: "
              f"{(time.time() - t0) * 1e3 / fcfg.iterations:.1f} ms/step, conv "
              f"{res.solver_converged.float().mean().item():.6f}", flush=True)
        if args.trace and what == "n20_pallas_mono":
            trace(run, dx_init, sync)
    argv = (["--instances", "4096", "--chunk", "2048", "--steps", "2"] if card
            else ["--cpu", "--instances", "8", "--chunk", "4", "--steps", "1"])
    line = cs.run_example(fleet_100k.main, argv)
    print(f"  fleet_100k {' '.join(argv)}: {line['value']} solves/s", flush=True)
    return 0

def trace(run, dx_init, sync) -> None:
    """One run of a fleet under torch.profiler: the operations that take
    the most device time and the most host time, with their calls."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dx_init.is_cuda else [])
    with profile(activities=acts) as prof:
        run(dx_init)
        sync()
    rows = prof.key_averages()
    dev_ms = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / 1e3
    print(f"  trace: device {sum(map(dev_ms, rows)):.1f} ms, host "
          f"{sum(e.self_cpu_time_total for e in rows) / 1e3:.1f} ms in all", flush=True)
    for what, key in (("device", dev_ms), ("host", lambda e: e.self_cpu_time_total / 1e3)):
        for e in sorted(rows, key=key, reverse=True)[:12]:
            print(f"    by {what}: {e.key[:60]:60s} calls {e.count:7d} device "
                  f"{dev_ms(e):9.2f} ms host {e.self_cpu_time_total / 1e3:9.2f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
