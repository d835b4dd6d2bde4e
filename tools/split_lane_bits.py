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

    python3 tools/split_lane_bits.py [--batch 2048] [--steps 2] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

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
    args = ap.parse_args(argv)
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


if __name__ == "__main__":
    sys.exit(main())
