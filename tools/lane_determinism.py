#!/usr/bin/env python3
"""Find the op that parts identical lanes of the float32 pallas_mono hybrid
fleet on the card (chip_smoke.py phase 29's fleet: LBMPC_N50, every flagged
lane repaired on the vmapped backend, ipm (16, 8), sqp 2).

Three runs of the same cohort of identical lanes (copies of the preset's
dx_init):
1. as the package runs it: the first step whose logged [dx; du] differ
   across lanes;
2. under torch.use_deterministic_algorithms(True) (warn_only): if the lanes
   stay identical there, an op that uses atomics or depends on its batch
   position in a library kernel is at fault;
3. under a TorchDispatchMode that checks every aten op: before and after
   each op it compares the lanes of every tensor whose leading axis is the
   cohort (bit for bit; integer outputs, which hold indices, are not lane
   values and are skipped). It reports the first op whose lane-identical
   inputs gave outputs that differ across lanes, with its fleet step, its
   arguments' shapes, dtypes and strides and the Python stack of the call,
   and saves its arguments to --dump (torch.save, CPU copies) so that it can
   be replayed; if instead an op first sees inputs that already differ, the
   producer was not an aten op (a kernel of the port, launched through
   ctypes), and that is reported.
Needs one card.

    python3 tools/lane_determinism.py [--steps 40] [--lanes 8]
        [--dump FILE] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
SKIP_OPS = ("empty", "new_empty", "set_", "resize_", "_local_scalar_dense", "lift_fresh")


class Parted(Exception):
    pass


def same_lanes(t) -> bool:
    """Every lane of t (leading axis) equal to lane 0, bit for bit."""
    import torch

    if t.dtype == torch.bool:
        return bool((t == t[:1]).all())
    if t.dtype.is_floating_point:
        u = t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
        return bool((u == u[:1]).all())
    return bool((t == t[:1]).all())


def lane_tensor(t, B: int) -> bool:
    import torch

    return (isinstance(t, torch.Tensor) and t.dim() >= 1 and t.shape[0] == B
            and t.numel() > 0 and t.device.type != "meta"
            and (t.dtype.is_floating_point or t.dtype == torch.bool))


def make_mode(B: int, state: dict, dump: str):
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class LaneCheck(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = str(func)
            check = not any(s in name for s in SKIP_OPS)
            ins = [t for t in tree_flatten((args, kwargs))[0] if lane_tensor(t, B)] if check else []
            ins_same = [same_lanes(t) for t in ins]
            saved = None
            if check and all(ins_same):
                saved = [(a.detach().cpu().clone() if isinstance(a, torch.Tensor) else a)
                         for a in tree_flatten((args, kwargs))[0]]
            out = func(*args, **kwargs)
            state["ops"] += 1
            if not check:
                return out
            outs = [t for t in tree_flatten(out)[0] if lane_tensor(t, B)]
            if not all(ins_same) and state.get("first_parted_input") is None:
                state["first_parted_input"] = dict(
                    op=name, step=state["step"], op_index=state["ops"],
                    inputs=[dict(shape=list(t.shape), dtype=str(t.dtype), same=s)
                            for t, s in zip(ins, ins_same)],
                    stack=stack())
            if all(ins_same) and not all(same_lanes(t) for t in outs):
                spec = [dict(shape=list(a.shape), dtype=str(a.dtype), stride=list(a.stride()),
                             device=str(a.device)) if isinstance(a, torch.Tensor) else repr(a)
                        for a in tree_flatten((args, kwargs))[0]]
                state["culprit"] = dict(op=name, step=state["step"], op_index=state["ops"],
                                        args=spec, stack=stack(),
                                        outputs=[dict(shape=list(t.shape), dtype=str(t.dtype),
                                                      same=same_lanes(t)) for t in outs])
                if dump:
                    pathlib.Path(dump).parent.mkdir(parents=True, exist_ok=True)
                    torch.save({"op": name, "args": saved}, dump)
                raise Parted(name)
            return out

    return LaneCheck()


def stack() -> list:
    return [f"{pathlib.Path(f.filename).name}:{f.lineno} {f.name}"
            for f in traceback.extract_stack()[:-3]
            if "lbmpc_tpu_torch" in f.filename or "tools" in f.filename]


def first_part(sysH) -> int | None:
    parted = (sysH != sysH[:1]).any(dim=2).any(dim=0).nonzero()
    return int(parted[0]) if parted.numel() else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--dump", default="", help="save the culprit op's arguments here")
    ap.add_argument("--out", default="", help="also write the JSON report here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("lane_determinism: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    cfg = lt.make_preset("LBMPC_N50", iterations=args.steps)
    _, run = build_fleet_episode(cfg, backend="hybrid", qp_kernel="pallas_mono",
                                 ipm_iters=(16, 8), sqp_iters=2, repair_frac=1.0, device=dev)
    dx = np.broadcast_to(np.asarray(cfg.dx_init), (args.lanes, 4)).copy()
    report = {"card": card, "lanes": args.lanes, "steps": args.steps}

    t0 = time.time()
    res = run(dx)
    torch.cuda.synchronize()
    report["package"] = dict(first_step_parted=first_part(res.sys_history),
                             seconds=time.time() - t0)
    print(f"package run: lanes part at step {report['package']['first_step_parted']}",
          flush=True)

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        res = run(dx)
        torch.cuda.synchronize()
        report["deterministic_algorithms"] = dict(first_step_parted=first_part(res.sys_history))
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"use_deterministic_algorithms(True): lanes part at step "
          f"{report['deterministic_algorithms']['first_step_parted']}", flush=True)

    state = {"ops": 0, "step": -1}
    solver = run.solver
    raw = solver.raw

    def counted(*a, **k):
        state["step"] += 1
        return raw(*a, **k)

    solver.raw = counted
    t0 = time.time()
    try:
        with make_mode(args.lanes, state, args.dump):
            res = run(dx)
            torch.cuda.synchronize()
        report["op_check"] = dict(culprit=None, first_step_parted=first_part(res.sys_history))
    except Parted:
        report["op_check"] = dict(culprit=state["culprit"])
    finally:
        del solver.raw
    report["op_check"].update(ops_checked=state["ops"], seconds=time.time() - t0,
                              first_parted_input=state.get("first_parted_input"))
    print(json.dumps(report, indent=1), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
