#!/usr/bin/env python3
"""Split K2w's (and K3w's) time into the phases of a Mehrotra iteration, on
the card.

Builds K2w (csrc/mehrotra_h_wide.cu) and K3w (csrc/gn_mehrotra_wide.cu) a
second time with -DK2W_PHASE_CLOCKS beside the package's flags. In that
build thread 0 of every block adds the clock64() cycles of each phase of
each iteration (csrc/mehrotra_wide.cuh, PhaseClock): the G x pass, the
residuals and G'z, the assembly of G' diag(d) G, the equilibration, the
factorization, and for the two KKT solves the G'v pass, the triangular
sweeps and the G dx pass; the block reductions, ratio tests and updates.
The script reads the counters back per block and prints, per shape, the
mean cycles a block spends in each phase, each phase's share, and the
kernel's time with CUDA events in the instrumented and in the package's
build. Shapes: the DMS flagship's QP (casadi, N=100, nz=101, G (1024, 101),
B=1024) at 16 and 8 iterations, and the uncut LBMPC_N40 QP (nz=41, G
(414, 41), B=8192) at 8 iterations cold and 2 warm from the 8's state,
each QP built from K1w's H and g on seeded inputs (chip_smoke.py phase
20's); K3w at N40 (16 and 8 iterations). Needs one card; one JSON line per
case, and the table.

    python3 tools/k2w_split.py [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
PHASES = ("G x", "rp, d, G'z, rd", "assembly", "equilibration", "factorization",
          "KKT G'v", "KKT sweeps", "KKT G dx", "reductions, ratio tests, updates")
SLOTS = len(PHASES) + 1   # + the whole loop (csrc/mehrotra_wide.cuh kClockSlots)
CLOCK_BLOCKS = 16384      # csrc/mehrotra_wide.cuh kClockBlocks
_CLOCKED: dict = {}


def clocked_kernels() -> dict:
    """K2w's and K3w's clocked builds ({"k2w", "k3w"}: CudaKernels with
    -DK2W_PHASE_CLOCKS beside the package's flags), made once, not built."""
    if not _CLOCKED:
        from lbmpc_tpu_torch.ops import _cuda, mono_kernel, qp_kernel

        for key, k in (("k2w", qp_kernel.KERNEL_WIDE), ("k3w", mono_kernel.KERNEL_WIDE)):
            _CLOCKED[key] = _cuda.CudaKernel(k.name, k.argtypes,
                                             flags=k.flags + ("-DK2W_PHASE_CLOCKS",))
    return _CLOCKED


def reader(k):
    """The `<source>_clocks` C function of the clocked kernel k (built and
    loaded here if needed)."""
    k.fn()
    lib = ctypes.CDLL(str(k.library_path()))
    read = getattr(lib, f"{k.source.stem}_clocks")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    return read


def format_split(split: dict) -> str:
    return (", ".join(f"{name} {v['share'] * 100:.1f}%" for name, v in split["phases"].items())
            + f"; {split['cycles_per_block_iteration']:.0f} cycles a block-iteration")


def read_split(read, blocks: int, iters: int) -> dict:
    import torch

    torch.cuda.synchronize()
    out = np.zeros(blocks * SLOTS, np.uint64)
    rc = read(out.ctypes.data, blocks)
    if rc != 0:
        raise RuntimeError(f"reading the phase clocks failed: CUDA error {rc}")
    per = out.reshape(blocks, SLOTS).astype(np.float64)
    mean = per.mean(axis=0)
    total = mean[-1]
    return {"cycles_per_block": float(total),
            "cycles_per_block_iteration": float(total / max(iters, 1)),
            "phases": {name: {"cycles_per_iteration": float(mean[i] / max(iters, 1)),
                              "share": float(mean[i] / total) if total else 0.0}
                       for i, name in enumerate(PHASES)},
            "unaccounted_share": float(1.0 - mean[:-1].sum() / total) if total else 0.0}


def sm_clock() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2w_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops import _cuda, mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import WidePlan, mehrotra_h, step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    package = {"k2w": qp_kernel.KERNEL_WIDE, "k3w": mono_kernel.KERNEL_WIDE}
    clocked = clocked_kernels()
    logs = _cuda.build_all([*package.values(), *clocked.values()], verbose=True)
    for name, text in logs.items():
        print(f"ptxas {name}: " + "; ".join(ln.strip() for ln in text.splitlines()
                                            if "registers" in ln or "spill" in ln), flush=True)
    k2c, k3c = clocked["k2w"], clocked["k3w"]
    read2, read3 = reader(k2c), reader(k3c)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def setup(name: str, B: int, seed: int):
        c = lt.make_preset(name)
        c = dataclasses.replace(c, solver=dataclasses.replace(c.solver, dtype="float32"))
        s = build_scenario(c)
        kw = dict(family=c.family, delta=c.plant.ts, bandwidth=c.oracle.bandwidth,
                  ridge=c.oracle.ridge, dx_ref=np.asarray(c.dx_ref))
        gn = GNPhase(s.qp, s.A, s.B, s.ocp.Ks, s.w, device=dev, **kw)
        dx, win, z = chip_smoke.family_inputs(seed, B, c, s.nz, dev)
        if c.family == "casadi":
            z = torch.zeros_like(z)
        G, h0, Hp = f(s.qp.G), f(s.qp.h0), f(s.qp.Hp)
        _, H, g = gn(z, dx, win)
        return gn, G, h0, Hp, H, g, step_rhs(h0, Hp, G, dx, z), (z, dx, win), WidePlan(G)

    lines = []

    def emit(case: dict) -> None:
        lines.append(case)
        print(json.dumps(case), flush=True)

    def k2w_case(tag, G, H, g, h, it, warm=None):
        B = g.shape[0]
        run = lambda: mehrotra_h(G, H, g, h, it, warm=warm, want_state=True, plan=plan)
        qp_kernel.KERNEL_WIDE = k2c
        run()
        split = read_split(read2, min(B, CLOCK_BLOCKS), it)
        ms_clocked = chip_smoke.cuda_ms(run, reps=3)
        qp_kernel.KERNEL_WIDE = package["k2w"]
        ms = chip_smoke.cuda_ms(run, reps=3)
        emit({"kernel": "K2w", "case": tag, "B": B, "nz": g.shape[1], "mI": G.shape[0],
              "iters": it, "warm": warm is not None, "ms": ms, "ms_clocked": ms_clocked,
              **split})

    gn, G, h0, Hp, H, g, h, _, plan = setup("DMS_LBMPC_q100", 1024, 3)
    for it in (16, 8):
        k2w_case("DMS", G, H, g, h, it)
    gn, G, h0, Hp, H, g, h, ins, plan = setup("LBMPC_N40", 8192, 6)
    k2w_case("N40", G, H, g, h, 8)
    st = mehrotra_h(G, H, g, h, 8, want_state=True, plan=plan)[2]
    k2w_case("N40", G, H, g, h, 2, warm=st)
    for it in (16, 8):
        mono = MonoPhase(gn, G, h0, Hp, it)
        mono_kernel.KERNEL_WIDE = k3c
        mono(*ins)
        split = read_split(read3, min(ins[0].shape[0], CLOCK_BLOCKS), it)
        ms_clocked = chip_smoke.cuda_ms(lambda: mono(*ins), reps=3)
        mono_kernel.KERNEL_WIDE = package["k3w"]
        ms = chip_smoke.cuda_ms(lambda: mono(*ins), reps=3)
        emit({"kernel": "K3w", "case": "N40", "B": ins[0].shape[0], "nz": gn.nz,
              "mI": G.shape[0], "iters": it, "warm": False, "ms": ms,
              "ms_clocked": ms_clocked, **split})
    clock = sm_clock()
    print(f"SM clock now, max (MHz): {clock} {card}", flush=True)
    print("case                      " + "".join(f"{p[:12]:>13}" for p in PHASES), flush=True)
    for c in lines:
        tag = f"{c['kernel']} {c['case']} {c['iters']}{'w' if c['warm'] else ''} it"
        print(f"{tag:<26}" + "".join(f"{c['phases'][p]['share'] * 100:12.1f}%"
                                     for p in PHASES)
              + f"  {c['cycles_per_block_iteration']:.0f} cyc/it, {c['ms']:.3f} ms", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for c in lines:
                fh.write(json.dumps({**c, "card": card, "sm_clock": clock}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
