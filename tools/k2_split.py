#!/usr/bin/env python3
"""Split K2's and K3's time into the phases of a Mehrotra iteration, on the
card.

Builds K2 (csrc/mehrotra_h.cu) and K3 (csrc/gn_mehrotra.cu) a second time
with -DK2_PHASE_CLOCKS beside the package's flags. In that build each lane
adds the clock64() cycles of each phase of each iteration of its Mehrotra
loop (the PhaseClock of the loop's header): the G x pass, the residuals and
G'z, the assembly of G' diag(d) G, the equilibration, the factorization,
and for the two KKT solves the G'v pass, the triangular sweeps and the G dx
pass; the reductions, ratio tests and updates. The script reads the
counters back per lane and prints the mean cycles a lane spends in each
phase and each phase's share (the phase names of tools/k2w_split.py), the
kernel's time with CUDA events in the instrumented and in the package's
build, each build's registers and spills (ptxas), and the lanes resident on
one SM. Shapes: the bench QP (LBMPC_N40 cut to N=20, q=100: nz=21, G (214,
21)) at B=2048, H and g from K1 on chip_smoke.py's seeded inputs: K2 at 8
iterations cold and 2 warm from the 8's state, K3 at 16 and 8; and at the
repair's B=24 (a block a lane), K2 at 8 and K3 at 16. K3's split covers
its Mehrotra loop; its GN phase is the rest of its time.

--csrc DIR builds the kernels from another lbmpc_tpu_torch/csrc with the
same C interface and a `<source>_clocks` reader. The one-block-a-lane K2
and K3 that ran csrc/mehrotra_body.cuh's block loop are split so: DIR
= `git archive 5f643e8 lbmpc_tpu_torch/csrc` unpacked, with commit
c22a8d5's mehrotra_body.cuh (the last that holds that loop's PhaseClock)
copied in, `K2_CLOCKS_EXPORT(<source>)`
appended to mehrotra_h.cu and gn_mehrotra.cu, and the package's
ops/qp_kernel.py and ops/mono_kernel.py argtypes of that interface (no lane
count). Needs one card; one JSON line per case, and the table.

    python3 tools/k2_split.py [--csrc DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))

from k2w_split import PHASES, read_split, sm_clock  # noqa: E402

CLOCK_LANES = 16384       # the loop headers' kClockLanes
N, Q, BATCH, SMALL = 20, 100, 2048, 24


def kernels(csrc: pathlib.Path | None = None, clocked: bool = False) -> dict:
    """K2's and K3's CudaKernels ({"k2", "k3"}), from the package's csrc or
    from `csrc`, with -DK2_PHASE_CLOCKS when `clocked`; not built."""
    from lbmpc_tpu_torch.ops import _cuda, mono_kernel, qp_kernel

    out = {}
    for key, k in (("k2", qp_kernel.KERNEL), ("k3", mono_kernel.KERNEL)):
        flags = k.flags + (("-DK2_PHASE_CLOCKS",) if clocked else ())
        c = _cuda.CudaKernel(k.name, k.argtypes, flags=flags)
        if csrc is not None:
            c.source = pathlib.Path(csrc) / k.source.name
        out[key] = c
    return out


def reader(k):
    """The `<source>_clocks` C function of the clocked kernel k (built and
    loaded here if needed)."""
    k.fn()
    lib = ctypes.CDLL(str(k.library_path()))
    read = getattr(lib, f"{k.source.stem}_clocks")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    return read


def resident_lanes(k, mI: int, nz: int, q: int, warps: int = 1):
    """Lanes one SM holds at (mI, nz, q) in blocks of `warps` lanes, from the
    kernel's `<source>_resident_lanes` (CUDA's occupancy calculator; a
    kernel of one lane a block takes no lane count), or None when the
    library has no such function."""
    k.fn()
    lib = ctypes.CDLL(str(k.library_path()))
    fn = getattr(lib, f"{k.source.stem}_resident_lanes", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return int(fn(mI, nz, q, warps))


def smem_bytes(k, mI: int, nz: int, q: int, warps: int) -> int:
    """A block's dynamic shared memory as the kernel computes it
    (`<source>_smem_bytes`), to hold ops/qp_kernel.narrow_smem_bytes to."""
    k.fn()
    fn = getattr(ctypes.CDLL(str(k.library_path())), f"{k.source.stem}_smem_bytes")
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(mI, nz, q, warps))


def resident_lanes_at(k, mI: int, nz: int, q: int, B: int):
    """resident_lanes at the launch shape the package picks for B lanes
    (ops/qp_kernel.narrow_launch; q = 0 for K2)."""
    from lbmpc_tpu_torch.ops.qp_kernel import narrow_launch

    return resident_lanes(k, mI, nz, q, narrow_launch(mI, nz, B, q=q)[0])


def ptxas_summary(log: str) -> str:
    """Each kernel instance's registers and spilled bytes from `nvcc -Xptxas
    -v` output: "name<kN,rows>: R registers, S B spilled; ..."."""
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name, spill = m.group(1), 0
            k = re.search(r"\d([a-z_]+_kernel)(?:ILi(\d+)EN5mwarp\d+(\w+?)EE)?", name)
            if k:
                name = k.group(1) + (f"<{k.group(2)},{k.group(3)}>" if k.group(2) else "")
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
            name = None
    return "; ".join(out)


def bench_qp(dev, B: int, seed: int = 0) -> dict:
    """The bench QP at batch B: chip_smoke.py's setup (LBMPC_N40 cut to
    N=20, q=100), its seeded inputs, H and g from K1, h in step_rhs's order."""
    import torch

    import chip_smoke
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.qp_kernel import step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
        oracle=dataclasses.replace(cfg.oracle, q=Q),
        solver=dataclasses.replace(cfg.solver, dtype="float32"))
    sc = build_scenario(cfg)
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, delta=cfg.plant.ts,
                 bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                 dx_ref=np.asarray(cfg.dx_ref), device=dev)
    dx, win, z = chip_smoke.bench_inputs(np.random.default_rng(seed), B, sc.nz, dev)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    G, h0, Hp = f(sc.qp.G), f(sc.qp.h0), f(sc.qp.Hp)
    _, H, g = gn(z, dx, win)
    return dict(gn=gn, G=G, h0=h0, Hp=Hp, H=H, g=g, h=step_rhs(h0, Hp, G, dx, z),
                ins=(z, dx, win))


def split_cases(qp: dict, clocked: dict, package: dict, cases, emit, reps: int = 5) -> None:
    """For each (kernel key "k2" or "k3", iters, warm) case on the bench QP
    `qp`: one launch of the clocked build, its split, and both builds' times.
    The package's kernel objects are swapped in and out of the wrappers'
    modules for the duration."""
    import chip_smoke
    from lbmpc_tpu_torch.ops import mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase

    G, H, g, h = qp["G"], qp["H"], qp["g"], qp["h"]
    B = g.shape[0]
    reads = {k: reader(v) for k, v in clocked.items()}
    slot = {"k2": (qp_kernel, "KERNEL"), "k3": (mono_kernel, "KERNEL")}
    saved = {k: getattr(*slot[k]) for k in slot}
    try:
        for key, it, warm in cases:
            if key == "k2":
                run = lambda: qp_kernel.mehrotra_h(G, H, g, h, it, warm=warm, want_state=True)
            else:
                mono = MonoPhase(qp["gn"], G, qp["h0"], qp["Hp"], it)
                run = lambda: mono(*qp["ins"])
            setattr(*slot[key], clocked[key])
            run()
            split = read_split(reads[key], min(B, CLOCK_LANES), it)
            ms_clocked = chip_smoke.cuda_ms(run, reps=reps)
            setattr(*slot[key], package[key])
            ms = chip_smoke.cuda_ms(run, reps=reps)
            emit({"kernel": key.upper(), "B": B, "nz": g.shape[1], "mI": G.shape[0],
                  "iters": it, "warm": warm is not None, "ms": ms, "ms_clocked": ms_clocked,
                  **split})
    finally:
        for k, (mod, attr) in slot.items():
            setattr(mod, attr, saved[k])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", default="", help="build from this lbmpc_tpu_torch/csrc directory")
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from lbmpc_tpu_torch.ops import _cuda
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h

    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    csrc = pathlib.Path(args.csrc) if args.csrc else None
    package, clocked = kernels(csrc), kernels(csrc, clocked=True)
    logs = _cuda.build_all([*package.values(), *clocked.values()], verbose=True)
    for name, text in logs.items():
        print(f"ptxas {name}: {ptxas_summary(text)}", flush=True)
    qp = bench_qp(dev, BATCH)
    mI, nz = qp["G"].shape
    for key, k in package.items():
        q = Q if key == "k3" else 0
        print(f"resident lanes per SM {key.upper()} (mI={mI}, nz={nz}, q={q}, B={BATCH}): "
              f"{resident_lanes_at(k, mI, nz, q, BATCH)}", flush=True)
    lines = []

    def emit(case: dict) -> None:
        lines.append(case)
        print(json.dumps(case), flush=True)

    from lbmpc_tpu_torch.ops import qp_kernel

    saved, qp_kernel.KERNEL = qp_kernel.KERNEL, package["k2"]
    try:
        st = mehrotra_h(qp["G"], qp["H"], qp["g"], qp["h"], 8, want_state=True)[2]
    finally:
        qp_kernel.KERNEL = saved
    split_cases(qp, clocked, package, [("k2", 8, None), ("k2", 2, st), ("k3", 16, None),
                                       ("k3", 8, None)], emit)
    # the repair's batch: a block a lane, one lane's latency
    small = {**qp, **{k: qp[k][:SMALL].contiguous() for k in ("H", "g", "h")},
             "ins": tuple(a[:SMALL].contiguous() for a in qp["ins"][:2])
             + (qp["ins"][2].index(torch.arange(SMALL, device=dev)),)}
    split_cases(small, clocked, package, [("k2", 8, None), ("k3", 16, None)], emit)
    clock = sm_clock()
    print(f"SM clock now, max (MHz): {clock} {card}", flush=True)
    print("case                      " + "".join(f"{p[:12]:>13}" for p in PHASES), flush=True)
    for c in lines:
        tag = f"{c['kernel']} B={c['B']} {c['iters']}{'w' if c['warm'] else ''} it"
        print(f"{tag:<26}" + "".join(f"{c['phases'][p]['share'] * 100:12.1f}%"
                                     for p in PHASES)
              + f"  {c['cycles_per_block_iteration']:.0f} cyc/lane-it, {c['ms']:.4f} ms",
              flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for c in lines:
                fh.write(json.dumps({**c, "card": card, "sm_clock": clock}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
