#!/usr/bin/env python3
"""Lane-exact form sets for the per-problem stack, held to the float32
phases of chip_smoke.py that compare closed loops (card only).

Every set below gives a lane the same bits at any batch size (each form's
order is fixed by the shapes); they differ in rounding, and a 20-step
float32 closed loop parts wherever a stalled solve meets a different
rounding. For each set this runs, every gate logged and none stopping
the run (with --stop-at-fail a set ends at its first failed gate):
  0. with --shipping, phase 32 (chip_smoke.shipping_phase: the float32
     pallas_full hybrid with the fused repair of 1 lane in 8 identical
     ones at LBMPC_N50, 300 steps; its forms are the closed loop's and the
     oracle's, the lanes part where a repair of lane 0 converges);
  1. phase 22's comparison: the uncut LBMPC_N40 warm-chain hybrid fleet on
     pallas_full (K1w + K2w) against the plain route, cohort 8192, 20
     steps; the gate reads the first 256 lanes (median < 1e-6, max <
     5e-2), and this also counts the lanes beyond 5e-2 over the cohort, the
     worst lane and whether it was unconverged at some step on a side;
  2. with --mono, phases 24-28 (chip_smoke.mono_wide_phases: K3w against
     its plain version, whose GN phase takes these forms, the N40 solve and
     hybrid fleet, the N=20 hybrid fleets, the fleet solver);
  3. unless --no-golden, phase 29 (chip_smoke.golden_phases): the float32
     pallas_mono hybrid at LBMPC_N50 against the golden envelope over 40
     steps, then the float64 episodes.
The sets (ops/lanes patched in every loaded module of the package):
  gn      the package's forms: a short contraction (<= CHAIN_TERMS terms)
          as a product and then one FMA a term (torch.addcmul), in the GN
          phase's products (controllers/lbmpc.make_residual_and_jac, K1w's
          and K3w's plain version) each product and sum rounded on its own
          (the kernels' arithmetic, built with -fmad=false); exact_rows over
          a longer one, exact_mv, exact_sum, and the NW window's sums by
          lane_sum_dim in split_sum's rows of 32 entries, then the partials;
  muladd  gn with every short contraction unfused;
  chunk32 gn with every short contraction as FMAs;
  pad128  chunk32 with the NW window's sums in exact_sum's form (rows of
          64-127 entries padded to 128);
  rows    pad128 with every shared product through exact_rows
          (CHAIN_TERMS = 0);
  rows+chunk32  chunk32 with CHAIN_TERMS = 0;
  chunk16 chunk32 with the NW window's sums in rows of 16, then the
          partials;
  fmarev  gn with every short contraction as FMAs from the last term to
          the first;
  pairs   gn with every short contraction's products summed pairwise,
          (t0 + t1) + (t2 + t3), each operation rounded;
  batch   phase 22 only, a control: the library's products and sums as
          the batch picks them (not B-independent).

    python3 tools/f32_form_sets.py [--sets gn,muladd,...] [--shipping] [--mono]
                                   [--no-golden] [--stop-at-fail]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
SETS = ("gn", "muladd", "chunk32", "pad128", "rows", "rows+chunk32", "chunk16", "fmarev",
        "pairs", "batch")


def _pad128(v, dim: int):
    """v.sum(dim) in exact_sum's form on the card, v.sum(dim) on the CPU."""
    from lbmpc_tpu_torch.ops.lanes import exact_sum

    return exact_sum(v.movedim(dim, -1)) if v.is_cuda else v.sum(dim)


def _split16(v, dim: int):
    """v.sum(dim) on the card in rows of 16 entries, level by level, then
    the partials (split_sum's form with 16 for 32); v.sum(dim) on the CPU."""
    import torch.nn.functional as F_

    if not v.is_cuda:
        return v.sum(dim)
    v = v.movedim(dim, -1)
    while v.shape[-1] >= 64:
        v = F_.pad(v, (0, -v.shape[-1] % 16)).unflatten(-1, (-1, 16)).sum(-1)
    return v.contiguous().sum(-1)


def _fma_rev(a, b, c: int, fused=None):
    """sum_j a(j) * b(j): the last product, then one FMA a term down to j=0."""
    import torch

    out = a(c - 1) * b(c - 1)
    for j in range(c - 2, -1, -1):
        out = torch.addcmul(out, a(j), b(j))
    return out


def _pairs(a, b, c: int, fused=None):
    """sum_j a(j) * b(j) as a pairwise tree over the rounded products."""
    t = [a(j) * b(j) for j in range(c)]
    while len(t) > 1:
        t = [t[i] + t[i + 1] if i + 1 < len(t) else t[i] for i in range(0, len(t), 2)]
    return t[0]


@contextlib.contextmanager
def form_set(name: str):
    """Patch ops/lanes' forms in every loaded module of the package."""
    from lbmpc_tpu_torch.ops import lanes

    chain = lanes._term_chain
    patch = {}
    if name == "batch":
        patch = {"lane_mm": lambda v, M: v @ M.T, "lane_left": lambda M, S: M @ S,
                 "lane_sum_dim": lambda v, dim: v.sum(dim)}
    elif name == "fmarev":
        patch = {"_term_chain": _fma_rev}
    elif name == "pairs":
        patch = {"_term_chain": _pairs}
    elif name == "muladd":
        patch = {"_term_chain": lambda a, b, c, fused: chain(a, b, c, False)}
    elif name != "gn":
        patch = {"_term_chain": lambda a, b, c, fused: chain(a, b, c, True)}
        if name in ("pad128", "rows"):
            patch["lane_sum_dim"] = _pad128
        elif name == "chunk16":
            patch["lane_sum_dim"] = _split16
    mods = [m for n, m in list(sys.modules.items()) if n.startswith("lbmpc_tpu_torch")]
    saved = [(m, k, getattr(m, k)) for m in mods for k in patch if hasattr(m, k)]
    terms = lanes.CHAIN_TERMS
    try:
        for m, k, _ in saved:
            setattr(m, k, patch[k])
        if name.startswith("rows"):
            lanes.CHAIN_TERMS = 0
        yield
    finally:
        for m, k, f in saved:
            setattr(m, k, f)
        lanes.CHAIN_TERMS = terms


def phase22(dev, cs, tag: str) -> dict:
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    cfg = lt.make_preset("LBMPC_N40", iterations=cs.STEPS)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, sqp_iters=2,
                                                              dtype="float32"))
    kw = dict(backend="hybrid", ipm_iters=cs.IPM_SCHED, sqp_iters=2, qp_warm=True,
              warm_chain=True, qp_kernel="pallas_full", device=dev)
    dx_init = (np.array([-0.35, -0.4, 0.0, 0.0])
               + np.random.default_rng(1).uniform(-0.02, 0.02, (cs.COHORT, 4)))
    t0 = time.time()
    res = build_fleet_episode(cfg, **kw)[1](dx_init)
    res_p = build_fleet_episode(cfg, plain=True, **kw)[1](dx_init)
    torch.cuda.synchronize()
    d = (res.sys_history - res_p.sys_history).abs()
    lane = d.amax(dim=(1, 2))
    worst = int(lane[:256].argmax())
    step = int(d[worst].amax(dim=1).argmax())
    unconv = lambda r: (~r.solver_converged).any(dim=1)
    far = lane > 5e-2
    out = dict(median256=d[:256].median().item(), max256=lane[:256].max().item(),
               beyond256=int(far[:256].sum()), beyond=int(far.sum()),
               beyond_unconv=int((far & (unconv(res) | unconv(res_p))).sum()),
               worst=worst, worst_step=step,
               worst_unconv=(bool(unconv(res)[worst]), bool(unconv(res_p)[worst])))
    held = out["median256"] < 1e-6 and out["max256"] < 5e-2
    cs.log(f"  phase 22: first 256 lanes median {out['median256']:.3e} max {out['max256']:.3e} "
           f"(lane {worst}, step {step}, unconverged at some step kernel/plain "
           f"{out['worst_unconv']}); lanes beyond 5e-2: {out['beyond256']} of 256, "
           f"{out['beyond']} of {cs.COHORT} ({out['beyond_unconv']} of them unconverged at "
           f"some step on a side); gate {'held' if held else 'MISSED'}; "
           f"{time.time() - t0:.1f} s {tag}")
    cs.require(held, "phase 22: N40 fleet sys_history vs the plain route: median < 1e-6, "
               "max < 5e-2")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sets", default=",".join(SETS), help=f"of {SETS}")
    ap.add_argument("--shipping", action="store_true", help="phase 32 first")
    ap.add_argument("--mono", action="store_true", help="phases 24-28 too")
    ap.add_argument("--stop-at-fail", action="store_true",
                    help="end a set at its first failed gate")
    ap.add_argument("--no-golden", action="store_true", help="skip phase 29")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops import _cuda, chol_kernel, gn_kernel, mono_kernel, qp_kernel
    import lbmpc_tpu_torch.controllers.sqp_fused  # noqa: F401  (loads the stack)
    import lbmpc_tpu_torch.runtime.scenario  # noqa: F401

    if not torch.cuda.is_available():
        print("f32_form_sets: needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    tag = f"[{card}]"
    print(card, flush=True)
    t0 = time.time()
    kernels = (gn_kernel.KERNEL_WIDE, qp_kernel.KERNEL_WIDE, mono_kernel.KERNEL_WIDE)
    if args.mono:   # the N=20 fleets' K3 and K5, K3w's phase-clock build
        kernels += ((mono_kernel.KERNEL, *chol_kernel.KERNELS)
                    + tuple(cs.split_tool().clocked_kernels().values()))
    _cuda.build_all(kernels)
    print(f"{len(kernels)} kernels built in {time.time() - t0:.1f} s", flush=True)
    failed = []

    def require(ok: bool, what: str) -> None:
        cs.log(f"  check {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failed.append(what)

    cs.require = require
    bench = lt.make_preset("LBMPC_N40")     # chip_smoke's bench configuration
    bench = dataclasses.replace(
        bench, ocp=dataclasses.replace(bench.ocp, N=cs.N),
        oracle=dataclasses.replace(bench.oracle, q=cs.Q),
        solver=dataclasses.replace(bench.solver, sqp_iters=2, dtype="float32"))
    dx_init = (np.array([-0.35, -0.4, 0.0, 0.0])
               + np.random.default_rng(1).uniform(-0.02, 0.02, (cs.COHORT, 4)))
    for name in args.sets.split(","):
        if name not in SETS:
            raise SystemExit(f"unknown set {name!r}; sets are {SETS}")
        cs.log(f"== set {name}")
        n = len(failed)
        steps = []
        if args.shipping:
            steps.append(lambda: cs.shipping_phase(dev, tag))
        steps.append(lambda: phase22(dev, cs, tag))
        if name != "batch" and args.mono:
            steps.append(lambda: cs.mono_wide_phases(dev, tag, argparse.Namespace(stop_after=28),
                                                     collections.defaultdict(dict), bench,
                                                     dx_init))
        if name != "batch" and not args.no_golden:
            steps.append(lambda: cs.golden_phases(dev, tag))
        with form_set(name):
            for step in steps:
                step()
                if args.stop_at_fail and len(failed) > n:
                    break
        cs.log(f"  gates failed under {name}: {failed[n:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
