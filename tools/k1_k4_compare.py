#!/usr/bin/env python3
"""K1, K3 and K4 against an earlier tree's, in one session on the card.

Builds K1 (gn_phase.cu), K3 (gn_mehrotra.cu) and K4 (mehrotra.cu) from an
earlier tree's lbmpc_tpu_torch/csrc (--parent DIR: an unpacked `git archive
<commit>`) beside the package's; the earlier K1 and K4 are called through
their own C interface (no lane count). It prints, per case, one JSON line:
- ptxas' registers and spills of every build;
- K1's e, H and g against the earlier K1, bit for bit, at the bench shape
  (LBMPC_N40 cut to N=20, q=100: nz=21) on chip_smoke.py's seeded inputs
  at B = 24 (the repair's lanes), 2048 (the bench batch) and 8192 (the
  fleet cohort), and its device time there (chip_smoke.graph_ms: calls
  captured in a CUDA graph, replayed between CUDA events) in turns
  (parent, package, package, parent), with `package_host` (CUDA events
  around the calls, the host's enqueue included, as chip_smoke.cuda_ms
  reads them), the bound, and the lanes a block and an SM;
- K3 at 16 iterations at the same batches: bits against the earlier K3
  and against K1 -> step_rhs -> K2 (the same device code), and its device
  time in turns;
- K1w, K2w (8 iterations, its warm state) and K3w (where the reference's
  VMEM model admits it) against the earlier tree's, bit for bit, at N40
  (nz=41, B=2048) and the DMS flagship (nz=101, B=256): the headers they
  share with K1 and K4 moved code, not arithmetic;
- K4 on the N=20 LMPC QP (chip_smoke.lmpc_qp(): G (806, 21), 20
  iterations) at B = 8192 and 1024: device time in turns, the bound, the
  lanes a block and an SM, and phase 15's comparison with its plain
  version and a float64 solve (60 iterations), for both trees: |dx|
  median, conv, lanes with a NaN, lanes beyond 5e-2 of the float64
  optimum; and whether a lane's bits are the same alone (B = 1) and in
  the batch;
- K4 built with -DK4_IEEE_SWEEPS (its sweeps on __fdiv_rn, not on the
  pivots' reciprocals with Markstein's correction) beside the package's:
  bit-equal, and its time;
- K4's split by phase of a Mehrotra iteration (mean cycles a lane, shares;
  tools/k2w_split.py's phase names) at B = 8192: the earlier K4 built from
  a copy of its sources with `K2_CLOCKS_EXPORT(mehrotra)` appended and
  -DK2_PHASE_CLOCKS (its mehrotra_body.cuh clocks), the package's with
  -DK4_PHASE_CLOCKS when its source has that build.
--k4-probe also compares K4 with the earlier K4 lane by lane after 1, 2,
..., 20 iterations (B = 1024): the lanes whose x and mu are bit-equal, the
largest |dx|, the lanes that converge in one tree only.
--k1-variants / --k4-variants NAME:MACRO=V[+MACRO=V],... also build the
package's K1 / K4 with those macros and time them beside it, with their
bits against the package's.
Needs one card.

    python3 tools/k1_k4_compare.py --parent DIR [--k1-variants ...] [--k4-variants ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import shutil
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))

BATCHES = (24, 2048, 8192)
K4_BATCHES = (8192, 1024)
K4_ITERS, K4_OPT_ITERS = 20, 60
K3_ITERS = 16


def _lib(k):
    k.fn()
    return ctypes.CDLL(str(k.library_path()))


def _c_fn(k, name: str, nargs: int, restype=ctypes.c_int):
    """`name` from kernel k's library (ints in, restype out), or None."""
    fn = getattr(_lib(k), name, None)
    if fn is not None:
        fn.argtypes = [ctypes.c_int] * nargs
        fn.restype = restype
    return fn


def launch_shape(k, stem: str, *shape) -> tuple:
    """(a block's shared memory, the lanes an SM holds) as kernel k's library
    computes them (`<stem>_smem_bytes`, `<stem>_resident_lanes` at `shape`),
    each None where the library has no such function."""
    smem = _c_fn(k, f"{stem}_smem_bytes", len(shape), ctypes.c_longlong)
    res = _c_fn(k, f"{stem}_resident_lanes", len(shape))
    return (None if smem is None else int(smem(*shape)),
            None if res is None else int(res(*shape)))


def earlier_kernels(csrc: pathlib.Path) -> dict:
    """The earlier tree's K1 and K4 (one interface without a lane count), and
    K3, K1w, K2w and K3w (the interfaces this tree keeps)."""
    from lbmpc_tpu_torch.ops import _cuda, gn_kernel, mono_kernel, qp_kernel

    P_, I_, F_ = _cuda.P, _cuda.I, _cuda.F
    specs = {"k1": (gn_kernel.KERNEL, [P_] * 9 + [I_] * 3 + [P_]),
             "k3": (mono_kernel.KERNEL, mono_kernel.KERNEL.argtypes),
             "k4": (qp_kernel.KERNEL_SHARED, [P_] * 7 + [I_] * 4 + [F_, F_, P_]),
             "k1w": (gn_kernel.KERNEL_WIDE, gn_kernel.KERNEL_WIDE.argtypes),
             "k2w": (qp_kernel.KERNEL_WIDE, qp_kernel.KERNEL_WIDE.argtypes),
             "k3w": (mono_kernel.KERNEL_WIDE, mono_kernel.KERNEL_WIDE.argtypes)}
    out = {}
    for key, (k, args) in specs.items():
        c = _cuda.CudaKernel(k.name, args, flags=k.flags)
        c.source = csrc / k.source.name
        out[key] = c
    return out


def parent_clocked_k4(csrc: pathlib.Path, argtypes):
    """The earlier K4 built from a copy of `csrc` (build/k4_parent_clocks)
    with its loop header's phase clocks (-DK2_PHASE_CLOCKS) and a
    `mehrotra_clocks` reader appended."""
    from lbmpc_tpu_torch.ops import _cuda

    d = ROOT / "build" / "k4_parent_clocks"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    src = d / "mehrotra.cu"
    src.write_text(src.read_text() + "\nK2_CLOCKS_EXPORT(mehrotra)\n")
    k = _cuda.CudaKernel("mehrotra", argtypes, flags=("-DK2_PHASE_CLOCKS",))
    k.source = src
    return k


def variants(k, spec: str) -> dict:
    from lbmpc_tpu_torch.ops import _cuda

    out = {}
    for v in [v for v in spec.split(",") if v]:
        name, defs = v.split(":")
        out[name] = _cuda.CudaKernel(k.name, k.argtypes,
                                     flags=k.flags + tuple(f"-D{d}" for d in defs.split("+")))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="an earlier tree (holding lbmpc_tpu_torch/csrc)")
    ap.add_argument("--k1-variants", default="", help="comma-separated NAME:MACRO=V[+MACRO=V]")
    ap.add_argument("--k4-variants", default="", help="comma-separated NAME:MACRO=V[+MACRO=V]")
    ap.add_argument("--k4-probe", action="store_true",
                    help="K4 against the earlier K4 after 1, 2, ..., 20 iterations")
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_k4_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import k1w_k5_compare
    import k2w_split
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops import _cuda, gn_kernel, mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import (QPSolver, mehrotra, mehrotra_h, mehrotra_plain,
                                               sm_count, step_rhs)
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = sm_count(dev)
    card = cs.card_line()
    print(card, flush=True)
    csrc_old = pathlib.Path(args.parent) / "lbmpc_tpu_torch" / "csrc"
    old = earlier_kernels(csrc_old)
    k4 = qp_kernel.KERNEL_SHARED
    package = {"k1": gn_kernel.KERNEL, "k3": mono_kernel.KERNEL, "k4": k4,
               "k2": qp_kernel.KERNEL}
    old_clocked = parent_clocked_k4(csrc_old, old["k4"].argtypes)
    clocked = None
    if "K4_PHASE_CLOCKS" in k4.source.read_text():
        clocked = _cuda.CudaKernel(k4.name, k4.argtypes, flags=k4.flags + ("-DK4_PHASE_CLOCKS",))
    k1_var, k4_var = variants(gn_kernel.KERNEL, args.k1_variants), variants(k4, args.k4_variants)
    # K4's sweeps divide by a product and Markstein's correction; this build
    # divides by __fdiv_rn, and the two must agree bit for bit
    if "K4_IEEE_SWEEPS" in k4.source.read_text():
        k4_var.setdefault("ieee_sweeps", variants(k4, "v:K4_IEEE_SWEEPS=1")["v"])
    logs = _cuda.build_all([*package.values(), *old.values(), old_clocked,
                            *([clocked] if clocked else []), *k1_var.values(),
                            *k4_var.values()], verbose=True)
    lines = []

    def emit(case: dict) -> None:
        lines.append(case)
        print(json.dumps(case), flush=True)

    for name, text in logs.items():
        emit({"ptxas": name, "summary": k1w_k5_compare.ptxas_summary(text)})

    def same(a, b) -> bool:
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    def turns(fp, fk, reps: int) -> dict:
        t = {tag: cs.graph_ms(fn, reps=reps) for tag, fn in
             (("parent", fp), ("package", fk), ("package2", fk), ("parent2", fp))}
        t["package_host"] = cs.cuda_ms(fk, reps=reps)
        return t

    def swap(mod, attr, k, fn):
        saved = getattr(mod, attr)
        setattr(mod, attr, k)
        try:
            return fn()
        finally:
            setattr(mod, attr, saved)

    # ---- the bench shape: K1 and K3 ------------------------------------------
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=cs.N),
                              oracle=dataclasses.replace(cfg.oracle, q=cs.Q),
                              solver=dataclasses.replace(cfg.solver, dtype="float32"))
    sc = build_scenario(cfg)
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, delta=cfg.plant.ts,
                 bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                 dx_ref=np.asarray(cfg.dx_ref), device=dev)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    G, h0, Hp = f(sc.qp.G), f(sc.qp.h0), f(sc.qp.Hp)
    mI, nz = G.shape
    dx_all, win_all, z_all = cs.bench_inputs(np.random.default_rng(0), max(BATCHES), nz, dev)

    def run_old_k1(z, dx, win, k=None):
        B, q = z.shape[0], win.X.shape[-2]
        f32 = dict(dtype=torch.float32, device=dev)
        e = torch.empty(B, gn.ne, **f32)
        H = torch.empty(B, nz, nz, **f32)
        g = torch.empty(B, nz, **f32)
        p, I_ = _cuda.ptr, _cuda.I
        (k or old["k1"]).launch(dev, p(gn.cst), p(z), p(dx), p(win.X), p(win.Y), p(win.valid),
                                p(e), p(H), p(g), I_(B), I_(gn.N), I_(q))
        return e, H, g

    mono = MonoPhase(gn, G, h0, Hp, K3_ITERS)
    for B in BATCHES:
        idx = torch.arange(B, device=dev)
        z, dx, win = z_all[:B].contiguous(), dx_all[:B].contiguous(), win_all.index(idx)
        new = gn(z, dx, win)
        ref = run_old_k1(z, dx, win)
        ep, Hpl, gp = gn.plain(z, dx, win)
        torch.cuda.synchronize()
        hmax = Hpl.abs().max().item()
        err = max((a - b).abs().max().item() for a, b in zip(new, (ep, Hpl, gp)))
        t = turns(lambda: run_old_k1(z, dx, win), lambda: gn(z, dx, win), reps=20)
        var = {}
        for name, k in k1_var.items():
            vb = swap(gn_kernel, "KERNEL", k, lambda: gn(z, dx, win))
            var[name] = {"bit_equal_package": same(vb, new),
                         "ms": swap(gn_kernel, "KERNEL", k,
                                    lambda: cs.graph_ms(lambda: gn(z, dx, win)))}
        launch = getattr(gn_kernel, "narrow_gn_launch", None)
        lanes = blocks = smem = c_smem = resident = None
        if launch is not None:
            lanes, blocks, smem = launch(nz, cs.Q, B, sms=sms)
            c_smem, resident = launch_shape(gn_kernel.KERNEL, "gn_phase", nz, cs.Q, lanes)
        bd = cs.bound_ms(*cs.gn_work(B, cs.N, cs.Q, gn.ne, nz, gn.cst.numel()))
        emit({"kernel": "K1", "nz": nz, "q": cs.Q, "B": B, "bit_equal_parent": same(new, ref),
              "H_symmetric": bool(torch.equal(new[1], new[1].transpose(1, 2))),
              "vs_plain_over_max_H": err / hmax, "ms": t, "variants": var,
              "bound_ms": bd[0], "bound_by": bd[1], "lanes_a_block": lanes, "blocks": blocks,
              "smem": smem, "smem_matches_kernel": None if smem is None else c_smem == smem,
              "lanes_an_sm": resident})

        # K3: the earlier K3's bits, K1 -> step_rhs -> K2, and its time
        m_new = mono(z, dx, win)
        m_old = swap(mono_kernel, "KERNEL", old["k3"], lambda: mono(z, dx, win))
        e1, H1, g1 = gn(z, dx, win)
        x2, mu2, _ = mehrotra_h(G, H1, g1, step_rhs(h0, Hp, G, dx, z), K3_ITERS)
        torch.cuda.synchronize()
        t3 = turns(lambda: swap(mono_kernel, "KERNEL", old["k3"], lambda: mono(z, dx, win)),
                   lambda: mono(z, dx, win), reps=5 if B > 24 else 20)
        bd3 = cs.bound_ms(*cs.mono_work(B, cs.N, cs.Q, gn.ne, nz, gn.cst.numel(), mI, K3_ITERS))
        emit({"kernel": "K3", "iters": K3_ITERS, "B": B, "bit_equal_parent": same(m_new, m_old),
              "equals_k1_k2": same(m_new, (e1, x2, mu2, g1)), "ms": t3,
              "bound_ms": bd3[0], "bound_by": bd3[1]})

    # ---- K1w, K2w and K3w: the earlier bits (headers they share moved code) ---
    for family, nz_w, B in (("fmincon", 41, 2048), ("casadi", 101, 256)):
        wcfg = lt.make_preset("LBMPC_N40" if family == "fmincon" else "DMS_LBMPC_q100")
        wcfg = dataclasses.replace(wcfg, ocp=dataclasses.replace(wcfg.ocp, N=nz_w - 1))
        wsc = build_scenario(wcfg)
        wgn = GNPhase(wsc.qp, wsc.A, wsc.B, wsc.ocp.Ks, wsc.w, family=family,
                      delta=wcfg.plant.ts, bandwidth=wcfg.oracle.bandwidth,
                      ridge=wcfg.oracle.ridge, dx_ref=np.asarray(wcfg.dx_ref), device=dev)
        wdx, wwin, wz = cs.family_inputs(3, B, wcfg, nz_w, dev)
        Gw, h0w, Hpw = f(wsc.qp.G), f(wsc.qp.h0), f(wsc.qp.Hp)
        new1 = wgn(wz, wdx, wwin)
        old1 = swap(gn_kernel, "KERNEL_WIDE", old["k1w"], lambda: wgn(wz, wdx, wwin))
        hw = step_rhs(h0w, Hpw, Gw, wdx, wz)
        solve_w = lambda: mehrotra_h(Gw, new1[1], new1[2], hw, 8, want_state=True)
        new2, old2 = solve_w(), swap(qp_kernel, "KERNEL_WIDE", old["k2w"], solve_w)
        res = {"kernel": "K1w K2w K3w", "family": family, "nz": nz_w, "B": B,
               "k1w_bit_equal_parent": same(new1, old1),
               "k2w_bit_equal_parent": same((new2[0], new2[1], *new2[2]),
                                            (old2[0], old2[1], *old2[2]))}
        if Gw.shape[0] <= qp_kernel.MI_MAX:
            mono_w = MonoPhase(wgn, Gw, h0w, Hpw, 8)
            if mono_w.wide:
                res["k3w_bit_equal_parent"] = same(
                    mono_w(wz, wdx, wwin),
                    swap(mono_kernel, "KERNEL_WIDE", old["k3w"], lambda: mono_w(wz, wdx, wwin)))
        torch.cuda.synchronize()
        emit(res)

    # ---- K4 on the LMPC QP ---------------------------------------------------
    lqp = cs.lmpc_qp()
    rng = np.random.default_rng(5)                     # chip_smoke.py phase 15's lanes
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((max(K4_BATCHES), 4))
    g4_all, h4_all = (f(a).contiguous() for a in ((lqp.Gg @ dxs.T).T + lqp.g0,
                                                   lqp.h0 + (lqp.Hp @ dxs.T).T))
    solver = QPSolver(lqp.H, lqp.G, iters=K4_ITERS, device=dev)
    G4, H4 = solver.G, solver.H
    mI4, nz4 = G4.shape

    def run_old_k4(g, h, k=None, iters=K4_ITERS):
        B = g.shape[0]
        x = torch.empty(B, nz4, dtype=torch.float32, device=dev)
        conv = torch.empty(B, dtype=torch.bool, device=dev)
        mu = torch.empty(B, dtype=torch.float32, device=dev)
        p, I_, F_ = _cuda.ptr, _cuda.I, _cuda.F
        (k or old["k4"]).launch(dev, p(G4), p(H4), p(g), p(h), p(x), p(conv), p(mu), I_(B),
                                I_(mI4), I_(nz4), I_(iters), F_(0.995),
                                F_(qp_kernel.SHARED_D_CAP))
        return x, conv, mu

    def gates(x, conv, mu, xp, cp, x64) -> dict:
        fin = (x - xp).abs().amax(dim=1).isfinite()
        far = lambda a: int((~((a.double() - x64).abs().amax(dim=1) <= 5e-2)).sum())
        return {"dx_median": (x - xp)[fin].abs().median().item(),
                "conv": conv.float().mean().item(), "conv_plain": cp.float().mean().item(),
                "nan_lanes": int(x.isnan().any(dim=1).sum()),
                "far_from_float64": far(x), "far_from_float64_plain": far(xp),
                "mu_ge_1e-6": int((~(mu < 1e-6)).sum())}

    for B in K4_BATCHES:
        g4, h4 = g4_all[:B].contiguous(), h4_all[:B].contiguous()
        xk, ck, muk = mehrotra(G4, H4, g4, h4, K4_ITERS)
        xo, co, muo = run_old_k4(g4, h4)
        xp, cp, _ = mehrotra_plain(G4, H4, g4, h4, K4_ITERS)
        x64 = mehrotra_plain(G4.double(), H4.double(), g4.double(), h4.double(),
                             K4_OPT_ITERS)[0]
        x1, c1, mu1 = mehrotra(G4, H4, g4[:1].contiguous(), h4[:1].contiguous(), K4_ITERS)
        torch.cuda.synchronize()
        t = turns(lambda: run_old_k4(g4, h4), lambda: solver.solve(g4, h4), reps=3)
        var = {}
        for name, k in k4_var.items():
            vx = swap(qp_kernel, "KERNEL_SHARED", k, lambda: mehrotra(G4, H4, g4, h4, K4_ITERS))
            var[name] = {"bit_equal_package": same(vx, (xk, ck, muk)),
                         "gates": gates(*vx, xp, cp, x64),
                         "ms": swap(qp_kernel, "KERNEL_SHARED", k, lambda: cs.graph_ms(
                             lambda: solver.solve(g4, h4), reps=3))}
        launch = getattr(qp_kernel, "shared_launch", None)
        lanes = blocks = smem = c_smem = resident = None
        if launch is not None:
            lanes, blocks, smem = launch(mI4, nz4, B, sms=sms)
            c_smem, resident = launch_shape(k4, "mehrotra", mI4, nz4, lanes)
        bd = cs.bound_ms(*cs.shared_qp_work(B, mI4, nz4, K4_ITERS))
        emit({"kernel": "K4", "mI": mI4, "nz": nz4, "iters": K4_ITERS, "B": B, "ms": t,
              "variants": var, "bound_ms": bd[0], "bound_by": bd[1],
              "package": gates(xk, ck, muk, xp, cp, x64),
              "parent": gates(xo, co, muo, xp, cp, x64),
              "lane0_alone_equals_batch": same((x1, c1, mu1), (xk[:1], ck[:1], muk[:1])),
              "lanes_a_block": lanes, "blocks": blocks, "smem": smem,
              "smem_matches_kernel": None if smem is None else c_smem == smem,
              "lanes_an_sm": resident})

    # ---- K4 against the earlier K4 by iteration count ----------------------------
    if args.k4_probe:
        B = K4_BATCHES[1]
        g4, h4 = g4_all[:B].contiguous(), h4_all[:B].contiguous()
        for it in (1, 2, 3, 4, 6, 8, 12, 16, 20):
            xk, ck, muk = mehrotra(G4, H4, g4, h4, it)
            xo, co, muo = run_old_k4(g4, h4, iters=it)
            torch.cuda.synchronize()
            lane_eq = (xk == xo).all(dim=1)
            emit({"probe": "K4", "B": B, "iters": it,
                  "lanes_x_bit_equal": int(lane_eq.sum()),
                  "lanes_mu_bit_equal": int((muk == muo).sum()),
                  "max_abs_dx": (xk - xo).abs().max().item(),
                  "median_abs_dx": (xk - xo).abs().median().item(),
                  "conv_package_only": int((ck & ~co).sum()),
                  "conv_parent_only": int((co & ~ck).sum())})

    # ---- K4's split by phase ---------------------------------------------------
    B = K4_BATCHES[0]
    g4, h4 = g4_all[:B].contiguous(), h4_all[:B].contiguous()
    builds = [("parent", old_clocked, lambda: run_old_k4(g4, h4, k=old_clocked))]
    if clocked is not None:
        builds.append(("package", clocked, lambda: swap(
            qp_kernel, "KERNEL_SHARED", clocked, lambda: mehrotra(G4, H4, g4, h4, K4_ITERS))))
    for tag, k, run in builds:
        run()
        split = k2w_split.read_split(k2w_split.reader(k), min(B, 16384), K4_ITERS)
        emit({"split": "K4", "build": tag, "B": B, "mI": mI4, "nz": nz4, "iters": K4_ITERS,
              "ms_clocked": cs.graph_ms(run, reps=3), **split})
    emit({"sm_clock": k2w_split.sm_clock()})

    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for c in lines:
                fh.write(json.dumps({**c, "card": card}) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
