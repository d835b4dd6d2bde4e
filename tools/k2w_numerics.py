#!/usr/bin/env python3
"""K2w's float32 results against its plain version and the float64 solve,
under the package's build and under variants of its summation order, and
against an earlier tree's K2w, on the card.

The QPs are chip_smoke.py phase 20's: the DMS flagship's (casadi, nz=101,
G (1024, 101), B=1024) and the uncut LBMPC_N40's (nz=41, G (414, 41),
B=8192), H and g from K1w on seeded inputs; 8 and 16 cold iterations and 2
warm from the 8's state. For each build it prints, per case, what
chip_smoke.f64_gates holds (the median distance from the float64 solve,
the share of lanes beyond 5e-2 of it, the share of lanes that stall with
mu >= 1e-6) beside the plain version's and the float64 solve's own stalled
share, and the kernel's time with CUDA events.

Builds: "package" (csrc/ as it is) and "back_sweep_ascending" (a copy of
csrc/ whose triangular back sweep adds a block's columns in ascending
order, where chol::solve's column sweep, and the package, take the later
columns first). With --parent DIR, DIR holds an earlier tree's
lbmpc_tpu_torch/csrc (e.g. `git archive <commit> lbmpc_tpu_torch/csrc |
tar -x -C DIR`) whose mehrotra_h_wide.cu takes G itself (the dense
version's interface); the script builds it too and reports whether the
package's x, mu, s and z equal it bit for bit. Needs one card.

    python3 tools/k2w_numerics.py [--parent DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import shutil
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = {
    "back_sweep_ascending": [(
        "for (int j = nb - 1; j >= 0; --j) b = chol::sub_prod(b, A[(c0 + j) * n + i], v[c0 + j]);",
        "for (int j = 0; j < nb; ++j) b = chol::sub_prod(b, A[(c0 + j) * n + i], v[c0 + j]);")],
}


def variant_kernel(name: str, csrc: pathlib.Path, subs, argtypes):
    """A K2w CudaKernel built from a copy of `csrc` (in build/k2w_numerics/
    name) with the text substitutions `subs` applied to mehrotra_wide.cuh."""
    d = ROOT / "build" / "k2w_numerics" / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    head = d / "mehrotra_wide.cuh"
    text = head.read_text()
    for a, b in subs:
        if a not in text:
            raise ValueError(f"variant {name}: {a!r} not found")
        text = text.replace(a, b)
    head.write_text(text)
    return kernel_from(d / "mehrotra_h_wide.cu", argtypes)


def kernel_from(path: pathlib.Path, argtypes):
    """K2w's CudaKernel (the package's flags) built from the source `path`
    and the headers beside it."""
    from lbmpc_tpu_torch.ops import _cuda, qp_kernel

    k = _cuda.CudaKernel("mehrotra_h_wide", argtypes, flags=qp_kernel.KERNEL_WIDE.flags)
    k.source = path
    return k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="an earlier tree holding lbmpc_tpu_torch/csrc")
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2w_numerics: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops import _cuda, qp_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.qp_kernel import WidePlan, mehrotra_h, mehrotra_h_plain, step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    P_, I_, F_ = _cuda.P, _cuda.I, _cuda.F
    kernels = {"package": qp_kernel.KERNEL_WIDE}
    for name, subs in VARIANTS.items():
        kernels[name] = variant_kernel(name, _cuda.CSRC, subs, qp_kernel.KERNEL_WIDE.argtypes)
    parent = None
    if args.parent:
        parent = kernel_from(pathlib.Path(args.parent) / "lbmpc_tpu_torch" / "csrc"
                              / "mehrotra_h_wide.cu", [P_] * 10 + [I_] * 4 + [F_] * 3 + [P_])
    logs = _cuda.build_all(list(kernels.values()) + ([parent] if parent else []), verbose=True)
    for name, text in logs.items():
        print(f"ptxas {name}: " + "; ".join(ln.strip() for ln in text.splitlines()
                                            if "spill" in ln), flush=True)

    def run_parent(G, H, g, h, it, warm=None):
        B, nz = g.shape
        mI = G.shape[0]
        x = torch.empty(B, nz, device=dev)
        mu = torch.empty(B, device=dev)
        st = (torch.empty(B, mI, device=dev), torch.empty(B, mI, device=dev))
        p = _cuda.ptr
        parent.launch(dev, p(G), p(H), p(g), p(h), p(warm[0]) if warm else P_(None),
                      p(warm[1]) if warm else P_(None), p(x), p(mu), p(st[0]), p(st[1]),
                      I_(B), I_(mI), I_(nz), I_(it), F_(0.995), F_(1e6), F_(1e-5))
        return x, mu, st

    def runner(k):
        def run(G, H, g, h, it, plan, warm=None):
            qp_kernel.KERNEL_WIDE = k
            try:
                return mehrotra_h(G, H, g, h, it, warm=warm, want_state=True, plan=plan)
            finally:
                qp_kernel.KERNEL_WIDE = kernels["package"]
        return run

    # phase 20's QPs
    qps = {}
    rng = np.random.default_rng(3)
    for name, B in (("DMS_LBMPC_q100", cs.DMS_BATCH), ("LBMPC_N40", cs.COHORT)):
        c = lt.make_preset(name)
        c = dataclasses.replace(c, solver=dataclasses.replace(c.solver, sqp_iters=2,
                                                              dtype="float32"))
        s = build_scenario(c)
        if c.family == "casadi":
            _, win, _ = cs.bench_inputs(rng, B, s.nz, dev)
            x0 = np.asarray(c.x_init_abs) - np.asarray(c.plant.x_wp)
            dx = f(x0 + 0.01 * rng.standard_normal((B, 4)))
        else:
            dx, win, _ = cs.bench_inputs(np.random.default_rng(6), B, s.nz, dev)
        z = torch.zeros(B, s.nz, device=dev)
        gn = GNPhase(s.qp, s.A, s.B, s.ocp.Ks, s.w, device=dev, family=c.family,
                     delta=c.plant.ts, bandwidth=c.oracle.bandwidth, ridge=c.oracle.ridge,
                     dx_ref=np.asarray(c.dx_ref))
        _, H, g = gn(z, dx, win)
        G = f(s.qp.G)
        qps[c.family] = (G, H, g, step_rhs(f(s.qp.h0), f(s.qp.Hp), G, dx, z), WidePlan(G))

    def gates(x, mu, xp, mup, x64, mu64) -> dict:
        ek, ep = ((a.double() - x64).abs() for a in (x, xp))
        return dict(median=ek.median().item(), median_plain=ep.median().item(),
                    far=(ek.amax(dim=1) > 5e-2).float().mean().item(),
                    far_plain=(ep.amax(dim=1) > 5e-2).float().mean().item(),
                    stalled=(~(mu < 1e-6)).float().mean().item(),
                    stalled_plain=(~(mup < 1e-6)).float().mean().item(),
                    stalled_f64=(~(mu64 < 1e-6)).float().mean().item())

    lines = []
    for fam, it in (("casadi", 8), ("casadi", 16), ("fmincon", 8), ("fmincon", 16)):
        G, H, g, h, plan = qps[fam]
        xp, mup, _ = mehrotra_h_plain(G, H, g, h, it)
        x64, mu64, _ = mehrotra_h_plain(G.double(), H.double(), g.double(), h.double(), it)
        ref = parent and run_parent(G, H, g, h, it)
        for name, k in kernels.items():
            run = runner(k)
            x, mu, st = run(G, H, g, h, it, plan)
            torch.cuda.synchronize()
            line = dict(kernel=name, family=fam, iters=it, **gates(x, mu, xp, mup, x64, mu64),
                        ms=cs.cuda_ms(lambda: run(G, H, g, h, it, plan), reps=3))
            if ref:
                line["equal_to_parent"] = all(torch.equal(a, b) for a, b in
                                              zip((x, mu, *st), (ref[0], ref[1], *ref[2])))
            if it == 8:  # 2 iterations warm from this build's state
                xw, muw, _ = run(G, H, g, h, 2, plan, warm=st)
                xwp, muwp, _ = mehrotra_h_plain(G, H, g, h, 2, warm=st)
                xw64, muw64, _ = mehrotra_h_plain(G.double(), H.double(), g.double(),
                                                  h.double(), 2,
                                                  warm=tuple(a.double() for a in st))
                line["warm2"] = gates(xw, muw, xwp, muwp, xw64, muw64)
                line["warm2_ms"] = cs.cuda_ms(lambda: run(G, H, g, h, 2, plan, warm=st),
                                              reps=5)
            lines.append(line)
            print(json.dumps(line), flush=True)
        if ref:
            line = dict(kernel="parent", family=fam, iters=it,
                        **gates(ref[0], ref[1], xp, mup, x64, mu64),
                        ms=cs.cuda_ms(lambda: run_parent(G, H, g, h, it), reps=3))
            lines.append(line)
            print(json.dumps(line), flush=True)
    print(f"{'build':<22}{'case':<14}{'median / plain':>22}{'far / plain':>16}"
          f"{'stalled / plain / f64':>24}{'ms':>10}  equal to parent", flush=True)
    for ln in lines:
        print(f"{ln['kernel']:<22}{ln['family'] + ' ' + str(ln['iters']):<14}"
              f"{ln['median']:>11.3e} {ln['median_plain']:.3e}"
              f"{ln['far']:>8.4f} {ln['far_plain']:.4f}"
              f"{ln['stalled']:>8.4f} {ln['stalled_plain']:.4f} {ln['stalled_f64']:.4f}"
              f"{ln['ms']:>10.3f}  {ln.get('equal_to_parent', '')} {card}", flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for ln in lines:
                fh.write(json.dumps({**ln, "card": card}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
