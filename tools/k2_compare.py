#!/usr/bin/env python3
"""K2, K3 and K4 against an earlier tree's, in one session on the card.

Builds K2 (mehrotra_h.cu), K3 (gn_mehrotra.cu) and K4 (mehrotra.cu) from an
earlier tree's lbmpc_tpu_torch/csrc (--parent DIR: an unpacked
`git archive <commit>`), whose K2 and K3 run one lane a block with the
C interface that had no lane count, beside the package's. On the bench QP
(LBMPC_N40 cut to N=20, q=100: nz=21, G (214, 21), H and g from K1 on
chip_smoke.py's seeded inputs, h in step_rhs's order) and on the N=20 LMPC
QP (G (806, 21), a per-lane SPD H) it prints, per case:
- both builds' times with CUDA events, in turns (parent, package, package,
  parent), at B=2048, 8192 and the repair's 24: K2 at 8 iterations cold and
  2 warm from the 8's state, K3 at 16 and 8; K2 at mI=806 at B=8192, 8 it;
- whether the package's x, mu (and s, z) equal the parent's bit for bit, and
  otherwise their distance;
- at 16 iterations on the bench QP (B=2048): the share of lanes that stall
  (mu >= 1e-6) for the package's K2, the parent's, the plain version and the
  plain version in float64, and the median distance of each float32 solve
  from the float64 one;
- K3 against K1 then K2 (bit for bit) and against its plain version;
- K4 on chip_smoke.py phase 15's inputs (8192 lanes, 20 iterations): the
  package's x, conv and mu against the parent's, bit for bit;
- the registers and spills of every build (ptxas) and the lanes one SM
  holds.
--k3-min-blocks N,M also builds K3 with -DK3_MIN_BLOCKS=N (its launch
bounds' blocks an SM) for each value and times them beside the package's.
Needs one card.

    python3 tools/k2_compare.py --parent DIR [--k3-min-blocks 1,2] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))


def parent_kernels(csrc: pathlib.Path) -> dict:
    """The earlier tree's K2, K3 and K4 (one lane a block, no lane count in
    the interface)."""
    from lbmpc_tpu_torch.ops import _cuda, mono_kernel, qp_kernel

    P_, I_, F_ = _cuda.P, _cuda.I, _cuda.F
    out = {}
    for key, k, args in (("k2", qp_kernel.KERNEL, [P_] * 10 + [I_] * 4 + [F_] * 3 + [P_]),
                         ("k3", mono_kernel.KERNEL, [P_] * 13 + [I_] * 5 + [F_] * 2 + [P_]),
                         ("k4", qp_kernel.KERNEL_SHARED, qp_kernel.KERNEL_SHARED.argtypes)):
        c = _cuda.CudaKernel(k.name, args, flags=k.flags)
        c.source = csrc / k.source.name
        out[key] = c
    return out


def run_k2_parent(kernel, dev, G, H, g, h, it: int, warm=None):
    """One solve on the earlier tree's K2 (its interface: no lane count);
    returns (x, mu, (s, z))."""
    import torch

    from lbmpc_tpu_torch.ops import _cuda

    B, n = g.shape
    m = G.shape[0]
    x = torch.empty(B, n, device=dev)
    mu = torch.empty(B, device=dev)
    st = (torch.empty(B, m, device=dev), torch.empty(B, m, device=dev))
    p, null = _cuda.ptr, _cuda.P(None)
    kernel.launch(dev, p(G), p(H), p(g), p(h), p(warm[0]) if warm else null,
                  p(warm[1]) if warm else null, p(x), p(mu), p(st[0]), p(st[1]),
                  _cuda.I(B), _cuda.I(m), _cuda.I(n), _cuda.I(it), _cuda.F(0.995),
                  _cuda.F(1e6), _cuda.F(1e-5))
    return x, mu, st


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="an earlier tree (holding lbmpc_tpu_torch/csrc)")
    ap.add_argument("--k3-min-blocks", default="", help="comma-separated K3_MIN_BLOCKS builds")
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import k2_split
    from lbmpc_tpu_torch.ops import _cuda, mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import (QPSolver, mehrotra, mehrotra_h,
                                               mehrotra_h_plain, step_rhs)

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    parent = parent_kernels(pathlib.Path(args.parent) / "lbmpc_tpu_torch" / "csrc")
    package = {"k2": qp_kernel.KERNEL, "k3": mono_kernel.KERNEL, "k4": qp_kernel.KERNEL_SHARED}
    variants = {}
    for n in [int(v) for v in args.k3_min_blocks.split(",") if v]:
        k = mono_kernel.KERNEL
        variants[n] = _cuda.CudaKernel(k.name, k.argtypes, flags=k.flags + (f"-DK3_MIN_BLOCKS={n}",))
    logs = _cuda.build_all([*package.values(), *parent.values(), *variants.values()],
                           verbose=True)
    for name, text in logs.items():
        print(f"ptxas {name}: {k2_split.ptxas_summary(text)}", flush=True)
    lines = []

    def emit(case: dict) -> None:
        lines.append(case)
        print(json.dumps(case), flush=True)

    big = k2_split.bench_qp(dev, 8192)
    G, h0, Hp = big["G"], big["h0"], big["Hp"]
    mI, nz = G.shape
    q = k2_split.Q
    for key in ("k2", "k3"):
        qk = q if key == "k3" else 0
        emit({"resident_lanes_per_sm": key.upper(), "mI": mI, "nz": nz, "B": 8192,
              "package": k2_split.resident_lanes_at(package[key], mI, nz, qk, 8192),
              "parent": k2_split.resident_lanes(parent[key], mI, nz, qk)})

    def cut(B):
        z, dx, win = big["ins"]
        idx = torch.arange(B, device=dev)
        return (big["H"][:B].contiguous(), big["g"][:B].contiguous(),
                big["h"][:B].contiguous(), (z[:B].contiguous(), dx[:B].contiguous(),
                                             win.index(idx)))

    def swap(mod, attr, k, fn):
        saved = getattr(mod, attr)
        setattr(mod, attr, k)
        try:
            return fn()
        finally:
            setattr(mod, attr, saved)

    def run_parent_k2(G_, H, g, h, it, warm=None):
        return run_k2_parent(parent["k2"], dev, G_, H, g, h, it, warm)

    def run_parent_k3(mono, ins):
        # the earlier interface: the same arguments without the lane count
        z, dx, win = ins
        gn = mono.gn
        B = z.shape[0]
        f32 = dict(dtype=torch.float32, device=dev)
        e = torch.empty(B, gn.ne, **f32)
        d = torch.empty(B, gn.nz, **f32)
        mu = torch.empty(B, **f32)
        g = torch.empty(B, gn.nz, **f32)
        p = _cuda.ptr
        parent["k3"].launch(dev, p(gn.cst), p(z), p(dx), p(win.X), p(win.Y), p(win.valid),
                            p(mono.G), p(mono.h0), p(mono.Hp), p(e), p(d), p(mu), p(g),
                            _cuda.I(B), _cuda.I(gn.N), _cuda.I(win.X.shape[-2]),
                            _cuda.I(mono.G.shape[0]), _cuda.I(mono.iters), _cuda.F(mono.tau),
                            _cuda.F(mono.d_cap))
        return e, d, mu, g

    def same(a, b) -> bool:
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    def dist(a, b) -> float:
        d = (a - b).abs()
        d = d[d.isfinite()]
        return float(d.max()) if d.numel() else 0.0

    # ---- K2 and K3 at the bench shape: bits and times ----------------------
    for B in (2048, 8192, cs.REPAIR_K):
        H, g, h, ins = cut(B)
        new8 = mehrotra_h(G, H, g, h, 8, want_state=True)
        old8 = run_parent_k2(G, H, g, h, 8)
        new2 = mehrotra_h(G, H, g, h, 2, warm=new8[2], want_state=True)
        old2 = run_parent_k2(G, H, g, h, 2, warm=new8[2])
        torch.cuda.synchronize()
        t = {}
        for tag, fn in (("parent", lambda: run_parent_k2(G, H, g, h, 8)),
                        ("package", lambda: mehrotra_h(G, H, g, h, 8, want_state=True)),
                        ("package2", lambda: mehrotra_h(G, H, g, h, 8, want_state=True)),
                        ("parent2", lambda: run_parent_k2(G, H, g, h, 8))):
            t[tag] = cs.cuda_ms(fn, reps=10)
        tw = {}
        for tag, fn in (("parent", lambda: run_parent_k2(G, H, g, h, 2, warm=new8[2])),
                        ("package", lambda: mehrotra_h(G, H, g, h, 2, warm=new8[2])),
                        ("package2", lambda: mehrotra_h(G, H, g, h, 2, warm=new8[2])),
                        ("parent2", lambda: run_parent_k2(G, H, g, h, 2, warm=new8[2]))):
            tw[tag] = cs.cuda_ms(fn, reps=10)
        xp, mup, _ = mehrotra_h_plain(G, H, g, h, 8)
        dd = (new8[0] - xp).abs()
        emit({"kernel": "K2", "B": B, "iters": 8, "ms": t, "ms_2_warm": tw,
              "bit_equal_parent_8": same((new8[0], new8[1], *new8[2]), (old8[0], old8[1], *old8[2])),
              "max_dx_parent_8": dist(new8[0], old8[0]),
              "bit_equal_parent_2": same((new2[0], new2[1]), (old2[0], old2[1])),
              "nan_lanes_2": [int(new2[1].isnan().sum()), int(old2[1].isnan().sum())],
              "max_dx_parent_2": dist(new2[0], old2[0]),
              "vs_plain_8": {"median": float(dd.median()), "max": float(dd.max()),
                             "dmu": float((new8[1] - mup).abs().max())}})
        for it in (16, 8):
            mono = MonoPhase(big["gn"], G, h0, Hp, it)
            e, d, mu, gk = mono(*ins)
            eo, do, muo, go = run_parent_k3(mono, ins)
            e1, H1, g1 = big["gn"](*ins)
            x2, mu2, _ = mehrotra_h(G, H1, g1, step_rhs(h0, Hp, G, ins[1], ins[0]), it)
            torch.cuda.synchronize()
            tk = {}
            for tag, fn in (("parent", lambda: run_parent_k3(mono, ins)),
                            ("package", lambda: mono(*ins)), ("package2", lambda: mono(*ins)),
                            ("parent2", lambda: run_parent_k3(mono, ins))):
                tk[tag] = cs.cuda_ms(fn, reps=5)
            for n, k in variants.items():
                tk[f"min_blocks_{n}"] = swap(mono_kernel, "KERNEL", k,
                                             lambda: cs.cuda_ms(lambda: mono(*ins), reps=5))
            emit({"kernel": "K3", "B": B, "iters": it, "ms": tk,
                  "bit_equal_parent": same((e, d, mu, gk), (eo, do, muo, go)),
                  "max_dd_parent": dist(d, do),
                  "equals_k1_then_k2": same((e, gk, d, mu), (e1, g1, x2, mu2))})

    # ---- stall shares at 16 iterations, B=2048 -------------------------------
    H, g, h, _ = cut(2048)
    xk, muk, _ = mehrotra_h(G, H, g, h, 16)
    xo, muo, _ = run_parent_k2(G, H, g, h, 16)
    xp, mup, _ = mehrotra_h_plain(G, H, g, h, 16)
    x64, mu64, _ = mehrotra_h_plain(G.double(), H.double(), g.double(), h.double(), 16)
    stall = lambda m: float((~(m < 1e-6)).float().mean())
    med = lambda x: float((x.double() - x64).abs().median())
    emit({"stall_share_16": {"package": stall(muk), "parent": stall(muo), "plain": stall(mup),
                             "float64": stall(mu64)},
          "median_from_float64_16": {"package": med(xk), "parent": med(xo), "plain": med(xp)},
          "bit_equal_parent_16": same((xk, muk), (xo, muo))})

    # ---- K2 at mI=806: the LMPC G with a per-lane SPD H ----------------------
    lqp = cs.lmpc_qp()
    rng = np.random.default_rng(5)
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((8192, 4))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev).contiguous()
    Gl = f(lqp.G)
    gl, hl = f((lqp.Gg @ dxs.T).T + lqp.g0), f(lqp.h0 + (lqp.Hp @ dxs.T).T)
    Hl = np.asarray(lqp.H, np.float64)
    bump = rng.uniform(0.0, 0.1, (8192, Hl.shape[0])) * float(np.mean(np.diag(Hl)))
    Hb = f(Hl[None] + bump[:, :, None] * np.eye(Hl.shape[0])[None])
    new = mehrotra_h(Gl, Hb, gl, hl, 8, want_state=True)
    old = run_parent_k2(Gl, Hb, gl, hl, 8)
    tl = {}
    for tag, fn in (("parent", lambda: run_parent_k2(Gl, Hb, gl, hl, 8)),
                    ("package", lambda: mehrotra_h(Gl, Hb, gl, hl, 8, want_state=True)),
                    ("package2", lambda: mehrotra_h(Gl, Hb, gl, hl, 8, want_state=True)),
                    ("parent2", lambda: run_parent_k2(Gl, Hb, gl, hl, 8))):
        tl[tag] = cs.cuda_ms(fn, reps=3)
    xpl, mupl, _ = mehrotra_h_plain(Gl, Hb, gl, hl, 8)
    emit({"kernel": "K2", "case": "LMPC mI=806 per-lane H", "B": 8192, "iters": 8, "ms": tl,
          "bit_equal_parent": same((new[0], new[1], *new[2]), (old[0], old[1], *old[2])),
          "max_dx_parent": dist(new[0], old[0]),
          "vs_plain": {"median": float((new[0] - xpl).abs().median()),
                       "max": float((new[0] - xpl).abs().max())},
          "resident_lanes_per_sm": k2_split.resident_lanes_at(package["k2"], 806, nz, 0, 8192)})

    # ---- K4: the parent's bits on phase 15's inputs --------------------------
    k4 = QPSolver(lqp.H, lqp.G, iters=20, device=dev)
    x4, c4, m4 = mehrotra(k4.G, k4.H, gl, hl, 20)
    x4o, c4o, m4o = swap(qp_kernel, "KERNEL_SHARED", parent["k4"],
                         lambda: mehrotra(k4.G, k4.H, gl, hl, 20))
    torch.cuda.synchronize()
    emit({"kernel": "K4", "B": 8192, "bit_equal_parent": same((x4, c4, m4), (x4o, c4o, m4o))})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for c in lines:
                fh.write(json.dumps({**c, "card": card}) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
