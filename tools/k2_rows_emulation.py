#!/usr/bin/env python3
"""Why K2 and K3 part from the block loop they replaced above mI = 256,
emulated on the CPU in float32.

csrc/mehrotra_warp.cuh (K2, K3: a warp a lane) writes out every sum of the
Mehrotra iteration in the order of the one-block-a-lane loop it replaced
(mehrotra_body.cuh's `solve` up to commit c22a8d5, 256 threads, thread t
holding rows t + 256 k): G'v (eight row partials, added in order), the
assembly (each entry's rows in order), and mu and mu_aff (a thread's rows,
a butterfly over each warp's 32 lanes, then over the 8 warp totals). The
kernels equal that loop bit for bit at mI <= 256, where a thread of it held
one row, and part on a few lanes above.

This emulates, for each of those sums, the block loop's order and rounding
and the warp loop's, exactly in float32 (products and sums rounded to
nearest even, an FMA rounded once), on the states (s, z, d, the KKT's t) of
the plain version's float32 Mehrotra iterations (ops/qp_kernel
.mehrotra_h_plain) at two shapes: the bench QP's 214 rows and the N=20 LMPC
QP's 806 rows with a per-lane SPD H (tools/k2_compare.py's mI = 806 case).
For each sum and iteration it prints how many lanes the two orders give
other bits. The block loop's thread added the rounded product s z to its
running sum for mu (the product also fed the KKT's right-hand side, so nvcc
did not fuse it: NVPTX fuses a product into an add only when its other uses
are adds too); the warp loop takes one FMA a row (__fmaf_rn(s, z, p)). With
one row a thread the sum starts at 0, and fma(s, z, 0) = 0 + round(s z):
the orders agree. With several they do not.

    python3 tools/k2_rows_emulation.py [--lanes 512] [--iters 8]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
THREADS, WARPS = 256, 8


def fma32(a, b, c):
    """round32(a b + c) with one rounding: a b is exact in float64, the sum's
    rounding error comes from a two-sum, and a float64 sum that lands on a
    float32 midpoint is moved off it by the error's sign."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    # a tie of the float64 sum between two float32 neighbours: the exact
    # value lies on the side of err
    lo = np.nextafter(r, np.float32(-np.inf)).astype(np.float64)
    hi = np.nextafter(r, np.float32(np.inf)).astype(np.float64)
    rr = r.astype(np.float64)
    tie_up = (s - rr == (hi - rr) / 2)
    tie_dn = (rr - s == (rr - lo) / 2)
    r = np.where(tie_up & (err > 0), hi.astype(np.float32), r)
    r = np.where(tie_dn & (err < 0), lo.astype(np.float32), r)
    return r.astype(np.float32)


def check_fma32(rng, n: int = 4000) -> int:
    """fma32 against exact rational arithmetic on seeded float32 triples,
    products and addends of every relative size; the count that differ."""
    from fractions import Fraction

    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * 10.0 ** rng.integers(-12, 12, n)).astype(np.float32)
    got = fma32(a, b, c)
    bad = 0
    for i in range(n):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = (np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf)))
        errs = [abs(Fraction(float(v)) - exact) for v in cands]
        best = min(errs)
        ok = [v for v, e in zip(cands, errs) if e == best]
        want = (ok[0] if len(ok) == 1
                else [v for v in ok if not (v.view(np.int32) & 1)][0])
        bad += int(got[i] != want)
    return bad


def add32(a, b):
    return (np.asarray(a, np.float32) + np.asarray(b, np.float32)).astype(np.float32)


def mul32(a, b):
    return (np.asarray(a, np.float32) * np.asarray(b, np.float32)).astype(np.float32)


def block_order(rows_fn, mI: int, lanes: int):
    """The block loop's sum over rows: thread t's running value over rows
    t + 256 k (rows_fn(p, r) -> the new running value), a butterfly over each
    warp's 32 lanes, then warp 0's butterfly over the 8 totals (zeros above
    lane 8). (lanes,) float32."""
    part = np.zeros((lanes, THREADS), np.float32)
    for k in range(0, mI, THREADS):
        r = np.arange(k, min(k + THREADS, mI))
        part[:, : r.size] = rows_fn(part[:, : r.size], r)
    w = part.reshape(lanes, WARPS, 32)
    for off in (16, 8, 4, 2, 1):
        w = add32(w, w[..., np.arange(32) ^ off])
    tot = np.zeros((lanes, 32), np.float32)
    tot[:, :WARPS] = w[..., 0]
    for off in (16, 8, 4, 2, 1):
        tot = add32(tot, tot[:, np.arange(32) ^ off])
    return tot[:, 0]


def states(G, H, g, h, iters: int):
    """The plain version's float32 iterates (s, z) after 0..iters-1 cold
    iterations."""
    import torch

    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h_plain

    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    out = []
    for it in range(iters):
        _, _, (s, z) = mehrotra_h_plain(t(G), t(H), t(g), t(h), it)
        s, z = s.numpy(), z.numpy()
        out.append((s, z))
    return out


def shapes(lanes: int, rng):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    cfg = lt.make_preset("LBMPC_N40")
    import dataclasses

    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=cs.N),
                              oracle=dataclasses.replace(cfg.oracle, q=cs.Q))
    out = {}
    for name, qp in (("bench", build_scenario(cfg).qp), ("LMPC", cs.lmpc_qp())):
        dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((lanes, 4))
        H0 = np.asarray(qp.H, np.float64) if qp.H is not None else np.eye(qp.G.shape[1])
        bump = rng.uniform(0.0, 0.1, (lanes, H0.shape[0])) * float(np.mean(np.diag(H0)))
        H = (H0[None] + bump[:, :, None] * np.eye(H0.shape[0])[None]).astype(np.float32)
        g = ((qp.Gg @ dxs.T).T + qp.g0).astype(np.float32)
        h = (qp.h0 + (qp.Hp @ dxs.T).T).astype(np.float32)
        out[name] = (np.asarray(qp.G, np.float32), H, g, h)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=512)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(5)
    print(f"fma32 against exact arithmetic: {check_fma32(rng)} of 4000 differ", flush=True)
    for name, (G, H, g, h) in shapes(args.lanes, rng).items():
        mI = G.shape[0]
        print(f"{name} QP: mI={mI}, nz={G.shape[1]}, {args.lanes} lanes; lanes whose bits "
              "part between the block loop's order and the warp loop's, by iteration",
              flush=True)
        for it, (s, z) in enumerate(states(G, H, g, h, args.iters)):
            inv = np.float32(1.0) / np.float32(mI)
            mu_block = mul32(block_order(lambda p, r: add32(p, mul32(s[:, r], z[:, r])),
                                         mI, args.lanes), inv)
            mu_warp = mul32(block_order(lambda p, r: fma32(s[:, r], z[:, r], p),
                                        mI, args.lanes), inv)
            ulps = np.abs(mu_block.view(np.int32).astype(np.int64)
                          - mu_warp.view(np.int32).astype(np.int64))
            print(f"  iteration {it}: the predictor's mu parts on "
                  f"{int((mu_block != mu_warp).sum())} lanes (max {int(ulps.max())} ulp)",
                  flush=True)
    print("The other sums over rows take one FMA a row in both loops (G'z, G't, the "
          "assembly, mu_aff and the returned mu: in the block loop each product had one use, "
          "so nvcc fused it), so their orders agree at every mI; only the predictor's mu "
          "rounds its product apart in the block loop.", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
