#!/usr/bin/env python3
"""K4's function against the reference kernel, on the CPU.

The N=20 LMPC QP of chip_smoke.py's phase 15 (806 rows, nz 21; 8192 lanes,
dx0 from numpy seed 5; 20 iterations) is solved by the JAX package's
build_pallas_qp_solver in interpret mode (the TPU kernel's own code) and by
the port's plain version (ops/qp_kernel.mehrotra_plain) in float32 and in
float64. Prints one JSON line: each solver's converged share and lanes with
a NaN, and each port variant's agreement with the reference.

`--random` solves seeded random strictly feasible QPs instead, at mI in
{128, 806, 1024} x nz in {8, 21, 32} (the shapes of the random QPs first
tried for K4's GPU tests: G standard normal over sqrt(nz), h in [1, 2] so
x = 0 is inside, one H = diag in [1, 2] plus a small rank-one term, g
normal with deviation 0.7; numpy seed mI * 100 + nz), 256 lanes each by
default, float32, through the reference and the port's float32 plain
version, and prints each shape's NaN lanes and converged shares.

    JAX_PLATFORMS=cpu python tools/k4_reference.py
    JAX_PLATFORMS=cpu python tools/k4_reference.py --random [--batch 256]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def lmpc_inputs(lanes: int):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    lqp = chip_smoke.lmpc_qp()
    rng = np.random.default_rng(5)
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((lanes, 4))
    g = ((lqp.Gg @ dxs.T).T + lqp.g0).astype(np.float32)
    h = (lqp.h0 + (lqp.Hp @ dxs.T).T).astype(np.float32)
    return np.asarray(lqp.G, np.float32), np.asarray(lqp.H, np.float32), g, h


RANDOM_SHAPES = [(mI, nz) for mI in (128, 806, 1024) for nz in (8, 21, 32)]


def random_inputs(mI: int, nz: int, lanes: int):
    """A strictly feasible random shared-H QP batch (float32)."""
    rng = np.random.default_rng(mI * 100 + nz)
    u = rng.standard_normal((nz, 1)) / np.sqrt(nz)
    H = np.eye(nz) * rng.uniform(1.0, 2.0, (nz, 1)) + 0.1 * u @ u.T
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.standard_normal((mI, nz)) / np.sqrt(nz)), f(H),
            f(0.7 * rng.standard_normal((lanes, nz))), f(rng.uniform(1.0, 2.0, (lanes, mI))))


def reference(G, H, g, h, iters: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from lbmpc_tpu.ops.pallas_ipm import build_pallas_qp_solver

    x, conv = build_pallas_qp_solver(H, G, iters=iters, tile=128, interpret=True)(
        jnp.asarray(g), jnp.asarray(h))
    return np.asarray(x), np.asarray(conv)


def port_plain(G, H, g, h, iters: int, dtype, chunk: int = 2048):
    import torch

    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_plain

    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)
    xs, cs = [], []
    for i in range(0, g.shape[0], chunk):
        x, c, _ = mehrotra_plain(t(G), t(H), t(g[i:i + chunk]), t(h[i:i + chunk]), iters)
        xs.append(x.numpy())
        cs.append(c.numpy())
    return np.concatenate(xs), np.concatenate(cs)


def summary(x, conv, x_ref=None, conv_ref=None) -> dict:
    nan = np.isnan(x).any(axis=1)
    out = {"conv": float(conv.mean()), "nan_lanes": np.nonzero(nan)[0].tolist()}
    if x_ref is not None:
        fin = ~(nan | np.isnan(x_ref).any(axis=1))
        dl = np.abs(x - x_ref).max(axis=1)
        both = conv & conv_ref
        out.update(conv_agree=float((conv == conv_ref).mean()),
                   median_abs_dx=float(np.median(np.abs(x - x_ref)[fin])),
                   lanes_beyond_5e_2=int((dl[fin] > 5e-2).sum()),
                   max_abs_dx_both_converged=float(dl[both].max()) if both.any() else 0.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192, help="lanes (a multiple of 128)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--random", action="store_true",
                    help="seeded random QPs at mI x nz in {128, 806, 1024} x {8, 21, 32}")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if args.random:
        lanes = args.batch if args.batch != 8192 else 256
        rows = []
        for mI, nz in RANDOM_SHAPES:
            G, H, g, h = random_inputs(mI, nz, lanes)
            x_ref, c_ref = reference(G, H, g, h, args.iters)
            x32, c32 = port_plain(G, H, g, h, args.iters, torch.float32)
            x64, c64 = port_plain(G, H, g, h, args.iters, torch.float64)
            row = {"mI": mI, "nz": nz, "lanes": lanes, "iters": args.iters,
                   "reference_interpret": summary(x_ref, c_ref),
                   "port_plain_float32": summary(x32, c32, x_ref, c_ref),
                   "port_plain_float64": summary(x64, c64, x_ref, c_ref)}
            print(json.dumps(row), file=sys.stderr, flush=True)
            rows.append(row)
        print(json.dumps({"random": rows}))
        return 0

    G, H, g, h = lmpc_inputs(args.batch)
    x_ref, c_ref = reference(G, H, g, h, args.iters)
    x32, c32 = port_plain(G, H, g, h, args.iters, torch.float32)
    x64, c64 = port_plain(G, H, g, h, args.iters, torch.float64)
    res = {"lanes": args.batch, "G": list(G.shape), "iters": args.iters,
           "reference_interpret": summary(x_ref, c_ref),
           "port_plain_float32": summary(x32, c32, x_ref, c_ref),
           "port_plain_float64": summary(x64, c64, x_ref, c_ref)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
