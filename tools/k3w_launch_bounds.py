#!/usr/bin/env python3
"""K3w (csrc/gn_mehrotra_wide.cu) against K1w -> step_rhs -> K2w, on the card,
under several builds.

Each variant builds K1w (gn_wide.cu), K2w (mehrotra_h_wide.cu) and K3w with
nvcc for sm_90a under the package's flags plus the variant's own: "package"
(the wide kernels' flags as the package builds them: -fmad=false, K3w at
two blocks an SM), "minblocks1" (K3w at one 256-thread block an SM,
-DK3W_MIN_BLOCKS=1) and "fmad_on" (without -fmad=false: nvcc and ptxas
contract multiplies and adds into FMAs where they choose). It prints ptxas'
registers and spills, and at the uncut LBMPC_N40 shape (N=40, q=100, nz=41,
G (414, 41), seeded random inputs) which of K3w's outputs (e, g, d, mu)
differ from the two-launch composition, on how many lanes and by how much,
at 0, 1, 8 and 16 Mehrotra iterations, and the kernels' times with CUDA
events. Prints one JSON line a variant; needs one card.

    python3 tools/k3w_launch_bounds.py [--batch 8192] [--variants package,minblocks1]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
VARIANTS = ("package", "minblocks1", "fmad_on")


def variant_flags(name: str) -> tuple:
    """The wide kernels' nvcc flags beyond the common ones, by variant."""
    from lbmpc_tpu_torch.ops._cuda import WIDE_FLAGS

    return {"package": WIDE_FLAGS, "minblocks1": WIDE_FLAGS + ("-DK3W_MIN_BLOCKS=1",),
            "fmad_on": ()}[name]


def build_variant(extra: tuple) -> dict:
    """Fresh K1w, K2w and K3w objects built and loaded with `extra` beyond
    the package's common flags."""
    from lbmpc_tpu_torch.ops import _cuda, gn_kernel, mono_kernel, qp_kernel

    ks = {m: _cuda.CudaKernel(k.name, k.argtypes, flags=extra)
          for m, k in ((gn_kernel, gn_kernel.KERNEL_WIDE),
                       (qp_kernel, qp_kernel.KERNEL_WIDE),
                       (mono_kernel, mono_kernel.KERNEL_WIDE))}
    logs = _cuda.build_all(ks.values(), verbose=True)
    for k in ks.values():
        k.fn()
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln] for name, text in logs.items()}
    return {"kernels": ks, "ptxas": ptxas, "flags": list(extra)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k3w_launch_bounds: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops import gn_kernel, mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h, step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, dtype="float32"))
    sc = build_scenario(cfg)
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, delta=cfg.plant.ts,
                 bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                 dx_ref=np.asarray(cfg.dx_ref), device=dev)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    G, h0, Hp = f(sc.qp.G), f(sc.qp.h0), f(sc.qp.Hp)
    dx, win, z = chip_smoke.bench_inputs(np.random.default_rng(0), args.batch, sc.nz, dev)
    h = step_rhs(h0, Hp, G, dx, z)
    for name in args.variants.split(","):
        v = build_variant(variant_flags(name))
        for m, k in v["kernels"].items():
            if m is gn_kernel:
                gn_kernel.KERNEL_WIDE = k
            elif m is qp_kernel:
                qp_kernel.KERNEL_WIDE = k
            else:
                mono_kernel.KERNEL_WIDE = k
        res = {"flags": v["flags"], "ptxas": v["ptxas"]}
        eh, H, gh = gn(z, dx, win)
        for it in (0, 1, 8, 16):
            mono = MonoPhase(gn, G, h0, Hp, it)
            e1, d1, mu1, g1 = mono(z, dx, win)
            x, mu, _ = mehrotra_h(G, H, gh, h, it)
            torch.cuda.synchronize()

            def diff(a, b):
                lanes = (a != b).reshape(a.shape[0], -1).any(dim=1)
                return [int(lanes.sum()), chip_smoke.mismatch(a, b)]

            res[f"differ_{it}"] = {k: diff(a, b) for k, a, b in
                                   (("e", e1, eh), ("g", g1, gh), ("d", d1, x), ("mu", mu1, mu))}
            if it >= 8:
                res[f"k3w_ms_{it}"] = chip_smoke.cuda_ms(lambda: mono(z, dx, win), reps=5)
                res[f"k2w_ms_{it}"] = chip_smoke.cuda_ms(lambda: mehrotra_h(G, H, gh, h, it),
                                                         reps=5)
        res["k1w_ms"] = chip_smoke.cuda_ms(lambda: gn(z, dx, win), reps=10)
        print(json.dumps({name: res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
