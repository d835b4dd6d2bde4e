#!/usr/bin/env python3
"""Converged share per step of the uncut LBMPC_N40 fleet, reference and port,
on the CPU.

chip_smoke.py's phase-26 configuration (float32, sqp 2, ipm (16, 8) cold, the
ladders ((1,), (1, .5, .25)), 20 steps) on the first `--lanes` lanes of its
cohort (dx_init from numpy seed 1): the reference's fused fleet on its xla
route (its XLA Cholesky, no Pallas), and the port's pallas_mono fused and
hybrid fleets (K3w's plain version; the hybrid with the vmapped repair of
round(lanes / 85) lanes, as build_fleet_episode picks it). Prints one JSON
line: conv per step for each.

    JAX_PLATFORMS=cpu python tools/fleet_conv_reference.py [--lanes 256]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ["LBMPC_CHOL"] = "xla"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)     # as the reference's tests run it
    import jax.numpy as jnp

    from lbmpc_tpu.config import make_preset
    from lbmpc_tpu.runtime.scenario import build_fleet_episode as ref_fleet

    dx_init = (np.array([-0.35, -0.4, 0.0, 0.0])
               + np.random.default_rng(1).uniform(-0.02, 0.02, (8192, 4)))[:args.lanes]
    ladder = ((1.0,), (1.0, 0.5, 0.25))

    def cut(preset):
        c = preset("LBMPC_N40", iterations=args.steps)
        return dataclasses.replace(c, solver=dataclasses.replace(c.solver, sqp_iters=2,
                                                                 dtype="float32"))

    out = {"lanes": args.lanes}
    _, run = ref_fleet(cut(make_preset), backend="fused", ipm_iters=(16, 8), sqp_iters=2,
                       alphas=ladder)
    res = run(jnp.asarray(dx_init, jnp.float32))
    out["reference_xla_fused"] = np.asarray(res.solver_converged).mean(axis=0).tolist()
    del os.environ["LBMPC_CHOL"]

    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    for backend in ("fused", "hybrid"):
        _, run = build_fleet_episode(cut(lt.make_preset), backend=backend, ipm_iters=(16, 8),
                                     sqp_iters=2, qp_kernel="pallas_mono", device="cpu")
        res = run(dx_init)
        out[f"port_pallas_mono_{backend}"] = res.solver_converged.to(
            torch.float64).mean(dim=0).tolist()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
