#!/usr/bin/env python3
"""How long the float32 hybrid fleet at LBMPC_N50 stays in the reference's
golden envelope, reference and port, on the CPU.

One lane from the preset's dx_init, float32, sqp 2, ipm (16, 8), the ladders
((1,), (1, .5, .25)), the hybrid repair as build_fleet_episode builds it
(1 GN x 8 IPM from the fused iterate, the vmapped backend off pallas_full):
the reference's fleet on its xla route (its XLA Cholesky, no Pallas) and the
port's on pallas_mono (K3w's plain version). Each against
tests/golden/LBMPC_N50.npz with the envelope of tests/test_parity.py:229-300
(every state within 2e-2, the first two within 2e-3): the first step that
leaves it, the steps whose solve is unconverged, the largest error. Prints
one JSON line.

    JAX_PLATFORMS=cpu python tools/n50_float32_reference.py [--steps 300]
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
LADDER = ((1.0,), (1.0, 0.5, 0.25))


def summary(sys_history: np.ndarray, conv: np.ndarray, steps: int) -> dict:
    """sys_history (steps+1, 5) and conv (steps,) against the golden."""
    g = np.load(ROOT / "tests" / "golden" / "LBMPC_N50.npz")["sysH"][:, : steps + 1]
    err = np.abs(sys_history.T - g)
    out_all = np.nonzero(err.max(axis=0) > 2e-2)[0]
    out_two = np.nonzero(err[:2].max(axis=0) > 2e-3)[0]
    leaves = [int(a[0]) for a in (out_all, out_two) if a.size]
    return {"first_step_out_of_envelope": min(leaves) if leaves else None,
            "unconverged_steps": np.nonzero(~conv)[0].tolist(),
            "max_error": float(err.max()), "first_two_states_max_error": float(err[:2].max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    os.environ["LBMPC_CHOL"] = "xla"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)     # as the reference's tests run it
    import jax.numpy as jnp

    from lbmpc_tpu.config import make_preset
    from lbmpc_tpu.runtime.scenario import build_fleet_episode as ref_fleet

    cfg = make_preset("LBMPC_N50", iterations=args.steps)
    dx = np.asarray(cfg.dx_init)[None]
    out = {"steps": args.steps}
    _, run = ref_fleet(cfg, backend="hybrid", ipm_iters=(16, 8), sqp_iters=2, alphas=LADDER)
    res = run(jnp.asarray(dx, jnp.float32))
    out["reference_xla_hybrid"] = summary(np.asarray(res.sys_history)[0],
                                          np.asarray(res.solver_converged)[0], args.steps)
    del os.environ["LBMPC_CHOL"]

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    _, run = build_fleet_episode(lt.make_preset("LBMPC_N50", iterations=args.steps),
                                 backend="hybrid", qp_kernel="pallas_mono", ipm_iters=(16, 8),
                                 sqp_iters=2, device="cpu")
    res = run(dx)
    out["port_pallas_mono_hybrid"] = summary(res.sys_history[0].numpy(),
                                             res.solver_converged[0].numpy(), args.steps)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
