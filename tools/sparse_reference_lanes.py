#!/usr/bin/env python3
"""The sparse LMPC's hard lanes, in the JAX package and in the port (CPU,
float64, ~2 minutes).

chip_smoke.py phase 34 solves DMS_LMPC (N=50) from 1024 seeded states
(seed 21) and phase 36 runs 64 of them (seed 23) in closed loop. On a few
lanes the two packages behave alike in ways that their own tests at one
state do not show:

1. sparse_parallel against sparse on lanes 611 and 653 of the phase-34
   states, each package alone (one lane) and batched (the reference vmapped
   over all 1024, the port's batch of 1024): where the barrier weights reach
   their cap the associative scan's answer turns on roundoff;
2. the condensed and sparse closed loops of lane 43 of the phase-36 states
   over 5 steps, in each package.

    JAX_PLATFORMS=cpu python tools/sparse_reference_lanes.py
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch

    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu.config import make_preset
    from lbmpc_tpu.ops import sparse_ipm as j_sp
    from lbmpc_tpu.runtime.scenario import build_scenario as j_build
    from lbmpc_tpu_torch import interop
    from lbmpc_tpu_torch.ops import sparse_ipm as t_sp
    from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

    cfg = make_preset("DMS_LMPC")
    sc = j_build(cfg)
    ref_qp = j_sp.make_stage_qp(sc.A, sc.B, sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T,
                                sc.ocp.LAMBDA, sc.ocp.PSI, sc.cs, cfg.ocp.N, delta=cfg.plant.ts)
    qp = interop.from_reference(ref_qp, device="cpu")
    dx = cs.sparse_states(lt.make_preset("DMS_LMPC"), 1024, 21)
    lanes = (611, 653)
    print("1. U[0] (mu, converged) by package, route and batch; DMS_LMPC N=50, 25 iterations")
    for par in (False, True):
        route = "sparse_parallel" if par else "sparse"
        batched = jax.jit(jax.vmap(lambda x: j_sp.solve_sparse(ref_qp, x, iters=25,
                                                               parallel=par)))(jnp.asarray(dx))
        alone = jax.jit(lambda x: j_sp.solve_sparse(ref_qp, x, iters=25, parallel=par))
        port_b = t_sp.solve_sparse(qp, torch.tensor(dx), iters=25, parallel=par)
        for i in lanes:
            a = alone(jnp.asarray(dx[i]))
            port_a = t_sp.solve_sparse(qp, torch.tensor(dx[i:i + 1]), iters=25, parallel=par)
            print(f"  lane {i} {route:15s} reference alone {float(a.U[0, 0]):.10f} "
                  f"({float(a.mu):.2e}, {bool(a.converged)}), vmapped "
                  f"{float(batched.U[i, 0, 0]):.10f} ({float(batched.mu[i]):.2e}, "
                  f"{bool(batched.converged[i])}); port alone {float(port_a.U[0, 0, 0]):.10f} "
                  f"({float(port_a.mu[0]):.2e}, {bool(port_a.converged[0])}), batched "
                  f"{float(port_b.U[i, 0, 0]):.10f} ({float(port_b.mu[i]):.2e}, "
                  f"{bool(port_b.converged[i])})")
    print("2. lane 43 of phase 36's states, 5 steps: max |sysH| difference")
    lane = cs.sparse_states(lt.make_preset("DMS_LMPC"), 64, 23)[43]
    hist = {}
    for b in ("condensed", "sparse"):
        rc = dataclasses.replace(cfg, iterations=5,
                                 solver=dataclasses.replace(cfg.solver, qp_backend=b))
        hist["ref " + b] = np.asarray(j_build(rc).episode(jnp.asarray(lane)).sys_history)
        tc = dataclasses.replace(lt.make_preset("DMS_LMPC"), iterations=5,
                                 solver=dataclasses.replace(cfg.solver, qp_backend=b))
        hist["port " + b] = t_build(tc, device="cpu").run(lane).sys_history.numpy()
    d = lambda a, b: np.abs(hist[a] - hist[b]).max()
    print(f"  reference sparse - reference condensed {d('ref sparse', 'ref condensed'):.3e}")
    print(f"  port sparse - port condensed {d('port sparse', 'port condensed'):.3e}")
    print(f"  port sparse - reference sparse {d('port sparse', 'ref sparse'):.3e}")
    print(f"  port condensed - reference condensed {d('port condensed', 'ref condensed'):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
