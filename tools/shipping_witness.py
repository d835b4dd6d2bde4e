#!/usr/bin/env python3
"""Where the shipping-backend configuration's unconverged steps come from:
the port's QPs at such a step, solved by the port and by the reference, on
the CPU.

The configuration is tests/test_parity.py:229-291's: LBMPC_N50, float32,
the pallas_full hybrid (sqp 2, ipm (16, 8), both QPs cold, the ladders
((1,), (1, .5, .25))), the fused repair of 1 of the 8 identical lanes,
learning on. Its fused solve flags a lane when the last QP's mu is not
below 1e-2 (or z is infeasible or not finite). The tool runs the port's
episode on its plain route (K1w's and K2w's plain versions) over --steps
steps with --threads torch threads, and records every solve's inputs. At
the first unconverged step (or --step) and the step before it, it calls
the port's fused solve on those inputs, records the two QPs it hands to K2w
(H, g, the right-hand side), and solves each again with:
- the port's plain K2w in float32 (what the episode ran) and in float64;
- the reference's K2w, build_pallas_qp_solver_h in Pallas interpret mode
  (tile 8), the same iterations, float32.
It reports each QP's mu by solver and the largest |x_port - x_reference|.
Prints one JSON line. (The reference's whole fused solve in interpret mode,
and its closed loop, do not fit in 10 GiB of host memory; its K2w does.)

    JAX_PLATFORMS=cpu python tools/shipping_witness.py [--steps 40] [--threads 1]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
B = 8


def port_episode(steps: int):
    """The port's episode on its plain route over `steps` steps: each
    solve's (dx0, window, z_ws), the episode's result, and the solver."""
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    cfg = lt.make_preset("LBMPC_N50", iterations=steps)
    _, run = build_fleet_episode(cfg, backend="hybrid", qp_kernel="pallas_full",
                                 ipm_iters=(16, 8), sqp_iters=2, repair_frac=1.0 / B,
                                 device="cpu")
    solver, calls = run.solver, []
    raw = solver.raw

    def recording(dx0, windows, z_ws):
        calls.append((dx0.clone(), type(windows)(*(a.clone() for a in windows)), z_ws.clone()))
        return raw(dx0, windows, z_ws)

    solver.raw = recording
    res = run(np.broadcast_to(np.asarray(cfg.dx_init), (B, 4)).copy())
    solver.raw = raw
    return calls, res, solver


def fused_qps(solver, call):
    """The port's fused solve on one recorded call: its conv flags and the
    QPs it handed to K2w, [(its QP solver, H, g, h)]."""
    fused, qps = solver.fused, []
    wrapped = {}
    for key, qp in fused._qps.items():
        wrapped[key] = qp.raw_packed

        def rec(H, g, h, warm=None, _f=qp.raw_packed, _qp=qp):
            qps.append((_qp, H.clone(), g.clone(), h.clone()))
            return _f(H, g, h, warm)

        qp.raw_packed = rec
    try:
        _, conv = fused.raw(*call)
    finally:
        for key, qp in fused._qps.items():
            qp.raw_packed = wrapped[key]
    return conv, qps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from lbmpc_tpu.ops.pallas_ipm import build_pallas_qp_solver_h
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h_plain

    torch.set_num_threads(args.threads)
    calls, res, solver = port_episode(args.steps)
    unconv = np.nonzero(~res.solver_converged[0].numpy())[0].tolist()
    k = args.step if args.step is not None else (unconv[0] if unconv else args.steps - 1)
    G = solver.fused.G
    builds = {}
    out = {"threads": args.threads, "steps": args.steps, "episode_unconverged_steps": unconv,
           "step": k, "qps": []}
    for i in (k - 1, k):
        conv, qps = fused_qps(solver, calls[i])
        for j, (qp, H, g, h) in enumerate(qps):
            iters, kw = qp.iters, dict(tau=qp.tau, d_cap=qp.d_cap)
            row = {"step": i, "fused_conv_lane0": bool(conv[0]), "qp": j, "iters": iters}
            x32, mu32, _ = mehrotra_h_plain(G, H, g, h, iters, **kw)
            d = lambda a: a.double()
            x64, mu64, _ = mehrotra_h_plain(d(G), d(H), d(g), d(h), iters, **kw)
            if iters not in builds:
                builds[iters] = build_pallas_qp_solver_h(G.numpy(), iters=iters, tile=B,
                                                         interpret=True, **kw)
            jx = lambda a: jnp.asarray(a.numpy(), jnp.float32)
            xr, mur = builds[iters](jx(H), jx(g), jx(h))[:2]
            xr, mur = np.asarray(xr)[:B], np.asarray(mur)[:B]
            row.update(mu_port_f32=float(mu32[0]), mu_port_f64=float(mu64[0]),
                       mu_reference_f32=float(mur[0]),
                       max_abs_dx_port_vs_reference=float(np.abs(x32.numpy() - xr).max()),
                       max_abs_dx_f32_vs_f64=float((x32.double() - x64).abs().max()))
            out["qps"].append(row)
            print(json.dumps(row), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
