#!/usr/bin/env python3
"""The stage-wise LMPC solve graphed and eager, by batch size (card, ~2 min).

DMS_LMPC (N=50, float64) on `sparse` and `sparse_parallel` at B = 1 and
1024 (chip_smoke.py's phase-34 states): each solve captured in a CUDA graph
(runtime/scenario.graph_solve) and run eager, with the capture's host time,
the graph replay's and the eager call's time by CUDA events, and whether
the two agree bit for bit.

    python3 tools/sparse_graph_probe.py          # needs one card
"""

from __future__ import annotations

import dataclasses
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sparse_graph_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_scenario, graph_solve

    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    base = lt.make_preset("DMS_LMPC")
    for backend in ("sparse", "sparse_parallel"):
        cfg = dataclasses.replace(base, solver=dataclasses.replace(
            base.solver, qp_backend=backend, dtype="float64"))
        eager = build_scenario(cfg, device=dev).solve.eager
        graphed = graph_solve(eager, torch.float64, dev, window=False)
        for B in (1, 1024):
            dx = torch.as_tensor(cs.sparse_states(base, B, 21), dtype=torch.float64,
                                 device=dev)
            t0 = time.time()
            zg, _ = graphed(dx, None, None)
            torch.cuda.synchronize()
            capture = time.time() - t0
            (ze, _), te = cs.cuda_call(lambda: eager(dx, None, None))
            tg = cs.cuda_ms(lambda: graphed(dx, None, None), reps=3, warmup=0)
            print(f"{backend} float64 B={B}: graph {tg:.3f} ms, eager {te:.3f} ms, capture "
                  f"{capture:.2f} s, bit-equal {bool(torch.equal(zg, ze))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
