#!/usr/bin/env python3
"""Whether a lane's bits depend on the batch's size, on the card.

The NMPC's solves give a lane the same bits at any batch size (phase 31 of
chip_smoke.py holds lane 0 of a 1024-lane NMPC_N50 batch to its single-lane
run). This tool shows what that rests on: for each operation form the
solve could use, lane 0 of a batch of 1024 against the same lane computed
in a batch of 1, 2, 8 and 64 (max |difference|; 0 means the same bits):
- cuBLAS's batched matrix-vector product (`A @ v[..., None]`) and the
  two-column product that `ops/lanes.exact_mv` uses, at the NMPC's QP
  shapes;
- torch's row sums against `ops/lanes.exact_sum` (chunks of 128);
- a small product with the batch in its rows (`x @ W`, W 4 x 4 dense) and
  `controllers/nmpc._prod` (products and a short sum per entry);
- cuSOLVER's batched Cholesky and triangular solve;
then the solve itself (lane 0 of 1024 against one lane) and the closed
loop, NMPC_N50 over 10 steps, step by step. Prints one JSON line.

    python tools/nmpc_lane_bits.py
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.nmpc import _prod
    from lbmpc_tpu_torch.ops.lanes import exact_mv, exact_sum
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = lt.resolve_device(None)
    gen = torch.Generator(device="cpu").manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen, dtype=torch.float64).to(dev)
    W = rand(4, 4)

    def spd(B):
        A = torch.randn(B, 51, 51, generator=gen, dtype=torch.float64)
        return (A @ A.transpose(1, 2) + 51 * torch.eye(51, dtype=torch.float64)).to(dev)

    forms = {
        "bmv (B,600,51)@v": (lambda x: (x @ x[:, 0, :, None])[..., 0], lambda B: rand(B, 600, 51)),
        "exact_mv (B,600,51)": (lambda x: exact_mv(x, x[:, 0]), lambda B: rand(B, 600, 51)),
        "bmv (B,101,1100)@v": (lambda x: (x @ x[:, 0, :, None])[..., 0], lambda B: rand(B, 101, 1100)),
        "exact_mv (B,101,1100)": (lambda x: exact_mv(x, x[:, 0]), lambda B: rand(B, 101, 1100)),
        "sum (B,1100)": (lambda x: x.sum(-1), lambda B: rand(B, 1100)),
        "exact_sum (B,1100)": (exact_sum, lambda B: rand(B, 1100)),
        "x @ W (B,48,4)": (lambda x: x @ W, lambda B: rand(B, 48, 4)),
        "_prod (B,48,4)": (lambda x: _prod(x, W), lambda B: rand(B, 48, 4)),
        "cholesky_ex (B,51,51)": (lambda x: torch.linalg.cholesky_ex(x)[0], spd),
        "solve_triangular (B,51,51)": (
            lambda x: torch.linalg.solve_triangular(torch.linalg.cholesky_ex(x)[0], x[..., :1],
                                                    upper=False), spd),
    }
    out = {"device": torch.cuda.get_device_name(0), "forms": {}}
    for name, (f, make) in forms.items():
        big = make(1024)
        a = f(big)[0]
        out["forms"][name] = {f"B={b}": float((a - f(big[:b].clone())[0]).abs().max())
                              for b in (1, 2, 8, 64)}
        print(name, out["forms"][name], file=sys.stderr, flush=True)

    cfg = lt.make_preset("NMPC_N50", iterations=10)
    sc = build_scenario(cfg, device=dev)
    rng = np.random.default_rng(11)
    dxs = np.asarray(cfg.dx_init) + np.array([0.02, 0.02, 0.05, 0.5]) * rng.standard_normal(
        (1024, 4))
    dx = torch.tensor(dxs, device=dev)
    z0 = torch.zeros(1024, sc.nz, dtype=torch.float64, device=dev)
    zb, _ = sc.solve(dx, None, z0)
    z1, _ = sc.solve(dx[:1], None, z0[:1])
    out["solve_lane0_vs_single"] = float((zb[0] - z1[0]).abs().max())
    res = sc.run_batch(dxs)
    one = sc.run(dxs[0])
    out["episode_lane0_vs_single_by_step"] = (
        res.sys_history[0] - one.sys_history).abs().amax(dim=1).cpu().tolist()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
