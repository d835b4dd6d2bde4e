#!/usr/bin/env python3
"""K2w's 2-iteration warm solve at nz=33 against the reference's own solvers.

tests/test_torch_gpu.py::test_qp_wide_kernel_matches_plain[fmincon-33]
holds K2w's warm 2-iteration solve (from K2w's own 8-iteration state) to
the float64 solve from the same state: its median distance at most 1.5
times the float32 plain version's (+1e-8), and at most one more lane beyond
5e-2. This script asks whether the reference's own K2 meets that gate on
the same inputs, in two steps:

1. On the card (`--capture FILE`, no JAX): the test's QP (LBMPC_N40 at
   N=32: nz=33, G (334, 33); K1w's H and g on the test's seeded inputs,
   B=96, seed 12), K2w's 8 cold iterations with their final state and its
   2 warm ones from it, and the card's plain version and float64 solve of
   those 2, saved to an npz; prints the test's numbers.
2. On the CPU (`--npz FILE`, imports JAX): three solvers, each in two ways.
   - the reference's K2, lbmpc_tpu.ops.pallas_ipm.build_pallas_qp_solver_h
     in interpret mode (float32, the TPU kernel's own code);
   - the reference's XLA-composed per-problem IPM, lbmpc_tpu.ops.ipm
     solve_qp / solve_qp_warm (float32, vmapped; its own semantics: d capped
     at 1e7, no ridge, no equilibration, a stopping test);
   - the port's plain version (ops/qp_kernel.mehrotra_h_plain) in float32
     and in float64.
   Each runs 2 warm iterations from K2w's 8-iteration state, and along each
   solver's own chain (8 cold iterations with the final state, then 2 warm
   from it). Every warm result is compared with the float64 solve from the
   same state, beside the float32 plain version's distance, by the test's
   gate; from K2w's state also against the plain version as the card
   computes it, which is what the test holds K2w to.

The reference's warm state is in its kernel layout, (rows, Bp): rows in
its analysis's order (analyze_constraint_rows' d_rows, then the split
block's) padded to a multiple of 128, lanes padded to the tile. K2w's
(B, mI) state in G's row order is mapped into it with that row map, and
the map is checked first: the cold start (s = max(h, 1), z = 1) through the
map must equal the reference's own cold_state(h), and fed as a warm start
it must give the reference's cold solve bit for bit.

    python3 tools/k2w_nz33_reference.py --capture build/k2w_nz33.npz   # card
    JAX_PLATFORMS=cpu python tools/k2w_nz33_reference.py --npz build/k2w_nz33.npz
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
FAMILY, NZ, B, SEED, Q = "fmincon", 33, 96, 12, 100
COLD, WARM, WARM_EPS = 8, 2, 1e-5


def test_qp(dev):
    """tests/test_torch_gpu.py's _wide_qp(cuda, "fmincon", 33, 96, seed=12):
    (G, H, g, h) as float32 tensors on dev."""
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.oracle import DataWindow
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.qp_kernel import step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=NZ - 1))
    sc = build_scenario(cfg)
    kw = dict(family=FAMILY, delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=dev, **kw)
    rng = np.random.default_rng(SEED)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    dx = f(np.array([-0.35, -0.4, 0, 0]) + 0.01 * rng.standard_normal((B, 4)))
    win = DataWindow(f(0.1 * rng.standard_normal((B, Q, 3))),
                     f(0.001 * rng.standard_normal((B, Q, 4))),
                     f((rng.uniform(size=(B, Q)) > 0.2).astype(float)),
                     torch.full((B,), Q, dtype=torch.int32, device=dev))
    z = f(0.02 * rng.standard_normal((B, NZ)))
    _, H, g = gn(z, dx, win)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)[:1024], device=dev)
    G = t(sc.qp.G)
    return G, H, g, step_rhs(t(sc.qp.h0), t(sc.qp.Hp), G, dx, z)


def gate(x, x_plain, x64) -> dict:
    """The test's gate (_as_close, slack 1): median |x - x64| at most 1.5x
    the plain version's (+1e-8), at most one more lane beyond 5e-2."""
    ea, eb = (np.abs(np.asarray(a, np.float64) - x64) for a in (x, x_plain))
    far = lambda e: int((~(e.max(axis=1) <= 5e-2)).sum())
    ma, mb = float(np.median(ea)), float(np.median(eb))
    return {"median": ma, "plain_median": mb, "ratio": ma / mb if mb else float("inf"),
            "far": far(ea), "plain_far": far(eb),
            "passes": bool(ma <= 1.5 * mb + 1e-8 and far(ea) <= far(eb) + 1)}


def capture(out: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2w_nz33_reference: --capture needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h, mehrotra_h_plain

    dev = torch.device("cuda", 0)
    G, H, g, h = test_qp(dev)
    x8, mu8, st = mehrotra_h(G, H, g, h, COLD, want_state=True)
    xw, muw, _ = mehrotra_h(G, H, g, h, WARM, warm=st)
    xwp = mehrotra_h_plain(G, H, g, h, WARM, warm=st)[0]
    x64 = mehrotra_h_plain(G.double(), H.double(), g.double(), h.double(), WARM,
                           warm=tuple(a.double() for a in st))[0]
    torch.cuda.synchronize()
    c = lambda a: a.detach().cpu().numpy()
    arrays = dict(G=c(G), H=c(H), g=c(g), h=c(h), s8=c(st[0]), z8=c(st[1]), x8=c(x8),
                  mu8=c(mu8), xw=c(xw), muw=c(muw), xw_plain=c(xwp), xw_f64=c(x64))
    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    print(json.dumps({"captured": out, "device": torch.cuda.get_device_name(0),
                      "k2w_warm_vs_float64": gate(c(xw), c(xwp), c(x64))}), flush=True)
    return 0


class Reference:
    """The reference's K2 (interpret mode) and its row map for one G."""

    def __init__(self, G: np.ndarray, tile: int = 256):
        from lbmpc_tpu.ops.pallas_ipm import (BIG, analyze_constraint_rows,
                                               build_pallas_qp_solver_h)

        self.G, self.tile, self.big = G, tile, BIG
        r = analyze_constraint_rows(G)
        self.parts = [(np.asarray(r["d_rows"], np.int64), r["mD_p"])]
        if r["mS"]:
            self.parts.append((np.asarray(r["sp_rows"], np.int64), r["mS_p"]))
        self.build = lambda it, **kw: build_pallas_qp_solver_h(G, iters=it, tile=tile,
                                                               interpret=True, **kw)

    def lanes(self, b: int) -> int:
        return b + (-b) % self.tile

    def to_kernel(self, s, z):
        """(B, mI) state in G's row order -> the kernel-layout tuple
        (s_d, z_d[, s_sp, z_sp]): rows by the analysis's map, padded rows
        s = BIG, z = 0; padded lanes as cold_state leaves them (s = BIG,
        z = 1 on real rows)."""
        b = s.shape[0]
        bp = self.lanes(b)
        out = []
        for rows, rows_p in self.parts:
            sk = np.full((rows_p, bp), self.big, np.float32)
            zk = np.zeros((rows_p, bp), np.float32)
            zk[:len(rows), :] = 1.0
            sk[:len(rows), :b] = s[:, rows].T
            zk[:len(rows), :b] = z[:, rows].T
            out += [sk, zk]
        return tuple(out)

    def from_kernel(self, state, b: int, mI: int):
        s = np.zeros((b, mI), np.float32)
        z = np.zeros((b, mI), np.float32)
        for i, (rows, _) in enumerate(self.parts):
            s[:, rows] = np.asarray(state[2 * i])[:len(rows), :b].T
            z[:, rows] = np.asarray(state[2 * i + 1])[:len(rows), :b].T
        return s, z


def analyse(npz: str) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    sys.path.insert(0, str(ROOT))
    from lbmpc_tpu.ops.ipm import solve_qp, solve_qp_warm
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h_plain

    a = dict(np.load(npz))
    G, H, g, h = a["G"], a["H"], a["g"], a["h"]
    b, mI = h.shape
    ref = Reference(G)
    cold8 = ref.build(COLD, warm_out=True)
    warm2 = ref.build(WARM, warm_in=True)
    jx = lambda v: jnp.asarray(v, jnp.float32)
    report: dict = {"npz": npz, "B": int(b), "mI": int(mI), "nz": int(G.shape[1])}

    # the row map, checked: the cold start through it is the reference's
    # cold_state, and as a warm start it gives the cold solve bit for bit
    s_c, z_c = np.maximum(h, 1.0).astype(np.float32), np.ones_like(h)
    mapped = ref.to_kernel(s_c, z_c)
    own = cold8.cold_state(jx(h))
    report["map_cold_state_equal"] = bool(all(np.array_equal(np.asarray(u), v)
                                              for u, v in zip(own, mapped)))
    x_r8, mu_r8, st_r8 = cold8(jx(H), jx(g), jx(h))
    cold8_warm = ref.build(COLD, warm_in=True, warm_out=True)
    x_c, mu_c, _ = cold8_warm(jx(H), jx(g), jx(h), warm=tuple(jx(v) for v in mapped))
    report["map_warm_cold_equals_cold"] = bool(
        np.array_equal(np.asarray(x_c), np.asarray(x_r8))
        and np.array_equal(np.asarray(mu_c), np.asarray(mu_r8)))
    if not (report["map_cold_state_equal"] and report["map_warm_cold_equals_cold"]):
        print(json.dumps(report), flush=True)
        print("k2w_nz33_reference: the row map does not reproduce the reference's cold "
              "start", file=sys.stderr)
        return 1

    t32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float32)
    t64 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.float64)

    def port(dtype_t, it, warm=None):
        x, mu, st = mehrotra_h_plain(dtype_t(G), dtype_t(H), dtype_t(g), dtype_t(h), it,
                                     warm=None if warm is None else tuple(dtype_t(v) for v in warm))
        return x.numpy(), mu.numpy(), tuple(v.numpy() for v in st)

    def ref_kernel_warm(s, z):
        return np.asarray(warm2(jx(H), jx(g), jx(h), warm=tuple(jx(v) for v in ref.to_kernel(s, z)))[0])

    xla_cold = jax.jit(jax.vmap(lambda H_, g_, h_: solve_qp(H_, g_, jx(G), h_, iters=COLD)))
    xla_warm = jax.jit(jax.vmap(lambda H_, g_, h_, s_, z_: solve_qp_warm(
        H_, g_, jx(G), h_, (jnp.zeros(G.shape[1], jnp.float32), jnp.maximum(s_, WARM_EPS),
                            jnp.maximum(z_, WARM_EPS)), iters=WARM)))

    def xla_warm_x(s, z):
        return np.asarray(xla_warm(jx(H), jx(g), jx(h), jx(s), jx(z)).x)

    sol = xla_cold(jx(H), jx(g), jx(h))
    starts = {"k2w": (a["s8"], a["z8"]),
              "reference_kernel": ref.from_kernel(st_r8, b, mI),
              "reference_xla": (np.asarray(sol.s), np.asarray(sol.z)),
              "port_plain": port(t32, COLD)[2]}
    x_p8 = port(t32, COLD)[0]
    x_64_8 = port(t64, COLD)[0]
    report["cold_8"] = {
        "k2w": gate(a["x8"], x_p8, x_64_8),
        "reference_kernel": gate(np.asarray(x_r8)[:b], x_p8, x_64_8),
        "reference_xla": gate(np.asarray(sol.x), x_p8, x_64_8),
        "reference_kernel_vs_k2w_max": float(np.abs(np.asarray(x_r8)[:b] - a["x8"]).max())}
    for name, (s, z) in starts.items():
        x64 = port(t64, WARM, (s, z))[0]
        xp = port(t32, WARM, (s, z))[0]
        row_kernel, row_xla = ref_kernel_warm(s, z), xla_warm_x(s, z)
        row = {"reference_kernel": gate(row_kernel, xp, x64),
               "reference_xla": gate(row_xla, xp, x64)}
        if name == "k2w":
            row["k2w"] = gate(a["xw"], xp, x64)
            if "xw_plain" in a:
                # the test's own comparison: the plain version and the
                # float64 solve as the card computes them
                x64c, xpc = a["xw_f64"], a["xw_plain"]
                row["against_the_card_plain"] = {
                    "k2w": gate(a["xw"], xpc, x64c),
                    "reference_kernel": gate(row_kernel, xpc, x64c),
                    "reference_xla": gate(row_xla, xpc, x64c)}
        report[f"warm_2_from_{name}_state"] = row
        print(json.dumps({name: row}), flush=True)
    print(json.dumps(report), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capture", default="", help="card: write the inputs and K2w's results here")
    ap.add_argument("--npz", default="", help="CPU: run the reference's solvers on this capture")
    args = ap.parse_args(argv)
    if args.capture:
        return capture(args.capture)
    if args.npz:
        return analyse(args.npz)
    ap.error("give --capture FILE (card) or --npz FILE (CPU)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
