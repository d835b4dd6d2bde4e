#!/usr/bin/env python3
"""K2's float32 results under variants of its rounding, against an earlier
tree's K2 and against the float64 solve, on the card.

Each variant is a copy of lbmpc_tpu_torch/csrc (in build/k2_numerics/NAME)
whose mehrotra_warp.cuh has some operations rounded another way (VARIANTS:
text substitutions; "package" is csrc as it is). On the bench QP
(LBMPC_N40 cut to N=20, q=100: nz=21, G (214, 21), H and g from K1 on
chip_smoke.py's seeded inputs, B=2048) it prints, per variant:
- whether x, mu, s and z equal the earlier tree's K2 (--parent DIR, an
  unpacked `git archive <commit>` holding lbmpc_tpu_torch/csrc) bit for bit
  after 0, 1, 2 and 8 cold iterations, and how many lanes differ; and after
  0, 1 and 2 warm iterations from the earlier tree's 8-iteration state (the
  lanes whose x, mu, s and z differ);
- at 16 iterations the share of lanes that stall (mu >= 1e-6), which
  chip_smoke.qp_step_gates holds within 2 pp of the plain version's, beside
  the earlier tree's, the plain version's and the float64 solve's, and each
  solve's median distance from the float64 one;
- its time at 8 iterations.
Needs one card.

    python3 tools/k2_numerics.py --parent DIR [--only NAME,...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))

RC = """          return __fmaf_rn(-sigma, mu, __fmaf_rn(rows.dsa(t), rows.dza(t),
                                                 __fmul_rn(rows.s(t), rows.z(t))));"""
VARIANTS = {
    "rc_sz_fused": [(RC, """          return __fmaf_rn(-sigma, mu, __fmaf_rn(rows.s(t), rows.z(t),
                                                 __fmul_rn(rows.dsa(t), rows.dza(t))));""")],
    "rc_unfused": [(RC, """          return __fsub_rn(__fadd_rn(__fmul_rn(rows.s(t), rows.z(t)),
                                     __fmul_rn(rows.dsa(t), rows.dza(t))),
                           __fmul_rn(sigma, mu));""")],
    "rc_sub_unfused": [(RC, """          return __fsub_rn(__fmaf_rn(rows.dsa(t), rows.dza(t),
                                     __fmul_rn(rows.s(t), rows.z(t))),
                           __fmul_rn(sigma, mu));""")],
    "t_fused": [("wm.v[r] = __fsub_rn(__fmul_rn(rows.d(t), rows.rp(t)), __fdiv_rn(rc(t), ss));",
                 "wm.v[r] = __fmaf_rn(rows.d(t), rows.rp(t), -__fdiv_rn(rc(t), ss));")],
    "dz_fused": [("__fsub_rn(__fmul_rn(rows.d(t), __fadd_rn(rows.rp(t), gdx)), q));",
                  "__fmaf_rn(rows.d(t), __fadd_rn(rows.rp(t), gdx), -q));")],
    "update_unfused": [
        ("rows.s(t) = __fmaf_rn(ap, rows.dsa(t), rows.s(t));",
         "rows.s(t) = __fadd_rn(rows.s(t), __fmul_rn(ap, rows.dsa(t)));"),
        ("rows.z(t) = __fmaf_rn(ad, rows.dza(t), rows.z(t));",
         "rows.z(t) = __fadd_rn(rows.z(t), __fmul_rn(ad, rows.dza(t)));")],
    "aff_unfused": [("""                                     return __fmaf_rn(__fmaf_rn(ap_a, rows.dsa(t), rows.s(t)),
                                                      __fmaf_rn(ad_a, rows.dza(t), rows.z(t)),
                                                      p);""",
                     """                                     return __fmaf_rn(
                                         __fadd_rn(rows.s(t), __fmul_rn(ap_a, rows.dsa(t))),
                                         __fadd_rn(rows.z(t), __fmul_rn(ad_a, rows.dza(t))), p);""")],
}


def variant_kernel(name: str, subs):
    """K2's CudaKernel built from a copy of csrc with `subs` applied to
    mehrotra_warp.cuh."""
    from lbmpc_tpu_torch.ops import _cuda, qp_kernel

    d = ROOT / "build" / "k2_numerics" / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_cuda.CSRC, d)
    head = d / "mehrotra_warp.cuh"
    text = head.read_text()
    for a, b in subs:
        if a not in text:
            raise ValueError(f"variant {name}: {a!r} not found")
        text = text.replace(a, b)
    head.write_text(text)
    k = _cuda.CudaKernel("mehrotra_h", qp_kernel.KERNEL.argtypes, flags=qp_kernel.KERNEL.flags)
    k.source = d / "mehrotra_h.cu"
    return k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="an earlier tree (holding lbmpc_tpu_torch/csrc)")
    ap.add_argument("--only", default="", help="comma-separated variant names (default: all)")
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_numerics: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import k2_compare
    import k2_split
    from lbmpc_tpu_torch.ops import _cuda, qp_kernel
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h, mehrotra_h_plain

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card, flush=True)
    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    kernels = {"package": qp_kernel.KERNEL}
    kernels.update({n: variant_kernel(n, VARIANTS[n]) for n in names})
    parent = k2_compare.parent_kernels(pathlib.Path(args.parent) / "lbmpc_tpu_torch" / "csrc")
    logs = _cuda.build_all([*kernels.values(), parent["k2"]], verbose=True)
    for name, text in logs.items():
        print(f"ptxas {name}: {k2_split.ptxas_summary(text)}", flush=True)
    qp = k2_split.bench_qp(dev, 2048)
    G, H, g, h = qp["G"], qp["H"], qp["g"], qp["h"]
    run_parent = lambda it: k2_compare.run_k2_parent(parent["k2"], dev, G, H, g, h, it)
    ref = {it: run_parent(it) for it in (0, 1, 2, 8, 16)}
    warm = ref[8][2]
    ref_warm = {it: k2_compare.run_k2_parent(parent["k2"], dev, G, H, g, h, it, warm)
                for it in (0, 1, 2)}
    xp, mup, _ = mehrotra_h_plain(G, H, g, h, 16)
    x64, mu64, _ = mehrotra_h_plain(G.double(), H.double(), g.double(), h.double(), 16)
    stall = lambda m: float((~(m < 1e-6)).float().mean())
    med = lambda x: float((x.double() - x64).abs().median())
    base = {"parent": stall(ref[16][1]), "plain": stall(mup), "float64": stall(mu64),
            "parent_median_from_float64": med(ref[16][0]), "plain_median_from_float64": med(xp)}
    print(json.dumps({"stall_share_16_references": base}), flush=True)
    lines = []
    saved = qp_kernel.KERNEL
    try:
        for name, k in kernels.items():
            qp_kernel.KERNEL = k
            row = {"variant": name}
            for it in (0, 1, 2, 8):
                x, mu, st = mehrotra_h(G, H, g, h, it, want_state=True)
                xo, muo, sto = ref[it]
                diff = ((x != xo).any(dim=1) | (mu != muo) | (st[0] != sto[0]).any(dim=1)
                        | (st[1] != sto[1]).any(dim=1))
                row[f"lanes_differing_{it}"] = int(diff.sum())
            for it in (0, 1, 2):
                x, mu, st = mehrotra_h(G, H, g, h, it, warm=warm, want_state=True)
                xo, muo, sto = ref_warm[it]
                row[f"warm_lanes_differing_{it}"] = [int(v.sum()) for v in (
                    (x != xo).any(dim=1), mu != muo, (st[0] != sto[0]).any(dim=1),
                    (st[1] != sto[1]).any(dim=1))]
            xk, muk, _ = mehrotra_h(G, H, g, h, 16)
            row.update(stall_share_16=stall(muk), median_from_float64_16=med(xk),
                       ms_8=cs.cuda_ms(lambda: mehrotra_h(G, H, g, h, 8, want_state=True),
                                       reps=10))
            lines.append(row)
            print(json.dumps(row), flush=True)
    finally:
        qp_kernel.KERNEL = saved
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for c in [{"stall_share_16_references": base}] + lines:
                fh.write(json.dumps({**c, "card": card}) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
