#!/usr/bin/env python3
"""Float32 on the card with the per-problem stack's exact forms.

ops/lanes.batch_forms keeps float32 on the card on the batch's own
products and sums. This turns it off (every module of the package that
reads it sees False), so float32 takes the forms float64 takes, and runs
what decides whether float32 can keep them:
  1. chip_smoke.py's phase 29 (golden_phases): the float32 pallas_mono
     hybrid at LBMPC_N50 against the golden envelope over 40 steps, then
     LMPC_N50 pointwise and the float64 LBMPC_N50 episode; its gates are
     logged, and a failed one does not stop the run;
  2. --sweep: tools/split_lane_bits.py --per-problem at chip_smoke.py's
     LANE_BITS_B;
  3. --cost: tools/split_lane_bits.py --cost --trace.

    python3 tools/f32_exact_forms.py [--no-golden] [--sweep] [--cost]
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def exact_float32() -> None:
    """Every loaded module of the package that reads ops/lanes.batch_forms
    sees False from now on."""
    import lbmpc_tpu_torch.controllers.lbmpc  # noqa: F401  (loads the stack)
    import lbmpc_tpu_torch.runtime.scenario  # noqa: F401

    off = lambda t: False
    for name, mod in list(sys.modules.items()):
        if name.startswith("lbmpc_tpu_torch") and hasattr(mod, "batch_forms"):
            mod.batch_forms = off


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--no-golden", action="store_true", help="skip phase 29")
    ap.add_argument("--sweep", action="store_true", help="the per-problem lane-bit sweep")
    ap.add_argument("--cost", action="store_true", help="the cost of the forms, traced")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    import chip_smoke as cs
    import split_lane_bits as slb
    from lbmpc_tpu_torch.ops import _cuda, mono_kernel

    if not torch.cuda.is_available():
        print("f32_exact_forms: needs a card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"{card}; float32 on the card with the exact forms", flush=True)
    exact_float32()
    failed = []

    def require(ok: bool, what: str) -> None:
        cs.log(f"  check {'ok  ' if ok else 'FAIL'} {what}")
        if not ok:
            failed.append(what)

    cs.require = require
    if not args.no_golden:
        t0 = time.time()
        _cuda.build_all((mono_kernel.KERNEL_WIDE,))
        print(f"  K3w built in {time.time() - t0:.1f} s", flush=True)
        cs.golden_phases(dev, f"[{card}]")
    if args.sweep:
        slb.per_problem(argparse.Namespace(
            device="cuda", batches=",".join(map(str, cs.LANE_BITS_B))))
    if args.cost:
        slb.cost(argparse.Namespace(device="cuda", package_root=None, trace=True))
    print(f"failed gates: {failed}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
