#!/usr/bin/env python3
"""K6a and K6b against an earlier tree's, in one run on the card.

Builds K6 (chol_blocked.cu) from an earlier tree's lbmpc_tpu_torch/csrc
(--parent DIR: an unpacked `git archive <commit>` of a tree whose K6 runs
one 256-thread block a lane on chol_body.cuh's slab form and takes no
launch shape, as before the redesign) beside the package's,
and the earlier K5 (chol.cu), K2w and K3w, whose shared header
(chol_body.cuh) this tree may have changed. It prints, per case, one JSON
line:
- ptxas' registers and spills of every build;
- K6a (L and x) and K6b (x) against the earlier K6, K5a / K5b and the plain
  version (ops/chol_kernel.cholesky_floor and its sweeps), bit for bit, and
  K5a/b/c against the earlier K5: on the KKT systems the xla route's IPM
  factors in its first and last iteration (chip_smoke.py phase 17's: the
  DMS flagship at n=101, B=1024 and the uncut LBMPC_N40 at n=41, B=2048),
  on seeded SPD systems at n in EDGE_N and B in EDGE_B, and on a batch
  holding a NaN lane and a lane whose pivots hit the floor (every other
  lane keeps its bits);
- the device time (chip_smoke.graph_ms: calls captured in a CUDA graph,
  replayed between CUDA events) of K6a and K6b in turns (parent, package,
  package, parent) at both IPM shapes, beside K5a and K5b (the same
  function), `cholesky_ex` + `cholesky_solve`, the bound and `package_host`
  (CUDA events around the calls, the host's enqueue included, as
  chip_smoke.cuda_ms reads them), with the package's warps a lane, lanes a
  block and an SM (`chol_blocked_resident_lanes`) and its shared memory
  held to the host's (`ops/chol_kernel.blocked_launch`);
- the split by phase of a lane (stage, panel, trailing update, L store,
  forward sweep, back sweep: mean cycles a lane and shares) at both
  shapes, for the earlier K6 (a copy of its sources with clock stamps,
  PARENT_CLOCKS) and for the package's built with -DK6_PHASE_CLOCKS, the
  latter also with one lane an SM (B = the SM count: a lane's own chain,
  no other lane's warps beside it);
- K2w's x, mu, s, z (DMS, 8 cold iterations, 2 warm) and K3w's e, d, mu, g
  (N40, 8 iterations) against the earlier ones, bit for bit.
--k6-shapes W:L,... also times the package's K6 at W warps a lane and L
lanes a block (the kernel takes the shape from the host), with its bits;
--k6-variants NAME:MACRO=V[+MACRO=V],... builds the package's K6 with
those macros and times each beside it, with its bits; --split-shape W:L
takes the one-lane-an-SM split at that shape; --no-wide skips K2w and K3w
(their builds take minutes). Needs one card; ~2.5 minutes (~1.5 with
--no-wide).

    python3 tools/k6_compare.py --parent DIR [--k6-shapes 2:4,4:2] [--k6-variants ...]
        [--split-shape 1:1] [--no-wide] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import shutil
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT / "tools") not in sys.path:
    sys.path.insert(0, str(ROOT / "tools"))

IPM_SHAPES = (("DMS_LBMPC_q100", 101, 1024), ("LBMPC_N40", 41, 2048))
EDGE_N = (25, 32, 33, 41, 64, 65, 101, 127, 128)
EDGE_B = (1, 3, 40, 1024)
PHASES = ("stage", "panel", "trailing", "store", "forward", "back")
# the package's build adds the panel warp's row loads and look-ahead, and
# the next warp's trailing updates (its own clock)
PACKAGE_PHASES = PHASES + ("apply", "trail_busy")
CLOCK_LANES = 16384     # the clock slots' lanes (csrc/chol_blocked.cu kClockLanes)

# Clock stamps for the earlier K6 (one 256-thread block a lane, chol_body.cuh
# chol::lane and factor_blocked): thread 0 of each block writes the cycles
# of each phase into PHASES' slots and the lane's total into the last. Each
# stamp follows a block barrier (the L store and each sweep get one added),
# so thread 0's clock is the block's there.
PARENT_CLOCKS = {
    "chol_body.cuh": [
        ("namespace chol {\n",
         "namespace chol {\n__device__ unsigned long long k6_parent_clocks[16384 * 7];\n"
         "__device__ __forceinline__ void k6_clk(int p, long long& last) {\n"
         "  __syncthreads();\n  const long long t = clock64();\n"
         "  if (threadIdx.x == 0 && blockIdx.x < 16384) k6_parent_clocks[blockIdx.x * 7 + p] += "
         "t - last;\n  last = t;\n}\n"),
        ("  const int warp = tid >> 5, lane = tid & 31;\n  for (int j0 = 0; j0 < n; j0 += kSlab) {\n",
         "  const int warp = tid >> 5, lane = tid & 31;\n  long long clk = clock64();\n"
         "  for (int j0 = 0; j0 < n; j0 += kSlab) {\n"),
        ("    __syncthreads();\n    // the trailing lower triangle: rows i >= j1, columns j1..i; each",
         "    k6_clk(1, clk);\n    // the trailing lower triangle: rows i >= j1, columns j1..i; each"),
        ("      A[i * n + k] = a;\n    }\n    __syncthreads();\n  }\n}\n",
         "      A[i * n + k] = a;\n    }\n    k6_clk(2, clk);\n  }\n}\n"),
        ("  const size_t lane_off = (size_t)blockIdx.x * n * n;\n",
         "  const size_t lane_off = (size_t)blockIdx.x * n * n;\n"
         "  if (tid == 0 && blockIdx.x < 16384)\n"
         "    for (int p = 0; p < 7; ++p) k6_parent_clocks[blockIdx.x * 7 + p] = 0;\n"
         "  const long long clk_first = clock64();\n  long long clk = clk_first;\n"),
        ("  __syncthreads();\n\n  if (kFactor) {\n",
         "  k6_clk(0, clk);\n\n  if (kFactor) {\n"),
        ("    else factor_cols(A, col, n);\n",
         "    else factor_cols(A, col, n);\n    clk = clock64();\n"),
        ("        L_out[lane_off + e] = k <= i ? A[e] : 0.0f;\n      }\n    }\n  }\n"
         "  solve(A, v, y, n);\n",
         "        L_out[lane_off + e] = k <= i ? A[e] : 0.0f;\n      }\n    }\n  }\n"
         "  k6_clk(3, clk);\n  solve(A, v, y, n);\n"
         "  if (tid == 0 && blockIdx.x < 16384)\n"
         "    k6_parent_clocks[blockIdx.x * 7 + 6] = clock64() - clk_first;\n"),
        ("  const int tid = threadIdx.x, T = blockDim.x;\n  // forward: L y = b, column by column\n",
         "  const int tid = threadIdx.x, T = blockDim.x;\n  long long clk = clock64();\n"
         "  // forward: L y = b, column by column\n"),
        ("  // back: L' x = y, column by column of L' (row j of L)\n",
         "  k6_clk(4, clk);\n  // back: L' x = y, column by column of L' (row j of L)\n"),
        ("    if (tid == 0) v[j] = xj;\n    __syncthreads();\n  }\n}\n",
         "    if (tid == 0) v[j] = xj;\n    __syncthreads();\n  }\n  k6_clk(5, clk);\n}\n"),
    ],
    "chol_blocked.cu": [
        ('extern "C" const char* chol_blocked_error_string(int code) {',
         'extern "C" int chol_blocked_clocks(unsigned long long* out, int lanes) {\n'
         '  return (int)cudaMemcpyFromSymbol(out, chol::k6_parent_clocks,\n'
         '                                   (size_t)lanes * 7 * sizeof(unsigned long long));\n'
         '}\n\nextern "C" const char* chol_blocked_error_string(int code) {'),
    ],
}


def parent_clocked_k6(csrc: pathlib.Path, argtypes):
    """The earlier K6 built from a copy of `csrc` (build/k6_parent_clocks)
    with PARENT_CLOCKS' stamps."""
    from lbmpc_tpu_torch.ops import _cuda

    d = ROOT / "build" / "k6_parent_clocks"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(csrc, d)
    for name, subs in PARENT_CLOCKS.items():
        text = (d / name).read_text()
        for a, b in subs:
            if text.count(a) != 1:
                raise ValueError(f"{name}: {a!r} found {text.count(a)} times, not once")
            text = text.replace(a, b)
        (d / name).write_text(text)
    k = _cuda.CudaKernel("chol_factor_solve_blocked", argtypes, source="chol_blocked")
    k.source = d / "chol_blocked.cu"
    return k


def read_clocks(k, lanes: int, phases=PHASES) -> dict:
    """The mean cycles a lane of each of `phases` and their shares, from
    kernel k's `chol_blocked_clocks` after its last launch."""
    import torch

    torch.cuda.synchronize()
    k.fn()
    read = ctypes.CDLL(str(k.library_path())).chol_blocked_clocks
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    lanes = min(lanes, CLOCK_LANES)
    buf = np.zeros((lanes, len(phases) + 1), np.uint64)
    if read(buf.ctypes.data, lanes) != 0:
        raise RuntimeError("chol_blocked_clocks failed")
    mean = buf.astype(np.float64).mean(axis=0)
    return {"cycles_per_lane": mean[-1],
            "share": {p: mean[i] / mean[-1] for i, p in enumerate(phases)},
            "cycles": {p: mean[i] for i, p in enumerate(phases)}}


def earlier_kernels(csrc: pathlib.Path) -> dict:
    """The earlier tree's K6a and K6b (one block a lane, no launch shape in
    the interface), K5a/b/c, K2w and K3w (the interfaces this tree keeps)."""
    from lbmpc_tpu_torch.ops import _cuda, chol_kernel, mono_kernel, qp_kernel

    P_, I_ = _cuda.P, _cuda.I
    specs = {"k6a": (chol_kernel.FACTOR_SOLVE_BLOCKED, [P_] * 4 + [I_] * 2 + [P_]),
             "k6b": (chol_kernel.SOLVE_BLOCKED, [P_] * 3 + [I_] * 2 + [P_]),
             "k5a": (chol_kernel.FACTOR_SOLVE, chol_kernel.FACTOR_SOLVE.argtypes),
             "k5b": (chol_kernel.SOLVE, chol_kernel.SOLVE.argtypes),
             "k5c": (chol_kernel.RESOLVE, chol_kernel.RESOLVE.argtypes),
             "k2w": (qp_kernel.KERNEL_WIDE, qp_kernel.KERNEL_WIDE.argtypes),
             "k3w": (mono_kernel.KERNEL_WIDE, mono_kernel.KERNEL_WIDE.argtypes)}
    out = {}
    for key, (k, args) in specs.items():
        c = _cuda.CudaKernel(k.name, args, flags=k.flags)
        c.source = csrc / k.source.name
        out[key] = c
    return out


def c_shape(k, kind: int, n: int, warps: int, lanes: int) -> tuple:
    """(the block's shared memory as chol_blocked.cu computes it, the lanes an
    SM holds) for kind 0 (K6a) or 1 (K6b) of the package's K6 library k."""
    k.fn()
    lib = ctypes.CDLL(str(k.library_path()))
    smem, res = lib.chol_blocked_smem_bytes, lib.chol_blocked_resident_lanes
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    res.argtypes, res.restype = [ctypes.c_int] * 4, ctypes.c_int
    return int(smem(n, warps, lanes)), int(res(kind, n, warps, lanes))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="an earlier tree (holding lbmpc_tpu_torch/csrc)")
    ap.add_argument("--k6-shapes", default="", help="comma-separated WARPS:LANES launch shapes")
    ap.add_argument("--k6-variants", default="", help="comma-separated NAME:MACRO=V[+MACRO=V]")
    ap.add_argument("--no-wide", action="store_true",
                    help="skip K2w and K3w (their builds take minutes)")
    ap.add_argument("--split-shape", default="",
                    help="WARPS:LANES for the split with one lane an SM (the host's by default)")
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k6_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import k1w_k5_compare
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.ops import _cuda, chol_kernel as ck, gn_kernel, mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import WidePlan, mehrotra_h, sm_count, step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = sm_count(dev)
    card = cs.card_line()
    print(card, flush=True)
    csrc_old = pathlib.Path(args.parent) / "lbmpc_tpu_torch" / "csrc"
    old = earlier_kernels(csrc_old)
    old_clocked = parent_clocked_k6(csrc_old, old["k6a"].argtypes)
    k6a, k6b = ck.FACTOR_SOLVE_BLOCKED, ck.SOLVE_BLOCKED
    shaped = hasattr(ck, "blocked_launch")     # the package's K6 takes its launch shape
    mk = lambda k, flags: _cuda.CudaKernel(k.name, k.argtypes, source="chol_blocked",
                                           flags=k.flags + flags)
    clocked = None
    if "K6_PHASE_CLOCKS" in k6a.source.read_text():
        clocked = {"a": mk(k6a, ("-DK6_PHASE_CLOCKS",)), "b": mk(k6b, ("-DK6_PHASE_CLOCKS",))}
    variants = {}
    for spec in [v for v in args.k6_variants.split(",") if v]:
        name, defs = spec.split(":")
        fl = tuple(f"-D{d}" for d in defs.split("+"))
        variants[name] = {"a": mk(k6a, fl), "b": mk(k6b, fl)}
    shapes = [tuple(int(x) for x in s.split(":")) for s in args.k6_shapes.split(",") if s]
    if args.no_wide:
        del old["k2w"], old["k3w"]
    builds = [k6a, ck.FACTOR_SOLVE, *old.values(), old_clocked,
              *(() if args.no_wide else (qp_kernel.KERNEL_WIDE, mono_kernel.KERNEL_WIDE)),
              *(clocked.values() if clocked else ()),
              *(k for v in variants.values() for k in v.values())]
    logs = _cuda.build_all(builds, verbose=True)
    lines = []

    def emit(case: dict) -> None:
        lines.append(case)
        print(json.dumps(case), flush=True)

    for name, text in logs.items():
        emit({"ptxas": name, "summary": k1w_k5_compare.ptxas_summary(text)})

    def same(a, b) -> bool:
        """Bit for bit, a NaN equal to a NaN in the same place."""
        return all(x.shape == y.shape and bool(((x == y) | (x.isnan() & y.isnan())).all())
                   for x, y in zip(a, b))

    def turns(fp, fk, reps: int = 20) -> dict:
        t = {tag: cs.graph_ms(fn, reps=reps) for tag, fn in
             (("parent", fp), ("package", fk), ("package2", fk), ("parent2", fp))}
        t["package_host"] = cs.cuda_ms(fk, reps=reps)
        return t

    p, I_ = _cuda.ptr, _cuda.I

    def run_old(key, A, b):
        B, n = b.shape
        x = torch.empty_like(b)
        if key == "k6a":
            L = torch.empty_like(A)
            old[key].launch(dev, p(A), p(b), p(L), p(x), I_(B), I_(n))
            return L, x
        if key == "k6b":
            old[key].launch(dev, p(A), p(b), p(x), I_(B), I_(n))
            return (x,)
        lanes = I_(ck.chol_launch(n, B, sms=sms)[0])
        if key == "k5a":
            L = torch.empty_like(A)
            old[key].launch(dev, p(A), p(b), p(L), p(x), I_(B), I_(n), lanes)
            return L, x
        old[key].launch(dev, p(A), p(b), p(x), I_(B), I_(n), lanes)
        return (x,)

    def run_k6(kind, A, b, shape=None, ks=None):
        """The package's K6a ("a") or K6b ("b") through the kernel k of `ks`
        (a variant or clocked build; the package's by default) at launch
        shape (warps, lanes), blocked_launch's when None."""
        B, n = b.shape
        k = (ks or {"a": k6a, "b": k6b})[kind]
        w, lanes = shape or ck.blocked_launch(n, B, sms=sms)[:2]
        x = torch.empty_like(b)
        if kind == "a":
            L = torch.empty_like(A)
            k.launch(dev, p(A), p(b), p(L), p(x), I_(B), I_(n), I_(w), I_(lanes))
            return L, x
        k.launch(dev, p(A), p(b), p(x), I_(B), I_(n), I_(w), I_(lanes))
        return (x,)

    def package(kind, A, b, **kw):
        if shaped:
            return run_k6(kind, A, b, **kw)
        if kind == "a":
            return ck.chol_factor_solve_blocked(A, b)
        return (ck.chol_solve_blocked(A, b),)

    def bits(M, b) -> dict:
        """K6 against the earlier K6, K5 and the plain version; K5 against
        the earlier K5."""
        L6, x6 = package("a", M, b)
        (xs6,) = package("b", M, b)
        L5, x5 = ck.chol_factor_solve(M, b)
        xs5 = ck.chol_solve(M, b)
        xr5 = ck.chol_resolve(L5, b)
        Lp, xp = ck.chol_factor_solve(M, b, plain=True)
        out = {"k6a_equals_parent": same((L6, x6), run_old("k6a", M, b)),
               "k6b_equals_parent": same((xs6,), run_old("k6b", M, b)),
               "k6a_equals_k5a": same((L6, x6), (L5, x5)),
               "k6b_equals_k5b": same((xs6,), (xs5,)),
               "k6_equals_plain": same((L6, x6, xs6), (Lp, xp, xp)),
               "k5_equals_parent": same((L5, x5, xs5, xr5), (*run_old("k5a", M, b),
                                                              *run_old("k5b", M, b),
                                                              *run_old("k5c", L5, b))),
               "k5c_resolves_k6a": same((ck.chol_resolve(L6, b),), (xr5,))}
        torch.cuda.synchronize()
        return out

    def spd(n: int, B: int, seed: int):
        """A seeded SPD system, equilibrated as the IPM's are (unit diagonal)."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        A = torch.randn(B, n, n, device=dev, generator=gen)
        M = A @ A.transpose(1, 2) + n * torch.eye(n, device=dev)
        dg = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2))
        M = (M * dg[:, :, None] * dg[:, None, :]).contiguous()
        return M, torch.randn(B, n, device=dev, generator=gen)

    # ---- the IPM's systems: bits, times, split ----------------------------------
    systems = {}
    for preset, n, B in IPM_SHAPES:
        cfg = lt.make_preset(preset)
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, sqp_iters=2,
                                                                  dtype="float32"))
        sc = build_scenario(cfg)
        assert sc.nz == n
        solve = make_lbmpc_solver_fused(
            sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family=cfg.family, delta=cfg.plant.ts,
            bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
            dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2, ipm_iters=cs.XLA_SCHED,
            alphas=cs.LADDER, device=dev)
        dx, win, _ = cs.family_inputs(3, B, cfg, n, dev)
        with cs.CholRecorder() as rec:
            solve(dx, win, torch.zeros(B, n, device=dev))
        systems[(n, B)] = {"ipm_first": rec.first, "ipm_last": rec.last}
        for data, (M, b) in systems[(n, B)].items():
            emit({"bits": "ipm", "data": data, "n": n, "B": B, **bits(M, b)})

    for (n, B), sy in systems.items():
        M, b = sy["ipm_last"]
        row = {"n": n, "B": B}
        if shaped:
            w, lanes, blocks, smem = ck.blocked_launch(n, B, sms=sms)
            c_smem, resident = c_shape(k6a, 0, n, w, lanes)
            row.update(warps_a_lane=w, lanes_a_block=lanes, blocks=blocks, smem=smem,
                       smem_matches_kernel=c_smem == smem, lanes_an_sm=resident)
        lib = lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky_ex(M)[0])
        for name, kind, k5 in (("chol_factor_solve_blocked", "a",
                                lambda: ck.chol_factor_solve(M, b)),
                               ("chol_solve_blocked", "b", lambda: ck.chol_solve(M, b))):
            t = turns(lambda: run_old("k6" + kind, M, b), lambda: package(kind, M, b))
            t["k5"] = cs.graph_ms(k5)
            # dense seeded systems of the same shape: no zeros among L's entries
            Mr, br = spd(n, B, 17 * n)
            t["package_spd"] = cs.graph_ms(lambda: package(kind, Mr, br))
            t["k5_spd"] = cs.graph_ms(lambda: (ck.chol_factor_solve if kind == "a"
                                               else ck.chol_solve)(Mr, br))
            t["library"] = cs.cuda_ms(lib, reps=5)
            bd = cs.bound_ms(*cs.chol_work(name.replace("_blocked", ""), B, n))
            emit({"kernel": name, **row, "ms": t, "bound_ms": bd[0], "bound_by": bd[1]})
        for w, lanes in shapes:
            res = {"shape": f"{w}:{lanes}", "n": n, "B": B}
            for kind in ("a", "b"):
                out = run_k6(kind, M, b, shape=(w, lanes))
                res[f"k6{kind}_bit_equal_package"] = same(out, package(kind, M, b))
                res[f"k6{kind}_ms"] = cs.graph_ms(lambda: run_k6(kind, M, b, shape=(w, lanes)))
            res["lanes_an_sm"] = c_shape(k6a, 0, n, w, lanes)[1]
            emit(res)
        for name, ks in variants.items():
            res = {"variant": name, "n": n, "B": B}
            for kind in ("a", "b"):
                out = run_k6(kind, M, b, ks=ks)
                res[f"k6{kind}_bit_equal_package"] = same(out, package(kind, M, b))
                res[f"k6{kind}_ms"] = cs.graph_ms(lambda: run_k6(kind, M, b, ks=ks))
            emit(res)
        run_old_clocked = lambda: old_clocked.launch(
            dev, p(M), p(b), p(torch.empty_like(M)), p(torch.empty_like(b)), I_(B), I_(n))
        run_old_clocked()
        emit({"split": "K6a", "build": "parent", "n": n, "B": B,
              **read_clocks(old_clocked, B)})
        if clocked:
            # at B and with one lane an SM (B = the SM count: a lane's chain alone)
            alone = (tuple(int(x) for x in args.split_shape.split(":"))
                     if args.split_shape else None)
            for Bc, shape in ((B, None), (sms, alone)):
                Mc, bc = M[:Bc].contiguous(), b[:Bc].contiguous()
                for kind in ("a", "b"):
                    run_k6(kind, Mc, bc, shape=shape, ks=clocked)
                    emit({"split": f"K6{kind}", "build": "package", "n": n, "B": Bc,
                          "shape": shape, **read_clocks(clocked[kind], Bc, PACKAGE_PHASES)})

    # ---- seeded systems over the domain, NaN and floored lanes -----------------
    for n in EDGE_N:
        for B in EDGE_B:
            M, b = spd(n, B, 1000 * n + B)
            res = bits(M, b)
            emit({"bits": "spd", "n": n, "B": B, "all": all(res.values()), **res})
        M, b = spd(n, 8, 7 * n)
        M[2, n - 1, n // 2] = float("nan")       # a NaN below the diagonal
        M[5] = -M[5]                             # every pivot hits the floor
        res = bits(M, b)
        emit({"bits": "nan_and_floor", "n": n, "B": 8, "all": all(res.values()), **res})

    # ---- K2w and K3w: the earlier bits (their header is chol_body.cuh) ---------
    def swap(mod, attr, k, fn):
        saved = getattr(mod, attr)
        setattr(mod, attr, k)
        try:
            return fn()
        finally:
            setattr(mod, attr, saved)

    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    for preset, nz, B in () if args.no_wide else (("DMS_LBMPC_q100", 101, 1024),
                                                  ("LBMPC_N40", 41, 2048)):
        cfg = lt.make_preset(preset)
        sc = build_scenario(cfg)
        gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family=cfg.family,
                     delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
                     ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), device=dev)
        dx, win, z = cs.family_inputs(3, B, cfg, nz, dev)
        G, h0, Hp = f(sc.qp.G), f(sc.qp.h0), f(sc.qp.Hp)
        _, H, g = gn(z, dx, win)
        h = step_rhs(h0, Hp, G, dx, z)
        plan = WidePlan(G)

        def k2w():
            r8 = mehrotra_h(G, H, g, h, 8, want_state=True, plan=plan)
            r2 = mehrotra_h(G, H, g, h, 2, warm=r8[2], want_state=True, plan=plan)
            return [r8[0], r8[1], *r8[2], r2[0], r2[1], *r2[2]]

        res = {"kernel": "K2w K3w", "preset": preset, "nz": nz, "B": B,
               "k2w_bit_equal_parent": same(k2w(), swap(qp_kernel, "KERNEL_WIDE", old["k2w"],
                                                        k2w))}
        if G.shape[0] <= qp_kernel.MI_MAX:
            mono = MonoPhase(gn, G, h0, Hp, 8)
            if mono.wide:
                res["k3w_bit_equal_parent"] = same(
                    mono(z, dx, win),
                    swap(mono_kernel, "KERNEL_WIDE", old["k3w"], lambda: mono(z, dx, win)))
        torch.cuda.synchronize()
        emit(res)
    import k2w_split

    emit({"sm_clock": k2w_split.sm_clock()})

    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for c in lines:
                fh.write(json.dumps({**c, "card": card}) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
