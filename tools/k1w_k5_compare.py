#!/usr/bin/env python3
"""K1w and K5 against an earlier tree's, in one session on the card.

Builds K1w (gn_wide.cu) and K5a/K5b/K5c (chol.cu) from an earlier tree's
lbmpc_tpu_torch/csrc (--parent DIR: an unpacked `git archive <commit>`),
whose kernels run one block a lane and take no lane count, beside the
package's; also the earlier K2w and K3w, whose headers this tree changed
(K2w's factorization and sweeps moved into chol_body.cuh). It prints, per
case, one JSON line:
- ptxas' registers and spills of every build, and the lanes a block and an
  SM of each timed shape (CUDA's occupancy calculator, `*_resident_lanes`);
- K1w's e, H and g against the earlier K1w, bit for bit, at nz 33, 41, 64,
  65, 101 and 128 in both families (LBMPC_N40 and the DMS preset at
  N = nz - 1, q=100, seeded inputs), and against the plain version (its
  largest difference over max|H|);
- K1w's device time (chip_smoke.graph_ms: calls captured in a CUDA graph,
  replayed between CUDA events) in turns (parent, package, package, parent)
  at N40 (fmincon, nz=41) B = 8192, 2048 and 24 and at the DMS flagship
  (casadi, nz=101) B = 1024, 2048 and 4096 (the last two show whether one
  warp a lane leaves the card short of warps at 1024), with its bound;
- K5a, K5b and K5c against the earlier ones and their plain versions, bit
  for bit (L and x), and their times in turns at n=21 B = 8192 and 2048 and
  at n=101 B = 1024, beside `cholesky_ex` + `cholesky_solve` (K5c:
  `cholesky_solve`) and the bound; on seeded random SPD systems and on the
  ones the xla route's IPM factors in its last iteration (bits also on its
  first: chip_smoke.py phase 7's systems);
- K2w's x, mu, s and z (8 and 16 cold iterations, 2 warm) and K3w's e, d,
  mu and g (16 iterations) against the earlier ones at N40 and the DMS
  flagship, bit for bit, and K2w's time in turns (N40 8 cold iterations,
  DMS 16; CUDA events around the calls);
- K1w's split by phase of a stage (a build with -DK1W_PHASE_CLOCKS: the
  NW sums with their reductions, the quotients and Jg, the Jacobian rows,
  the H update, the state update, and the terminal rows with the store) at
  the first batch of each timed shape, and the earlier K1w's (a copy of
  its sources with clock stamps, PARENT_CLOCKS).
K1w's and K5's times also carry `package_host`: CUDA events around the
calls themselves, the host's enqueue included, as chip_smoke.cuda_ms reads
them.
--k1w-variants NAME:MACRO=V[+MACRO=V],... also builds K1w with those
macros (e.g. gn_wide.cu's K1W_MIN_BLOCKS=2) for each variant, checks its
bits against the package's and times it beside it.
Needs one card.

    python3 tools/k1w_k5_compare.py --parent DIR [--k1w-variants mb2:K1W_MIN_BLOCKS=2] [--out FILE]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import pathlib
import re
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent

K1W_NZ = (33, 41, 64, 65, 101, 128)
K1W_TIMED = (("fmincon", 41, (8192, 2048, 24)), ("casadi", 101, (1024, 2048, 4096)))
K5_TIMED = ((21, (8192, 2048)), (101, (1024,)))
# csrc/gn_wide.cu ClockPhase: the phases of a stage, the terminal rows and
# the store, and the lane's total
PHASES = ("nw_sums", "solve", "rows", "h_update", "state", "end", "total")


def ptxas_summary(log: str) -> str:
    """Each kernel instance's registers and spilled bytes from `nvcc -Xptxas
    -v` output: "name<template args>: R registers, S B spilled; ..."."""
    out, name, spill = [], None, 0
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name, spill = m.group(1), 0
            k = re.search(r"\d([a-z_]+_kernel)I((?:L[bi]\d+E)+)", name)
            if k:
                name = f"{k.group(1)}<{','.join(re.findall(r'L[bi](\d+)E', k.group(2)))}>"
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {spill} B spilled")
            name = None
    return "; ".join(out)


def _lib(k):
    k.fn()
    return ctypes.CDLL(str(k.library_path()))


def k1w_shape(k, nz: int, q: int, lanes: int, casadi: bool) -> tuple:
    """(the block's shared memory as gn_wide.cu computes it, the lanes an SM
    holds) for the package's K1w library `k`."""
    lib = _lib(k)
    smem, res = lib.gn_wide_smem_bytes, lib.gn_wide_resident_lanes
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    res.argtypes, res.restype = [ctypes.c_int] * 4, ctypes.c_int
    return int(smem(nz, q, lanes)), int(res(nz, q, lanes, int(casadi)))


def k5_shape(k, kind: int, n: int, lanes: int) -> tuple:
    """(the block's shared memory as chol.cu computes it, the lanes an SM
    holds) for kind 0 (K5a), 1 (K5b), 2 (K5c) of the package's library."""
    lib = _lib(k)
    smem, res = lib.chol_smem_bytes, lib.chol_resident_lanes
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    res.argtypes, res.restype = [ctypes.c_int] * 3, ctypes.c_int
    return int(smem(n, lanes)), int(res(kind, n, lanes))


def earlier_kernels(csrc: pathlib.Path) -> dict:
    """The earlier tree's K1w, K5a/b/c (one block a lane, no lane count in
    the interface), K2w and K3w (the interfaces this tree keeps)."""
    from lbmpc_tpu_torch.ops import _cuda, chol_kernel, gn_kernel, mono_kernel, qp_kernel

    P_, I_ = _cuda.P, _cuda.I
    specs = {"k1w": (gn_kernel.KERNEL_WIDE, [P_] * 9 + [I_] * 4 + [P_]),
             "k5a": (chol_kernel.FACTOR_SOLVE, [P_] * 4 + [I_] * 2 + [P_]),
             "k5b": (chol_kernel.SOLVE, [P_] * 3 + [I_] * 2 + [P_]),
             "k5c": (chol_kernel.RESOLVE, [P_] * 3 + [I_] * 2 + [P_]),
             "k2w": (qp_kernel.KERNEL_WIDE, qp_kernel.KERNEL_WIDE.argtypes),
             "k3w": (mono_kernel.KERNEL_WIDE, mono_kernel.KERNEL_WIDE.argtypes)}
    out = {}
    for key, (k, args) in specs.items():
        c = _cuda.CudaKernel(k.name, args, flags=k.flags)
        c.source = csrc / k.source.name
        out[key] = c
    return out


# Clock stamps for the earlier K1w (one block a lane, gn_wide_body.cuh's
# gnw::lane): thread 0 of each block adds the cycles of each phase of a
# stage into the same 7 slots as gn_wide.cu's K1W_PHASE_CLOCKS build. The
# block barriers that end the NW sums and the Jacobian rows keep thread 0's
# clock the block's there; the H update is thread 0's own (column 0 is
# causal at every stage, so it updates as many rows as any thread), and
# the terminal slot excludes the H store that follows gnw::lane.
PARENT_CLOCKS = {
    "gn_wide_body.cuh": [
        ('#include "gn_body.cuh"\n',
         '#include "gn_body.cuh"\n__device__ unsigned long long k1w_parent_clocks[16384 * 7];\n'),
        ("  const bool col = c < nz;\n",
         "  const bool col = c < nz;\n"
         "  long long clk_last = clock64(), clk_first = clk_last;\n"
         "  unsigned long long clk_acc[7] = {0, 0, 0, 0, 0, 0, 0};\n"
         "#define K1W_CLK(p) if (threadIdx.x == 0) { const long long t_ = clock64(); "
         "clk_acc[p] += t_ - clk_last; clk_last = t_; }\n"),
        ("      acc[i] = v;\n    }\n", "      acc[i] = v;\n    }\n    K1W_CLK(0);\n"),
        ("(acc[8 + 3 * o + d] / denom - yhat[o] * s1[d]);\n    }\n",
         "(acc[8 + 3 * o + d] / denom - yhat[o] * s1[d]);\n    }\n    K1W_CLK(1);\n"),
        ("        if (col) D[r * kNzMax + c] = Dr[r];\n      }\n      __syncthreads();\n",
         "        if (col) D[r * kNzMax + c] = Dr[r];\n      }\n      __syncthreads();\n"
         "      K1W_CLK(2);\n"),
        ("add_outer<R>(sh, D, Dc, c, nz, N, hi, false);\n",
         "add_outer<R>(sh, D, Dc, c, nz, N, hi, false);\n      K1W_CLK(3);\n"),
        ("      S[i] = Sn[i];\n    }\n", "      S[i] = Sn[i];\n    }\n    K1W_CLK(4);\n"),
        ("  return gacc;\n}",
         "  K1W_CLK(5);\n  if (threadIdx.x == 0 && blockIdx.x < 16384) {\n"
         "    clk_acc[6] = clock64() - clk_first;\n"
         "    for (int p_ = 0; p_ < 7; ++p_) k1w_parent_clocks[blockIdx.x * 7 + p_] = clk_acc[p_];\n"
         "  }\n  return gacc;\n}"),
    ],
    "gn_wide.cu": [
        ('extern "C" const char* gn_wide_error_string(int code) {',
         'extern "C" int gn_wide_clocks(unsigned long long* out, int lanes) {\n'
         '  return (int)cudaMemcpyFromSymbol(out, k1w_parent_clocks,\n'
         '                                   (size_t)lanes * 7 * sizeof(unsigned long long));\n'
         '}\n\nextern "C" const char* gn_wide_error_string(int code) {'),
    ],
}


def parent_clocked_k1w(csrc: pathlib.Path, argtypes, flags):
    """The earlier K1w built from a copy of `csrc` (build/k1w_parent_clocks)
    with PARENT_CLOCKS' stamps."""
    import shutil

    from lbmpc_tpu_torch.ops import _cuda

    d = ROOT / "build" / "k1w_parent_clocks"
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
    k = _cuda.CudaKernel("gn_wide", argtypes, flags=flags)
    k.source = d / "gn_wide.cu"
    return k


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="an earlier tree (holding lbmpc_tpu_torch/csrc)")
    ap.add_argument("--k1w-variants", default="",
                    help="comma-separated NAME:MACRO=V[+MACRO=V] K1w builds")
    ap.add_argument("--out", default="", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1w_k5_compare: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops import _cuda, chol_kernel, gn_kernel, mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.chol_kernel import chol_launch
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase, wide_launch
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import WidePlan, mehrotra_h, sm_count, step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    sms = sm_count(dev)
    card = cs.card_line()
    print(card, flush=True)
    old = earlier_kernels(pathlib.Path(args.parent) / "lbmpc_tpu_torch" / "csrc")
    package = {"k1w": gn_kernel.KERNEL_WIDE, "k5": chol_kernel.FACTOR_SOLVE,
               "k2w": qp_kernel.KERNEL_WIDE, "k3w": mono_kernel.KERNEL_WIDE}
    k = gn_kernel.KERNEL_WIDE
    clocked = _cuda.CudaKernel(k.name, k.argtypes, flags=k.flags + ("-DK1W_PHASE_CLOCKS",))
    old_clocked = parent_clocked_k1w(pathlib.Path(args.parent) / "lbmpc_tpu_torch" / "csrc",
                                     old["k1w"].argtypes, old["k1w"].flags)
    variants = {}
    for spec in [v for v in args.k1w_variants.split(",") if v]:
        name, defs = spec.split(":")
        variants[name] = _cuda.CudaKernel(
            k.name, k.argtypes, flags=k.flags + tuple(f"-D{d}" for d in defs.split("+")))
    logs = _cuda.build_all([*package.values(), *old.values(), *variants.values(), clocked,
                            old_clocked], verbose=True)
    lines = []

    def emit(case: dict) -> None:
        lines.append(case)
        print(json.dumps(case), flush=True)

    for name, text in logs.items():
        emit({"ptxas": name, "summary": ptxas_summary(text)})

    def same(a, b) -> bool:
        return all(bool(torch.equal(x, y)) for x, y in zip(a, b))

    def turns(fp, fk, reps: int, timer=cs.graph_ms) -> dict:
        t = {tag: timer(fn, reps=reps) for tag, fn in
             (("parent", fp), ("package", fk), ("package2", fk), ("parent2", fp))}
        t["package_host"] = cs.cuda_ms(fk, reps=reps)
        return t

    def swap(mod, attr, k, fn):
        saved = getattr(mod, attr)
        setattr(mod, attr, k)
        try:
            return fn()
        finally:
            setattr(mod, attr, saved)

    # ---- K1w ------------------------------------------------------------------
    scen = {}

    def setup(family: str, nz: int):
        if (family, nz) not in scen:
            cfg = lt.make_preset("LBMPC_N40" if family == "fmincon" else "DMS_LBMPC_q100")
            cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=nz - 1))
            sc = build_scenario(cfg)
            gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family=family,
                         delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
                         ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), device=dev)
            scen[(family, nz)] = (cfg, sc, gn)
        return scen[(family, nz)]

    def run_old_k1w(gn, z, dx, win, k=None):
        B, q = z.shape[0], win.X.shape[-2]
        f32 = dict(dtype=torch.float32, device=dev)
        e = torch.empty(B, gn.ne, **f32)
        H = torch.empty(B, gn.nz, gn.nz, **f32)
        g = torch.empty(B, gn.nz, **f32)
        p = _cuda.ptr
        (k or old["k1w"]).launch(dev, p(gn.cst), p(z), p(dx), p(win.X), p(win.Y), p(win.valid),
                                 p(e), p(H), p(g), _cuda.I(B), _cuda.I(gn.N), _cuda.I(q),
                                 _cuda.I(int(gn.family == "casadi")))
        return e, H, g

    def inputs(cfg, nz: int, B: int, seed: int):
        dx, win, z = cs.family_inputs(seed, B, cfg, nz, dev)
        return z, dx, win

    for family in ("fmincon", "casadi"):
        for nz in K1W_NZ:
            cfg, sc, gn = setup(family, nz)
            ins = inputs(cfg, nz, 96, seed=nz)
            new = gn(*ins)
            ref = run_old_k1w(gn, *ins)
            ep, Hp, gp = gn.plain(*ins)
            torch.cuda.synchronize()
            hmax = Hp.abs().max().item()
            err = max((a - b).abs().max().item() for a, b in zip(new, (ep, Hp, gp)))
            emit({"kernel": "K1w", "family": family, "nz": nz, "B": 96,
                  "bit_equal_parent": same(new, ref),
                  "variants_bit_equal": {name: same(new, swap(gn_kernel, "KERNEL_WIDE", k,
                                                              lambda: gn(*ins)))
                                         for name, k in variants.items()},
                  "H_symmetric": bool(torch.equal(new[1], new[1].transpose(1, 2))),
                  "vs_plain_over_max_H": err / hmax})

    for family, nz, batches in K1W_TIMED:
        cfg, sc, gn = setup(family, nz)
        big = inputs(cfg, nz, max(batches), seed=7)
        q = big[2].X.shape[-2]
        for B in batches:
            idx = torch.arange(B, device=dev)
            ins = (big[0][:B].contiguous(), big[1][:B].contiguous(), big[2].index(idx))
            t = turns(lambda: run_old_k1w(gn, *ins), lambda: gn(*ins), reps=10)
            for name, k in variants.items():
                t[name] = swap(gn_kernel, "KERNEL_WIDE", k,
                               lambda: cs.graph_ms(lambda: gn(*ins), reps=10))
            lanes, blocks, smem = wide_launch(nz, q, B, sms=sms)
            c_smem, resident = k1w_shape(gn_kernel.KERNEL_WIDE, nz, q, lanes, family == "casadi")
            ne = gn.ne
            bd = cs.bound_ms(*cs.gn_work(B, nz - 1, q, ne, nz, gn.cst.numel()))
            emit({"kernel": "K1w", "family": family, "nz": nz, "B": B, "ms": t,
                  "bound_ms": bd[0], "bound_by": bd[1], "lanes_a_block": lanes,
                  "blocks": blocks, "smem": smem, "smem_matches_kernel": c_smem == smem,
                  "lanes_an_sm": resident})

    # ---- K1w's split by phase (the clocked build) -------------------------------
    for tag, k in (("package", clocked), ("parent", old_clocked)):
        read = getattr(_lib(k), "gn_wide_clocks")
        read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
        for family, nz, batches in K1W_TIMED:
            cfg, sc, gn = setup(family, nz)
            B = batches[0]
            z, dx, win = inputs(cfg, nz, B, seed=7)
            if tag == "package":
                swap(gn_kernel, "KERNEL_WIDE", k, lambda: gn(z, dx, win))
            else:
                run_old_k1w(gn, z, dx, win, k=k)
            torch.cuda.synchronize()
            lanes = min(B, 16384)
            buf = np.zeros((lanes, len(PHASES)), np.uint64)
            if read(buf.ctypes.data, lanes) != 0:
                raise RuntimeError("gn_wide_clocks failed")
            mean = buf.astype(np.float64).mean(axis=0)
            emit({"split": "K1w", "build": tag, "family": family, "nz": nz, "B": B,
                  "share": {p: mean[i] / mean[-1] for i, p in enumerate(PHASES[:-1])},
                  "cycles_per_stage": mean[-1] / (nz - 1)})

    # ---- K5 -------------------------------------------------------------------
    def run_old_k5(key, A, b):
        B, n = b.shape
        x = torch.empty_like(b)
        p, I_ = _cuda.ptr, _cuda.I
        if key == "k5a":
            L = torch.empty_like(A)
            old[key].launch(dev, p(A), p(b), p(L), p(x), I_(B), I_(n))
            return L, x
        old[key].launch(dev, p(A), p(b), p(x), I_(B), I_(n))
        return x

    def ipm_systems(n: int, B: int) -> dict:
        """The equilibrated KKT systems (M, b) that the xla route's IPM hands
        K5a in its first and last iteration of one solve (chip_smoke.py
        phase 7's): the N=20 bench at n=21, the DMS flagship at n=101."""
        from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused

        name = "LBMPC_N40" if n == 21 else "DMS_LBMPC_q100"
        cfg = lt.make_preset(name)
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, sqp_iters=2,
                                                                  dtype="float32"))
        if n == 21:
            cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=cs.N),
                                      oracle=dataclasses.replace(cfg.oracle, q=cs.Q))
        sc = build_scenario(cfg)
        solve = make_lbmpc_solver_fused(
            sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family=cfg.family, delta=cfg.plant.ts,
            bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
            dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2, ipm_iters=cs.XLA_SCHED,
            alphas=cs.LADDER, device=dev)
        dx, win, _ = cs.family_inputs(4, B, cfg, sc.nz, dev)
        with cs.CholRecorder() as rec:
            solve(dx, win, torch.zeros(B, sc.nz, device=dev))
        return {"ipm_first": rec.first, "ipm_last": rec.last}

    def random_system(n: int, B: int) -> tuple:
        """A seeded SPD system, equilibrated as the IPM's are (unit diagonal)."""
        rng = np.random.default_rng(n)
        A = torch.as_tensor(rng.standard_normal((B, n, n)).astype(np.float32), device=dev)
        M = A @ A.transpose(1, 2) + n * torch.eye(n, device=dev)
        dg = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2))
        b = torch.as_tensor(rng.standard_normal((B, n)).astype(np.float32), device=dev)
        return (M * dg[:, :, None] * dg[:, None, :]).contiguous(), b

    for n, batches in K5_TIMED:
        systems = {"random": random_system(n, max(batches)), **ipm_systems(n, max(batches))}
        for data, (M_all, b_all) in systems.items():
            for B in batches:
                M, b = M_all[:B].contiguous(), b_all[:B].contiguous()
                L, x = chol_kernel.chol_factor_solve(M, b)
                xs = chol_kernel.chol_solve(M, b)
                xr = chol_kernel.chol_resolve(L, b)
                Lo, xo = run_old_k5("k5a", M, b)
                xso, xro = run_old_k5("k5b", M, b), run_old_k5("k5c", L, b)
                Lp, xp = chol_kernel.chol_factor_solve(M, b, plain=True)
                torch.cuda.synchronize()
                bits = {"chol_factor_solve": same((L, x), (Lo, xo)) and same((L, x), (Lp, xp)),
                        "chol_solve": same((xs,), (xso,)) and same((xs,), (xp,)),
                        "chol_resolve": same((xr,), (xro,))
                        and same((xr,), (chol_kernel.chol_resolve(Lp, b, plain=True),))}
                if data == "ipm_first":
                    emit({"kernel": "K5", "data": data, "n": n, "B": B,
                          "bit_equal_parent_and_plain": bits})
                    continue
                Lx = torch.linalg.cholesky_ex(M)[0]
                lib_fs = lambda: torch.cholesky_solve(b[..., None],
                                                      torch.linalg.cholesky_ex(M)[0])
                cases = {"chol_factor_solve": (lambda: run_old_k5("k5a", M, b),
                                               lambda: chol_kernel.chol_factor_solve(M, b),
                                               lib_fs, 0),
                         "chol_solve": (lambda: run_old_k5("k5b", M, b),
                                        lambda: chol_kernel.chol_solve(M, b), lib_fs, 1),
                         "chol_resolve": (lambda: run_old_k5("k5c", L, b),
                                          lambda: chol_kernel.chol_resolve(L, b),
                                          lambda: torch.cholesky_solve(b[..., None], Lx), 2)}
                lanes, blocks, smem = chol_launch(n, B, sms=sms)
                for name, (fp, fk, fl, kind) in cases.items():
                    t = turns(fp, fk, reps=20)
                    t["library"] = cs.cuda_ms(fl, reps=5)
                    c_smem, resident = k5_shape(package["k5"], kind, n, lanes)
                    bd = cs.bound_ms(*cs.chol_work(name, B, n))
                    emit({"kernel": name, "data": data, "n": n, "B": B, "ms": t,
                          "bound_ms": bd[0], "bound_by": bd[1],
                          "bit_equal_parent_and_plain": bits[name], "lanes_a_block": lanes,
                          "blocks": blocks, "smem": smem, "smem_matches_kernel": c_smem == smem,
                          "lanes_an_sm": resident})

    # ---- K2w and K3w: the earlier bits -----------------------------------------
    for family, nz, B in (("fmincon", 41, 8192), ("casadi", 101, 1024)):
        cfg, sc, gn = setup(family, nz)
        z, dx, win = inputs(cfg, nz, B, seed=3)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        G, h0, Hp = t(sc.qp.G), t(sc.qp.h0), t(sc.qp.Hp)
        _, H, g = gn(z, dx, win)
        h = step_rhs(h0, Hp, G, dx, z)
        plan = WidePlan(G)
        out = {}
        for tag, k in (("package", package["k2w"]), ("parent", old["k2w"])):
            def solve(k=k):
                r8 = mehrotra_h(G, H, g, h, 8, want_state=True, plan=plan)
                r16 = mehrotra_h(G, H, g, h, 16, want_state=True, plan=plan)
                r2 = mehrotra_h(G, H, g, h, 2, warm=r8[2], want_state=True, plan=plan)
                return [r[0] for r in (r8, r16, r2)] + [r[1] for r in (r8, r16, r2)] + [
                    s for r in (r8, r16, r2) for s in r[2]]
            out[tag] = swap(qp_kernel, "KERNEL_WIDE", k, solve)
        it = 16 if family == "casadi" else 8
        cold = lambda: mehrotra_h(G, H, g, h, it, want_state=True, plan=plan)
        res = {"kernel": "K2w", "family": family, "nz": nz, "B": B,
               "bit_equal_parent": same(out["package"], out["parent"]),
               "iters": it, "ms": turns(lambda: swap(qp_kernel, "KERNEL_WIDE", old["k2w"], cold),
                                        cold, reps=3, timer=cs.cuda_ms)}
        if G.shape[0] <= qp_kernel.MI_MAX:
            mono = MonoPhase(gn, G, h0, Hp, 16)
            if mono.wide:
                m_new = mono(z, dx, win)
                m_old = swap(mono_kernel, "KERNEL_WIDE", old["k3w"], lambda: mono(z, dx, win))
                res["k3w_bit_equal_parent"] = same(m_new, m_old)
        torch.cuda.synchronize()
        emit(res)

    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as fh:
            for c in lines:
                fh.write(json.dumps({**c, "card": card}) + "\n")
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
