#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (lbmpc_tpu_torch) on one NVIDIA GPU.

Builds the CUDA kernels from lbmpc_tpu_torch/csrc/ with nvcc (sm_90a, one
nvcc per source, all at once) and holds each against its plain PyTorch
version at its path's shapes. Then it drives two paths, each with the launch
counts set to 0 just before it and read just after:
- the kernel route (qp_kernel="pallas_full", K1 gn_phase + K2 mehrotra_h):
  the fused and hybrid solves at batch 2048 and the warm-chain hybrid fleet
  at a cohort of 8192 (N=20, q=100 — the bench configuration of bench.py);
- the default xla route (ops/ipm_fused on K5a chol_factor_solve, K5b
  chol_solve, K5c chol_resolve): the fused solve at batch 2048, the DMS
  flagship (casadi, N=100, q=100, nz=101) at batch 1024 with L stored and
  with LBMPC_CHOL_STORE=0, and the default fused fleet at the cohort;
- the pallas_mono route (K3 gn_mehrotra, one launch per GN iteration) and
  the pallas route (the plain GN phase + K2): the fused solves at batch
  2048, the pallas_mono fused fleet and the pallas warm-chain fused fleet at
  the cohort; and the shared-H QP solver (K4 mehrotra) on the N=20 LMPC QP
  at the cohort;
- the routes above nz 32: the slab-blocked Cholesky (K6a
  chol_factor_solve_blocked, K6b chol_solve_blocked) behind
  LBMPC_CHOL_BLOCKED=1 on the DMS flagship's xla route, bit for bit equal to
  K5; the DMS flagship on pallas_full (K1w gn_wide + K2w mehrotra_h_wide),
  pallas (the plain GN phase + K2w) and the pallas_full warm chain at batch
  1024; and the uncut LBMPC_N40 (N=40, nz=41) warm-chain hybrid fleet on
  pallas_full at the cohort;
- pallas_mono above nz 32 and for the casadi family (K3w gn_mehrotra_wide,
  bit for bit equal to K1w then K2w): the N40 solve at batch 2048 and the
  N40 hybrid fleet at the cohort as the reference builds it (the vmapped
  repair: the per-problem SQP on ops/ipm); the N=20 hybrid fleets on the xla
  and pallas_mono routes with that repair; the deferred-repair fleet solver
  (make_lbmpc_solver_fleet); and the golden trajectories of the reference
  MATLAB runs (tests/golden): the float32 pallas_mono hybrid and the float64
  per-problem episodes at N=50;
- the NMPC family (controllers/nmpc on ops/ipm and torch.linalg, float64,
  each solve replayed from a CUDA graph; no kernel): the NMPC goldens at
  the reference's tier-1 lengths (NMPC_N50 and NMPC_N40, the casadi NMPC at
  N=100, REG_NMPC, REG_LMPC, the collocation NMPC against the RK4 NMPC) and
  an NMPC_N50 batch of 1024 closed loops; then the reference's
  shipping-backend golden configuration (the float32 pallas_full hybrid
  with the fused repair at LBMPC_N50, K1w + K2w, 300 steps);
- the stage-wise Riccati backends (ops/riccati, ops/sparse_ipm,
  ops/sparse_gn; plain torch, no kernel; each solve replayed from a CUDA
  graph): the sparse LMPC at DMS_LMPC's N=50 and batch 1024 on
  `sparse` and `sparse_parallel` in float64 and float32, the sparse LBMPC at
  the DMS flagship's full width (N=100, q=100) at batch 1024 with the
  reference's sqp 2, ipm 16, and 64-lane closed loops on each sparse
  backend against the condensed one; the sparse_parallel memory guard's
  model against the allocator's peak;
- the port's tooling (runtime/profiling, runtime/checkpoint, analysis,
  controllers/tracking_sandbox): the fused solve at the bench configuration
  on pallas_full and xla timed by the solve-time protocol against the 10 ms
  budget, traced (the kernels' device time under their names, held to the
  launch counters) and set against the H100 roofline; checkpoint and resume
  of LBMPC_N40 at full width (a batch of 256 and one lane, resumed equal
  to uninterrupted within 1e-12) and the per-problem stack's lane bits in
  float64 and float32 (a lane of a batch of B equals its solve alone, bit
  for bit, at B from 1 to 8192); the tracking sandbox's episodes on the
  card against the CPU, and response_info on the card against the CPU;
- the multi-device layer (runtime/sharding, ops/riccati_sharded; no kernel
  of its own): the bench fused solve split over two shards of the card
  against the whole one (K1 and K2 a shard; bit for bit),
  the hybrid with its flagged lanes in one shard, fleet_runner cohorts and
  global_solve_stats; an NCCL group of world size 1 in this process and two
  gloo processes sharing the card, each running global_solve_stats and
  lqr_cross_sharded; the stage split at N=304, the DMS flagship's sparse GN
  at N=300 over 8 stage shards, and phase 38's batch resumed over the mesh
  (bit for bit phase 38's unsplit run);
  the port's entry and examples; the fused solver's refine=True (one
  more K5c an IPM iteration), LBMPC_CHOL=xla (no K5) and jac_mode="jacfwd";
  and the reference's own float32 fleet split (tests/test_runtime.py's
  fleet_runner case: 64 lanes in cohorts of 16 over 8 shards and over 4,
  equal to the direct call within 1e-6 and bit for bit).
It times the kernels, their plain versions, the library yardsticks, the
solves and the fleet steps with CUDA events (K2 and K3 at batch 2048, the
cohort and the repair's K, with their registers, spills and lanes an SM;
K1, K1w, K4, K5 and K6 by CUDA graph replay, their device time, K1, K4 and
K6 with the host-clocked reading beside it and their lanes a block and an
SM, K6 also its warps a lane),
prints K2's, K3's, K2w's and K3w's time split by phase of a Mehrotra
iteration (phases 6, 16, 23 and 24, from the phase-clock builds of
tools/k2_split.py and tools/k2w_split.py), holds K2's lanes to the same bits
wherever a QP sits in the batch (phase 3), and holds the golden episode's 8
identical lanes identical for all its steps (phase 29).

    python3 chip_smoke.py                 # every phase (needs one card)
    python3 chip_smoke.py --stop-after 3  # build + K1/K2 checks only
    python3 chip_smoke.py --profile       # + device traces of 3 steps of each fleet

Exits non-zero, and prints no result, without CUDA or outside a checkout
of the repository; any failed phase raises. The last line of standard output
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12        # H100 SXM HBM3
N, Q, BATCH, COHORT, STEPS = 20, 100, 2048, 8192, 20
LADDER = ((1.0,), (1.0, 0.5, 0.25))
IPM_SCHED = (8, 2)
REPAIR_K = 24
XLA_SCHED = (16, 8)          # the xla route's IPM schedule (bench_dms_flagship.py:118)
DMS_BATCH = 1024
K4_OPT_ITERS = 60            # the float64 solve K4 and its plain version are held to
DMS_MONO_N = 60              # the DMS preset cut to where the reference's mono kernel fits
GOLDEN_B, GOLDEN_F32_STEPS, GOLDEN_F64_STEPS = 8, 300, 100
SHIPPING_STEPS = 300         # the reference's shipping-backend test (test_parity.py:229)
GOLDEN_F32_HELD = 40         # the steps the float32 hybrid is held to the golden envelope
NMPC_BATCH, NMPC_BATCH_STEPS = 1024, 10
SPARSE_BATCH = 1024           # the sparse LMPC's batch (phase 34)
SPARSE_LOOP_LANES, SPARSE_LOOP_STEPS = 64, 4
CK_BATCH, CK_STEPS = 256, 20  # phase 38's checkpointed batch and steps
LANE_BITS_B = (1, 2, 3, 4, 8, 16, 128, 256, 1000, 1024, 2048, 8192)   # phase 38's sweep
PROTOCOL_RUNS, PROTOCOL_ITERS = 5, 20   # phase 37's solve_time_protocol
KERNELS_PHASE = 33            # the kernels line, printed last
LAST_PHASE = 45


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what: str) -> None:
    """A gate: log it, and stop the script (exit 1) when it fails."""
    log(f"  check {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_call(fn):
    """(fn(), its ms) by CUDA events around one call (the host's enqueue
    included)."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def graph_ms(fn, reps: int = 20) -> float:
    """The device time of one call of fn: `reps` calls captured in a CUDA
    graph, the graph replayed between two CUDA events. cuda_ms times the
    host's enqueue as well, which for a kernel of tens of microseconds is
    most of what it reads."""
    import torch

    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def gn_work(B: int, N_: int, q: int, ne: int, nz: int, n_const: int):
    """(bytes, float32 operations) the GN phase must move and do: inputs
    read once, outputs written once; per window point and stage 50
    operations (distance, exp counted as one, 20 running sums), the
    sensitivity update, and the unique entries of 2J'J and 2J'e."""
    n = 4
    by = 4 * (B * nz + B * n + B * q * 8 + n_const + B * (ne + nz * nz + nz))
    per_stage = 50 * q + n * nz * 16 + (n + 1) * nz * 2 * n
    rows = (N_ - 2) * (n + 1) + n
    fl = B * (N_ * per_stage + rows * (nz * (nz + 1) + 2 * nz))
    return by, fl


# float32 operations per constraint row and Mehrotra iteration, outside the
# G / G' products: rp (2), s_safe (1), d (2), s z and its sum (2), two KKT
# row updates (t 3, dz 4, ds 2: 18), two ratio tests on (s, ds) and (z, dz)
# (a quotient and a min each: 8), mu_aff (6), the corrector's rc (4) and
# the update of s and z (4)
QP_ROW_OPS = 47


def qp_work(B: int, mI: int, nz: int, iters: int, warm_in: bool, warm_out: bool, G=None):
    """(bytes, float32 operations) of one Mehrotra solve: G, H, g, h (and a
    warm state) read once, x, mu (and the state) written once. Per
    iteration: G'diag(d)G as d scaling G's entries once and a multiply and
    an add per row and entry pair of the lower triangle; six G / G' products
    (G'z, Gx, and G't, G dx in each of the two KKT solves), a multiply and
    an add per entry of G each; the per-row operations (QP_ROW_OPS); the
    factorization (nz^3 / 3); four triangular solves and Hx (nz^2 each, Hx
    2 nz^2). Without G the count is dense (every entry, every pair); with
    G (numpy) it is structural, what the reference's own roofline charges
    (pallas_ipm.py assembly_mac_ratio): G's nonzeros, and each row's pairs
    of nonzeros."""
    by = 4 * (mI * nz + B * (nz * nz + nz + mI + nz + 1)
              + (2 * B * mI if warm_in else 0) + (2 * B * mI if warm_out else 0))
    if G is None:
        nnz, pairs = mI * nz, mI * nz * (nz + 1) // 2
    else:
        per_row = (np.asarray(G) != 0).sum(axis=1).astype(np.int64)
        nnz, pairs = int(per_row.sum()), int((per_row * (per_row + 1) // 2).sum())
    per_it = nnz + 2 * pairs + 12 * nnz + QP_ROW_OPS * mI + nz ** 3 // 3 + 6 * nz * nz
    return by, B * iters * per_it


def mono_work(B: int, N_: int, q: int, ne: int, nz: int, n_const: int, mI: int,
              iters: int, G=None):
    """(bytes, float32 operations) of one K3 call: z, dx0, the window, the
    constants, G, h0 and Hp read once, e, d, mu and g written once (H stays
    in the block); the GN phase's operations (gn_work), h's, and one cold
    Mehrotra solve's (qp_work; structural with G)."""
    n = 4
    by = 4 * (B * (nz + n + q * 8 + ne + 2 * nz + 1) + n_const + mI * (nz + 1 + n))
    fl = (gn_work(B, N_, q, ne, nz, n_const)[1] + B * mI * 2 * (n + nz)
          + qp_work(B, mI, nz, iters, False, False, G)[1])
    return by, fl


def shared_qp_work(B: int, mI: int, nz: int, iters: int):
    """(bytes, float32 operations) of one K4 call: G and H read once for the
    batch, g and h once a lane, x and a one-byte flag written once; the
    operations of qp_work's Mehrotra iterations."""
    by = 4 * (mI * nz + nz * nz + B * (2 * nz + mI)) + B
    return by, qp_work(B, mI, nz, iters, False, False)[1]


def bound_ms(by: float, fl: float) -> tuple:
    tb, tf = by / PEAK_BYTES * 1e3, fl / PEAK_F32_FLOPS * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def bench_inputs(rng, B: int, nz: int, device):
    import torch

    from lbmpc_tpu_torch.oracle import DataWindow

    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    dx = f(np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((B, 4)))
    win = DataWindow(X=f(0.1 * rng.standard_normal((B, Q, 3))),
                     Y=f(0.001 * rng.standard_normal((B, Q, 4))),
                     valid=f(np.ones((B, Q))),
                     count=torch.full((B,), Q, dtype=torch.int32, device=device))
    z = f(0.02 * rng.standard_normal((B, nz)))
    return dx, win, z


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stop-after", type=int, default=LAST_PHASE,
                    help=f"last phase to run (1-{LAST_PHASE})")
    ap.add_argument("--profile", action="store_true",
                    help="after the timings, trace 3 fleet steps with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    if not (ROOT / "lbmpc_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(lbmpc_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return run_phases(dev, card_line(), torch.cuda.get_device_name(0), args)


def run_phases(dev, card: str, kind: str, args) -> int:
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.ops import _cuda, chol_kernel, gn_kernel, mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.qp_kernel import QPSolverH, mehrotra_h, mehrotra_h_plain
    from lbmpc_tpu_torch.controllers.sqp_fused import (make_lbmpc_solver_fused,
                                                       make_lbmpc_solver_hybrid)
    from lbmpc_tpu_torch.oracle import push_batched
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

    tag = f"[{card}]"
    t_start = time.time()
    kernels = {"gn_phase": dict(name="gn_phase", route="cuda",
                                source="lbmpc_tpu_torch/csrc/gn_phase.cu",
                                replaces="lbmpc_tpu/ops/pallas_gn.py:587",
                                library_ms=None),
               "mehrotra_h": dict(name="mehrotra_h", route="cuda",
                                  source="lbmpc_tpu_torch/csrc/mehrotra_h.cu",
                                  replaces="lbmpc_tpu/ops/pallas_ipm.py:567",
                                  library_ms=None),
               "gn_mehrotra": dict(name="gn_mehrotra", route="cuda",
                                   source="lbmpc_tpu_torch/csrc/gn_mehrotra.cu",
                                   replaces="lbmpc_tpu/ops/pallas_gn.py:558",
                                   library_ms=None),
               "mehrotra": dict(name="mehrotra", route="cuda",
                                source="lbmpc_tpu_torch/csrc/mehrotra.cu",
                                replaces="lbmpc_tpu/ops/pallas_ipm.py:789",
                                library_ms=None)}
    for k, line in zip(chol_kernel.KERNELS, (175, 250, 320)):
        kernels[k.name] = dict(name=k.name, route="cuda",
                               source="lbmpc_tpu_torch/csrc/chol.cu",
                               replaces=f"lbmpc_tpu/ops/pallas_chol.py:{line}")
    # the wide kernels replace the same TPU kernels over the rest of their
    # domain; K6 the blocked branch of the chol pallas_calls
    kernels["gn_wide"] = dict(name="gn_wide", route="cuda",
                              source="lbmpc_tpu_torch/csrc/gn_wide.cu",
                              replaces="lbmpc_tpu/ops/pallas_gn.py:587", library_ms=None)
    kernels["mehrotra_h_wide"] = dict(name="mehrotra_h_wide", route="cuda",
                                      source="lbmpc_tpu_torch/csrc/mehrotra_h_wide.cu",
                                      replaces="lbmpc_tpu/ops/pallas_ipm.py:567",
                                      library_ms=None)
    kernels["gn_mehrotra_wide"] = dict(name="gn_mehrotra_wide", route="cuda",
                                       source="lbmpc_tpu_torch/csrc/gn_mehrotra_wide.cu",
                                       replaces="lbmpc_tpu/ops/pallas_gn.py:558",
                                       library_ms=None)
    for k, line in zip(chol_kernel.BLOCKED_KERNELS, (175, 267)):
        kernels[k.name] = dict(name=k.name, route="cuda",
                               source="lbmpc_tpu_torch/csrc/chol_blocked.cu",
                               replaces=f"lbmpc_tpu/ops/pallas_chol.py:{line}")

    # ---- phase 1: card, versions, build -------------------------------------
    log("phase 1: card, versions, kernel build")
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32} "
        f"precision={torch.get_float32_matmul_precision()}")
    t0 = time.time()
    all_kernels = (gn_kernel.KERNEL, qp_kernel.KERNEL, mono_kernel.KERNEL,
                   qp_kernel.KERNEL_SHARED, *chol_kernel.KERNELS, gn_kernel.KERNEL_WIDE,
                   qp_kernel.KERNEL_WIDE, *chol_kernel.BLOCKED_KERNELS,
                   mono_kernel.KERNEL_WIDE)
    # K2's, K3's, K2w's and K3w's phase-clock builds (tools/k2_split.py,
    # tools/k2w_split.py), for the split that phases 6, 16, 23 and 24 print:
    # built beside the package's, never launched on its paths
    logs = _cuda.build_all(all_kernels + tuple(split_tool().clocked_kernels().values())
                           + tuple(narrow_split_tool().kernels(clocked=True).values()),
                           verbose=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "error",
                                       "Function properties")):
                log(f"  {name}: {line.strip()}")
    ptxas = {k.name: narrow_split_tool().ptxas_summary(logs.get(k.library_path().name, ""))
             for k in (qp_kernel.KERNEL, mono_kernel.KERNEL)}
    for k in (gn_kernel.KERNEL, qp_kernel.KERNEL_SHARED, gn_kernel.KERNEL_WIDE,
              *chol_kernel.KERNELS, *chol_kernel.BLOCKED_KERNELS):
        kernels[k.name]["ptxas"] = compare_tool().ptxas_summary(
            logs.get(k.library_path().name, ""))
    log(f"  built {len(logs)} kernel sources in parallel in {time.time() - t0:.1f} s")
    require(all(k.library_path().exists() for k in all_kernels), "kernels built")
    if args.stop_after < 2:
        return finish(card, kind, kernels, args)

    # ---- setup at the bench shape ---------------------------------------------
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
        oracle=dataclasses.replace(cfg.oracle, q=Q),
        solver=dataclasses.replace(cfg.solver, sqp_iters=2, dtype="float32"))
    sc = build_scenario(cfg)
    qp = sc.qp
    mI, nz = qp.G.shape
    log(f"bench shape: N={N} q={Q} nz={nz} G=({mI}, {nz}) "
        f"ne={(N - 2) * 5 + 8} batch={BATCH} cohort={COHORT}")
    gn = GNPhase(qp, sc.A, sc.B, sc.ocp.Ks, sc.w, delta=cfg.plant.ts,
                 bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                 dx_ref=np.asarray(cfg.dx_ref), device=dev)
    rng = np.random.default_rng(0)
    dx, win, z = bench_inputs(rng, BATCH, nz, dev)

    # ---- phase 2: K1 against its plain version -------------------------------
    log("phase 2: K1 gn_phase vs plain")
    e_k, H_k, g_k = gn(z, dx, win)
    e_p, H_p, g_p = gn.plain(z, dx, win)
    torch.cuda.synchronize()
    hmax = H_p.abs().max().item()
    errs = [(a - b).abs().max().item() for a, b in ((e_k, e_p), (H_k, H_p), (g_k, g_p))]
    log(f"  max|H|={hmax:.6g} max err e={errs[0]:.3e} H={errs[1]:.3e} g={errs[2]:.3e} "
        f"(relative to max|H|: {max(errs) / hmax:.3e})")
    require(all(np.isfinite(errs)) and max(errs) <= 1e-5 * hmax,
            "K1 e, H, g within 1e-5 * max|H| of the plain version")
    require(bool(torch.equal(H_k, H_k.transpose(1, 2))),
            "K1 H is exactly symmetric (B, nz, nz)")
    kernels["gn_phase"]["max_abs_err"] = max(errs)
    if args.stop_after < 3:
        return finish(card, kind, kernels, args)

    # ---- phase 3: K2 against its plain version -------------------------------
    log("phase 3: K2 mehrotra_h vs plain (bench QP from K1's H and g)")
    G = torch.as_tensor(qp.G, dtype=torch.float32, device=dev)
    h0 = torch.as_tensor(qp.h0, dtype=torch.float32, device=dev)
    Hp = torch.as_tensor(qp.Hp, dtype=torch.float32, device=dev)
    hq = (h0[None] + dx @ Hp.T - z @ G.T).contiguous()
    k2_err = 0.0
    for B in (BATCH, REPAIR_K):
        H_b, g_b, h_b = H_k[:B].contiguous(), g_k[:B].contiguous(), hq[:B].contiguous()
        xk, muk, stk = mehrotra_h(G, H_b, g_b, h_b, IPM_SCHED[0], want_state=True)
        xp, mup, _ = mehrotra_h_plain(G, H_b, g_b, h_b, IPM_SCHED[0])
        dxs = (xk - xp).abs()
        dmu = (muk - mup).abs().max().item()
        log(f"  B={B} cold {IPM_SCHED[0]} iters: |dx| median={dxs.median().item():.3e} "
            f"max={dxs.max().item():.3e} |dmu| max={dmu:.3e}")
        require(dxs.median().item() < 1e-6 and dxs.max().item() < 5e-2
                and dmu < 1e-3, f"K2 cold B={B} (median<1e-6, max<5e-2, dmu<1e-3)")
        if B == BATCH:
            k2_err = max(k2_err, dxs.max().item())
        xw, muw, _ = mehrotra_h(G, H_b, g_b, h_b, IPM_SCHED[1], warm=stk)
        xwp, muwp, _ = mehrotra_h_plain(G, H_b, g_b, h_b, IPM_SCHED[1], warm=stk)
        dxs = (xw - xwp).abs()
        dmu = (muw - muwp).abs().max().item()
        log(f"  B={B} warm-in {IPM_SCHED[1]} iters: |dx| median={dxs.median().item():.3e} "
            f"max={dxs.max().item():.3e} |dmu| max={dmu:.3e}")
        require(dxs.median().item() < 1e-6 and dxs.max().item() < 5e-2
                and dmu < 1e-3, f"K2 warm B={B}")
        xc, muc, _ = mehrotra_h(G, H_b, g_b, h_b, IPM_SCHED[0],
                                warm=QPSolverH.cold_state(h_b))
        require(bool(torch.equal(xc, xk) and torch.equal(muc, muk)),
                f"K2 cold_state warm-in equals the cold solve bit for bit (B={B})")
    kernels["mehrotra_h"]["max_abs_err"] = k2_err
    # a lane's bits do not depend on where its QP sits in the batch: lane 0's
    # QP copied to lanes 1, 31, 32 and B - 1, and solved alone (B = 1)
    for B in (BATCH, REPAIR_K):
        H_b, g_b, h_b = H_k[:B].clone(), g_k[:B].clone(), hq[:B].clone()
        at = sorted({0, 1, 31, 32, B - 1} & set(range(B)))
        for a in (H_b, g_b, h_b):
            a[at] = a[0].clone()
        xk, muk, stk = mehrotra_h(G, H_b, g_b, h_b, IPM_SCHED[0], want_state=True)
        xw, muw, stw = mehrotra_h(G, H_b, g_b, h_b, IPM_SCHED[1], warm=stk, want_state=True)
        x1, mu1, st1 = mehrotra_h(G, H_b[:1].contiguous(), g_b[:1].contiguous(),
                                  h_b[:1].contiguous(), IPM_SCHED[0], want_state=True)
        outs = (xk, muk, *stk, xw, muw, *stw)
        same = all(torch.equal(o[at], o[:1].expand_as(o[at])) for o in outs)
        alone = all(torch.equal(a[:1], b) for a, b in zip((xk, muk, *stk), (x1, mu1, *st1)))
        require(same and alone, f"K2 one QP at lanes {at} of B={B} and alone (B=1): the same "
                f"bits ({IPM_SCHED[0]} cold, {IPM_SCHED[1]} warm)")
    if args.stop_after < 4:
        return finish(card, kind, kernels, args)

    # ---- phase 4: the fused solve, kernel route vs plain route ---------------
    log("phase 4: fused SQP solve at the bench configuration, kernel vs plain route")
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2,
              ipm_iters=IPM_SCHED, alphas=LADDER, qp_warm=True, qp_kernel="pallas_full",
              device=dev)
    hyb_kw = dict(repair_frac=REPAIR_K / BATCH, repair_sqp_iters=1, repair_ipm_iters=8,
                  repair_warm="fused", repair_backend="fused")
    z0 = torch.zeros(BATCH, nz, dtype=torch.float32, device=dev)
    solvers = {}
    for name, factory, extra in (("fused", make_lbmpc_solver_fused, {}),
                                 ("hybrid", make_lbmpc_solver_hybrid, hyb_kw)):
        sk = factory(qp, sc.A, sc.B, sc.ocp.Ks, sc.w, **kw, **extra)
        sp = factory(qp, sc.A, sc.B, sc.ocp.Ks, sc.w, plain=True, **kw, **extra)
        solvers[name] = (sk, sp)
        n1, n2 = gn_kernel.KERNEL.launches, qp_kernel.KERNEL.launches
        zk, ck = sk(dx, win, z0)
        torch.cuda.synchronize()
        l1, l2 = gn_kernel.KERNEL.launches - n1, qp_kernel.KERNEL.launches - n2
        zp, cp = sp(dx, win, z0)
        dz = (zk - zp).abs()
        fk, fp = ck.float().mean().item(), cp.float().mean().item()
        log(f"  {name}: |dz| median={dz.median().item():.3e} max={dz.max().item():.3e} "
            f"conv kernel={fk:.6f} plain={fp:.6f} launches K1={l1} K2={l2}")
        require(bool(torch.isfinite(zk).all()), f"{name} solve finite")
        require(abs(fk - fp) <= 0.005, f"{name} conv within 0.5 pp of the plain route")
        want = 2 if name == "fused" else 3
        require(l1 == want and l2 == want,
                f"{name} launches K1={want} and K2={want} per solve")
    if args.stop_after < 5:
        return finish(card, kind, kernels, args)

    # ---- phase 5: the main path — warm-chain hybrid fleet ---------------------
    log(f"phase 5: warm-chain hybrid fleet on the kernel route, cohort {COHORT}, "
        f"{STEPS} steps (the kernel route's main path)")
    fcfg = dataclasses.replace(cfg, iterations=STEPS)
    fleet_kw = dict(backend="hybrid", ipm_iters=IPM_SCHED, sqp_iters=2, qp_warm=True,
                    warm_chain=True, qp_kernel="pallas_full", device=dev)
    _, run_k = build_fleet_episode(fcfg, **fleet_kw)
    _, run_p = build_fleet_episode(fcfg, plain=True, **fleet_kw)
    dx_init = (np.array([-0.35, -0.4, 0.0, 0.0])
               + np.random.default_rng(1).uniform(-0.02, 0.02, (COHORT, 4)))
    torch.cuda.synchronize()
    gn_kernel.KERNEL.launches = 0
    qp_kernel.KERNEL.launches = 0
    t0 = time.time()
    res = run_k(dx_init)
    torch.cuda.synchronize()
    fleet_s = time.time() - t0
    launches = {"gn_phase": gn_kernel.KERNEL.launches,
                "mehrotra_h": qp_kernel.KERNEL.launches}
    for k, v in launches.items():
        kernels[k]["launches"] = v
    sysH = res.sys_history
    conv = res.solver_converged.float().mean().item()
    log(f"  {fleet_s * 1e3 / STEPS:.3f} ms/step (host clock, first run, incl. warm-up) "
        f"conv={conv:.6f} launches {launches} {tag}")
    require(tuple(sysH.shape) == (COHORT, STEPS + 1, 5)
            and bool(torch.isfinite(sysH).all()), "fleet history finite, (B, T+1, 5)")
    require(all(v > 0 for v in launches.values()),
            "K1 and K2 launched on the main path")
    require(conv >= 0.99, "fleet conv >= 0.99")
    res_p = run_p(dx_init[:256])
    d = (sysH[:256] - res_p.sys_history).abs()
    worst = np.unravel_index(int(d.argmax()), tuple(d.shape))
    log(f"  first 256 lanes vs plain route: |d sys_history| median={d.median().item():.3e} "
        f"max={d.max().item():.3e} at (lane, step, column)={tuple(int(i) for i in worst)}; "
        f"lanes above 1e-4: {int((d.amax(dim=(1, 2)) > 1e-4).sum())}; "
        f"plain conv={res_p.solver_converged.float().mean().item():.6f}")
    # the tolerance class of one solve (K2 vs its plain version: the f32
    # hard lanes of the Mehrotra iteration differ by up to 5e-2, and
    # du = Ks dx + c_0 carries that into the history)
    require(d.median().item() < 1e-6 and d.max().item() < 5e-2,
            "fleet sys_history vs the plain route: median < 1e-6, max < 5e-2")
    if args.stop_after < 6:
        return finish(card, kind, kernels, args)

    # ---- phase 6: timings (CUDA events, after warm-up) ------------------------
    log("phase 6: timings")
    t = {}
    t["k1"] = graph_ms(lambda: gn(z, dx, win))
    t["k1_host"] = cuda_ms(lambda: gn(z, dx, win))
    t["k1_plain"] = cuda_ms(lambda: gn.plain(z, dx, win), reps=5)
    Hb, gb = H_k.contiguous(), g_k.contiguous()
    t["k2_8"] = cuda_ms(lambda: mehrotra_h(G, Hb, gb, hq, IPM_SCHED[0], want_state=True))
    st = mehrotra_h(G, Hb, gb, hq, IPM_SCHED[0], want_state=True)[2]
    t["k2_2"] = cuda_ms(lambda: mehrotra_h(G, Hb, gb, hq, IPM_SCHED[1], warm=st))
    t["k2_8_plain"] = cuda_ms(lambda: mehrotra_h_plain(G, Hb, gb, hq, IPM_SCHED[0]), reps=3)
    t["k2_2_plain"] = cuda_ms(lambda: mehrotra_h_plain(G, Hb, gb, hq, IPM_SCHED[1], warm=st),
                              reps=3)
    for name, (sk, sp) in solvers.items():
        t[f"{name}_solve"] = cuda_ms(lambda: sk(dx, win, z0), reps=5)
        t[f"{name}_solve_plain"] = cuda_ms(lambda: sp(dx, win, z0), reps=2, warmup=1)
    t0 = time.time()
    run_k(dx_init)
    torch.cuda.synchronize()
    t["fleet_step"] = (time.time() - t0) * 1e3 / STEPS
    from lbmpc_tpu_torch.models.mgcm import rk23_step

    xr = torch.as_tensor(np.asarray(fcfg.plant.x_wp) + dx_init, dtype=torch.float32,
                         device=dev)
    ur = torch.full((COHORT,), float(fcfg.plant.u_wp), device=dev)
    t["fleet_rk23"] = cuda_ms(lambda: rk23_step(xr, ur, fcfg.plant.ts), reps=5)
    # where a solve and a fleet step go: one merit rollout of the ladder at
    # the batch; the warm-chain hybrid solve and the window push at the cohort
    sf = solvers["fused"][0]
    t["merit_rollout"] = cuda_ms(lambda: sf.cost(z0, dx, win), reps=10)
    hyb = run_k.solver
    dxc, winc, _ = bench_inputs(np.random.default_rng(2), COHORT, nz, dev)
    zc = torch.zeros(COHORT, nz, dtype=torch.float32, device=dev)
    stc = hyb.init_qp_state(dxc, zc)
    t["fleet_solve"] = cuda_ms(lambda: hyb.raw_qpwarm(dxc, winc, zc, stc), reps=3,
                               warmup=1)
    xi_c = dxc[:, :3].contiguous()
    t["fleet_push"] = cuda_ms(lambda: push_batched(winc, xi_c, dxc), reps=10)
    for k, v in t.items():
        log(f"  time {k} = {v:.4f} ms {tag}")
    ne = (N - 2) * 5 + 8
    by, fl = gn_work(BATCH, N, Q, ne, nz, gn.cst.numel())
    b1, b1_by = bound_ms(by, fl)
    by2, fl2 = qp_work(BATCH, mI, nz, IPM_SCHED[0], False, True)
    b2, b2_by = bound_ms(by2, fl2)
    kernels["gn_phase"].update(ms=t["k1"], ms_host=t["k1_host"], plain_ms=t["k1_plain"],
                               bound_ms=b1, bound_by=b1_by)
    kernels["mehrotra_h"].update(ms=t["k2_8"], plain_ms=t["k2_8_plain"], bound_ms=b2,
                                 bound_by=b2_by)
    by22, fl22 = qp_work(BATCH, mI, nz, IPM_SCHED[1], True, False)
    log(f"  bound K1 {b1:.4f} ms ({b1_by}; {by} B, {fl:.4g} flop); K2 8 iters "
        f"{b2:.4f} ms ({b2_by}; {by2} B, {fl2:.4g} flop); K2 2 iters "
        f"{bound_ms(by22, fl22)[0]:.4f} ms {tag}")
    k1_report(dev, tag, kernels, gn)
    narrow_k2_report(dev, tag, kernels, ptxas["mehrotra_h"], gn, G, h0, Hp)
    if args.profile:
        profile_fleet(dataclasses.replace(fcfg, iterations=3), fleet_kw, dx_init, tag)
    log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after < 7:
        return finish(card, kind, kernels, args)
    xla_phases(dev, tag, args, kernels, cfg, sc, dx, win, dx_init)
    log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 12:
        kernel_route_phases(dev, tag, args, kernels, cfg, sc, gn, dx, win, dx_init,
                            ptxas["gn_mehrotra"])
        log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 17:
        wide_phases(dev, tag, args, kernels, dx_init)
        log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 24:
        mono_wide_phases(dev, tag, args, kernels, cfg, dx_init)
        log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 30:
        nmpc_phases(dev, tag, args)
        log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 32:
        shipping_phase(dev, tag)
        log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 34:
        sparse_phases(dev, tag, args)
        log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 37:
        tooling_phase(dev, tag, cfg, sc)
        log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 38:
        ck = checkpoint_phase(dev, tag)
        log(f"  wall time so far {time.time() - t_start:.1f} s")
        if args.stop_after >= 39:
            sandbox_phase(dev, tag, ck)
            log(f"  wall time so far {time.time() - t_start:.1f} s")
        if args.stop_after >= 40:
            mesh_phases(dev, tag, args, cfg, sc, dx, win, ck)
            log(f"  wall time so far {time.time() - t_start:.1f} s")
    if args.stop_after >= 45:
        fleet_split_phase(dev, tag)
        log(f"  wall time so far {time.time() - t_start:.1f} s")
    return finish(card, kind, kernels, args)


def chol_work(name: str, B: int, n: int):
    """(bytes, float32 operations) of one K5 call: M or L read once, b read
    once, x (and L) written once; the factorization's n^3/3 and the two
    triangular solves' 2 n^2 operations. M and L count n(n+1)/2 floats a
    lane: the factorization reads only M's lower triangle, and nothing reads
    L above its diagonal."""
    mat, vec = B * n * (n + 1) // 2, B * n
    by = {"chol_factor_solve": 2 * mat + 2 * vec, "chol_solve": mat + 2 * vec,
          "chol_resolve": mat + 2 * vec}[name] * 4
    fl = B * (2 * n * n + (n ** 3 // 3 if name != "chol_resolve" else 0))
    return by, fl


class CholRecorder:
    """Keeps the first and the last (M, b) that the IPM hands K5a during one
    solve: the equilibrated KKT matrices of the first and the last IPM
    iteration, as the solve produced them."""

    def __enter__(self):
        from lbmpc_tpu_torch.ops import ipm_fused

        self.first = self.last = None
        self._orig = ipm_fused.chol_factor_solve

        def record(M, b, plain=False):
            pair = (M.clone(), b.clone())
            if self.first is None:
                self.first = pair
            self.last = pair
            return self._orig(M, b, plain)

        ipm_fused.chol_factor_solve = record
        return self

    def __exit__(self, *exc):
        from lbmpc_tpu_torch.ops import ipm_fused

        ipm_fused.chol_factor_solve = self._orig


def abs_diff(a, b):
    """|a - b| where the two differ; equal entries (inf and NaN in the same
    place included) count 0, and a one-sided NaN is an infinite error."""
    import torch

    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)


def mismatch(a, b) -> float:
    """max |a - b| where the two differ (abs_diff)."""
    return abs_diff(a, b).max().item()


def finite_max(a) -> float:
    import torch

    return a[torch.isfinite(a)].abs().max().item()


def chol_kernels() -> tuple:
    """K5a, K5b, K5c, K6a, K6b."""
    from lbmpc_tpu_torch.ops import chol_kernel

    return (*chol_kernel.KERNELS, *chol_kernel.BLOCKED_KERNELS)


def route_kernels() -> tuple:
    """The kernels of the GN-phase and Mehrotra routes: K1, K2, K3, K4 and the
    wide K1w, K2w, K3w, each counted apart."""
    from lbmpc_tpu_torch.ops import gn_kernel, mono_kernel, qp_kernel

    return (gn_kernel.KERNEL, qp_kernel.KERNEL, mono_kernel.KERNEL, qp_kernel.KERNEL_SHARED,
            gn_kernel.KERNEL_WIDE, qp_kernel.KERNEL_WIDE, mono_kernel.KERNEL_WIDE)


def chol_counts() -> dict:
    return {k.name: k.launches for k in chol_kernels()}


def route_counts() -> dict:
    return {k.name: k.launches for k in route_kernels()}


def chol_none() -> dict:
    return {k.name: 0 for k in chol_kernels()}


def route_none() -> dict:
    return {k.name: 0 for k in route_kernels()}


def zero_counts() -> None:
    for k in (*route_kernels(), *chol_kernels()):
        k.launches = 0


def solve_gates(name: str, zk, ck, zp, cp) -> float:
    """The solve-level gates of a kernel route against its plain route."""
    import torch

    dz = (zk - zp).abs()
    fk, fp = ck.float().mean().item(), cp.float().mean().item()
    log(f"  {name}: |dz| median={dz.median().item():.3e} max={dz.max().item():.3e} "
        f"(bit-equal: {bool(torch.equal(zk, zp))}) conv kernel={fk:.6f} plain={fp:.6f}")
    require(bool(torch.isfinite(zk).all()), f"{name} solve finite")
    require(dz.median().item() < 1e-6 and dz.max().item() < 5e-2,
            f"{name} |dz| vs the plain route: median < 1e-6, max < 5e-2")
    require(abs(fk - fp) <= 0.005 and fk >= 0.99,
            f"{name} conv within 0.5 pp of the plain route and >= 0.99")
    return dz.max().item()


def xla_phases(dev, tag: str, args, kernels: dict, cfg, sc, dx, win, dx_init) -> None:
    """Phases 7-11: the xla route on the K5 kernels."""
    import os

    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.ops import chol_kernel as ck
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

    f32 = torch.float32
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2,
              ipm_iters=XLA_SCHED, alphas=LADDER, device=dev)
    bench = lambda **extra: make_lbmpc_solver_fused(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w,
                                                    **kw, **extra)
    dcfg = lt.make_preset("DMS_LBMPC_q100")
    dcfg = dataclasses.replace(dcfg, solver=dataclasses.replace(dcfg.solver, dtype="float32"))
    ds = build_scenario(dcfg)
    dkw = dict(kw, family="casadi", delta=dcfg.plant.ts, bandwidth=dcfg.oracle.bandwidth,
               ridge=dcfg.oracle.ridge, dx_ref=np.asarray(dcfg.dx_ref))
    dms = lambda **extra: make_lbmpc_solver_fused(ds.qp, ds.A, ds.B, ds.ocp.Ks, ds.w,
                                                  **dkw, **extra)
    support = np.count_nonzero(ds.qp.G, axis=1)
    log(f"DMS flagship: N={dcfg.ocp.N} q={dcfg.oracle.q} nz={ds.nz} G={ds.qp.G.shape} "
        f"(rows with 1 / 2 / more columns: {(support == 1).sum()} / {(support == 2).sum()} "
        f"/ {(support > 2).sum()}) batch={DMS_BATCH}")
    rng = np.random.default_rng(3)
    _, dwin, _ = bench_inputs(rng, DMS_BATCH, ds.nz, dev)
    x0 = np.asarray(dcfg.x_init_abs) - np.asarray(dcfg.plant.x_wp)
    ddx = torch.as_tensor(x0 + 0.01 * rng.standard_normal((DMS_BATCH, 4)), dtype=f32,
                          device=dev)
    dz0 = torch.zeros(DMS_BATCH, ds.nz, dtype=f32, device=dev)
    z0 = torch.zeros(BATCH, sc.nz, dtype=f32, device=dev)

    # ---- phase 7: K5 against its plain versions -------------------------------
    log("phase 7: K5 chol kernels vs plain, M from real xla-route solves "
        "(first and last IPM iteration, equilibrated)")
    cdx, cwin, _ = bench_inputs(np.random.default_rng(4), COHORT, sc.nz, dev)
    czero = torch.zeros(COHORT, sc.nz, dtype=f32, device=dev)
    cases = {}
    with CholRecorder() as rec:
        bench()(cdx, cwin, czero)
    cases[f"n={sc.nz} B={COHORT}"] = (rec.first, rec.last)
    with CholRecorder() as rec:
        dms()(ddx, dwin, dz0)
    cases[f"n={ds.nz} B={DMS_BATCH}"] = (rec.first, rec.last)
    torch.cuda.synchronize()
    errs = {k.name: 0.0 for k in ck.KERNELS}
    for shape, pairs in cases.items():
        for it, (M, b) in zip(("first", "last"), pairs):
            Lk, xk = ck.chol_factor_solve(M, b)
            Lp, xp = ck.chol_factor_solve(M, b, plain=True)
            xs = ck.chol_solve(M, b)
            xr = ck.chol_resolve(Lp, b)
            xrp = ck.chol_resolve(Lp, b, plain=True)
            torch.cuda.synchronize()
            xmax, lmax = finite_max(xp), finite_max(Lp)
            e = {"chol_factor_solve": (mismatch(xk, xp), mismatch(Lk, Lp)),
                 "chol_solve": (mismatch(xs, xp), 0.0),
                 "chol_resolve": (mismatch(xr, xrp), 0.0)}
            log(f"  {shape} {it} iteration: max|x|={xmax:.4g} max|L|={lmax:.4g} errors "
                + " ".join(f"{k} x={v[0]:.3e}" for k, v in e.items())
                + f" L={e['chol_factor_solve'][1]:.3e}; bit-equal: "
                + str(bool(torch.equal(Lk, Lp) and torch.equal(xk, xp)
                           and torch.equal(xs, xp) and torch.equal(xr, xrp))))
            for k, (ex, eL) in e.items():
                require(ex <= 1e-4 * xmax and eL <= 1e-5 * lmax,
                        f"{k} at {shape}, {it} iteration: x within 1e-4 of max|x|, "
                        "L within 1e-5 of max|L|")
                errs[k] = max(errs[k], ex, eL)
    for k, v in errs.items():
        kernels[k]["max_abs_err"] = v
    if args.stop_after < 8:
        return

    # ---- phase 8: the fmincon xla-route solve ----------------------------------
    log(f"phase 8: fused SQP on the xla route, bench configuration, batch {BATCH}, "
        f"ipm {XLA_SCHED}, kernel vs plain route")
    sk, sp = bench(), bench(plain=True)
    torch.cuda.synchronize()
    zero_counts()
    zk, ckv = sk(dx, win, z0)
    torch.cuda.synchronize()
    per = chol_counts()
    zp, cpv = sp(dx, win, z0)
    log(f"  launches per solve {per}")
    solve_gates("fmincon xla solve", zk, ckv, zp, cpv)
    require(per == dict(chol_none(), chol_factor_solve=24, chol_resolve=24),
            "fmincon xla solve: K5a = K5c = 24 launches per solve, K5b = 0")
    if args.stop_after < 9:
        return

    # ---- phase 9: the DMS flagship solve, L stored and refactored ------------
    log(f"phase 9: DMS flagship fused SQP on the xla route, batch {DMS_BATCH}, "
        f"ipm {XLA_SCHED}, kernel vs plain route; then LBMPC_CHOL_STORE=0")
    dk, dp = dms(), dms(plain=True)
    torch.cuda.synchronize()
    zero_counts()
    dzk, dck = dk(ddx, dwin, dz0)
    torch.cuda.synchronize()
    per = chol_counts()
    dzp, dcp = dp(ddx, dwin, dz0)
    log(f"  launches per solve {per}")
    solve_gates("DMS xla solve", dzk, dck, dzp, dcp)
    require(per == dict(chol_none(), chol_factor_solve=24, chol_resolve=24),
            "DMS xla solve: K5a = K5c = 24 launches per solve, K5b = 0")
    os.environ["LBMPC_CHOL_STORE"] = "0"
    try:
        dn = dms()
    finally:
        del os.environ["LBMPC_CHOL_STORE"]
    torch.cuda.synchronize()
    zero_counts()
    dzn, dcn = dn(ddx, dwin, dz0)          # K5b's path
    torch.cuda.synchronize()
    per = chol_counts()
    kernels["chol_solve"]["launches"] = per["chol_solve"]
    dd = (dzn - dzk).abs().max().item()
    log(f"  LBMPC_CHOL_STORE=0: launches {per}; max|z - z_store|={dd:.3e} "
        f"(bit-equal: {bool(torch.equal(dzn, dzk))}) conv={dcn.float().mean().item():.6f}")
    require(per == dict(chol_none(), chol_solve=48),
            "LBMPC_CHOL_STORE=0: K5b = 48 launches per solve, K5a = K5c = 0")
    require(dd <= 1e-6 * (1.0 + dzk.abs().max().item()),
            "LBMPC_CHOL_STORE=0: z equals the store route within float32 roundoff")
    if args.stop_after < 10:
        return

    # ---- phase 10: the default fused fleet (this slice's main path) ----------
    log(f"phase 10: default fused fleet (xla route), cohort {COHORT}, {STEPS} steps "
        "(the xla route's main path)")
    fcfg = dataclasses.replace(cfg, iterations=STEPS)
    xfleet_kw = dict(backend="fused", sqp_iters=2, ipm_iters=XLA_SCHED, device=dev)
    _, run_x = build_fleet_episode(fcfg, **xfleet_kw)
    _, run_xp = build_fleet_episode(fcfg, plain=True, **xfleet_kw)
    require(run_x.solver.qp_kernel == "xla", "the default fleet takes the xla route")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    res = run_x(dx_init)
    torch.cuda.synchronize()
    fleet_s = time.time() - t0
    per = chol_counts()
    for k in ("chol_factor_solve", "chol_resolve"):
        kernels[k]["launches"] = per[k]
    sysH = res.sys_history
    conv = res.solver_converged.float().mean().item()
    log(f"  {fleet_s * 1e3 / STEPS:.3f} ms/step (host clock, first run, incl. warm-up) "
        f"conv={conv:.6f} launches {per} {tag}")
    require(tuple(sysH.shape) == (COHORT, STEPS + 1, 5)
            and bool(torch.isfinite(sysH).all()), "fleet history finite, (B, T+1, 5)")
    require(per == dict(chol_none(), chol_factor_solve=STEPS * 24, chol_resolve=STEPS * 24),
            f"K5a and K5c launched {STEPS * 24} times each on the main path, K5b 0")
    require(conv >= 0.99, "default fleet conv >= 0.99")
    res_p = run_xp(dx_init)                  # same cohort: same matmul shapes
    d = (sysH - res_p.sys_history).abs()
    d256 = d[:256]
    log(f"  vs plain route: first 256 lanes |d sys_history| median="
        f"{d256.median().item():.3e} max={d256.max().item():.3e}; all lanes max="
        f"{d.max().item():.3e} (bit-equal: {bool(torch.equal(sysH, res_p.sys_history))}); "
        f"plain conv={res_p.solver_converged.float().mean().item():.6f}")
    require(d.median().item() < 1e-6 and d.max().item() < 5e-2,
            "default fleet sys_history vs the plain route: median < 1e-6, max < 5e-2")
    if args.stop_after < 11:
        return

    # ---- phase 11: timings (CUDA events, after warm-up) -----------------------
    log("phase 11: xla-route timings")
    t = {}
    for shape, pairs in cases.items():
        M, b = pairs[1]
        B, n = b.shape
        L = ck.chol_factor_solve(M, b)[0]
        calls = {"chol_factor_solve": (lambda: ck.chol_factor_solve(M, b),
                                       lambda: ck.chol_factor_solve(M, b, plain=True)),
                 "chol_solve": (lambda: ck.chol_solve(M, b),
                                lambda: ck.chol_solve(M, b, plain=True)),
                 "chol_resolve": (lambda: ck.chol_resolve(L, b),
                                  lambda: ck.chol_resolve(L, b, plain=True))}
        Lx = torch.linalg.cholesky_ex(M)[0]
        lib_fs = lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky_ex(M)[0])
        libs = {"chol_factor_solve": lib_fs, "chol_solve": lib_fs,
                "chol_resolve": lambda: torch.cholesky_solve(b[..., None], Lx)}
        for name, (fk, fp) in calls.items():
            ms, pms, lms = graph_ms(fk), cuda_ms(fp, reps=3), cuda_ms(libs[name], reps=5)
            bd, bd_by = bound_ms(*chol_work(name, B, n))
            t[(name, shape)] = (ms, pms, lms, bd, bd_by)
            log(f"  time {name} {shape}: kernel {ms:.4f} ms (device), host-clocked "
                f"{cuda_ms(fk):.4f} ms, plain {pms:.4f} ms, library {lms:.4f} ms, bound "
                f"{bd:.4f} ms ({bd_by}) {tag}")
    # each row carries the shape of its kernel's path: K5a and K5c the
    # fleet cohort, K5b the DMS flagship (its LBMPC_CHOL_STORE=0 path)
    for name, shape in (("chol_factor_solve", f"n={sc.nz} B={COHORT}"),
                        ("chol_solve", f"n={ds.nz} B={DMS_BATCH}"),
                        ("chol_resolve", f"n={sc.nz} B={COHORT}")):
        ms, pms, lms, bd, bd_by = t[(name, shape)]
        kernels[name].update(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bd,
                             bound_by=bd_by)
    chol_report(dev, tag, kernels, [(f"n={sc.nz} B={COHORT}", *cases[f"n={sc.nz} B={COHORT}"][1]),
                                    (f"n={sc.nz} B={BATCH}", *(a[:BATCH].contiguous() for a in
                                                               cases[f"n={sc.nz} B={COHORT}"][1])),
                                    (f"n={ds.nz} B={DMS_BATCH}",
                                     *cases[f"n={ds.nz} B={DMS_BATCH}"][1])])
    ts = {"xla_solve": cuda_ms(lambda: sk(dx, win, z0), reps=5),
          "xla_solve_plain": cuda_ms(lambda: sp(dx, win, z0), reps=2, warmup=1),
          "dms_solve": cuda_ms(lambda: dk(ddx, dwin, dz0), reps=3, warmup=1),
          "dms_solve_nostore": cuda_ms(lambda: dn(ddx, dwin, dz0), reps=3, warmup=1),
          "dms_solve_plain": cuda_ms(lambda: dp(ddx, dwin, dz0), reps=2, warmup=1),
          "xla_merit_rollout": cuda_ms(lambda: sk.cost(z0, dx, win), reps=10),
          "xla_gn_plain": cuda_ms(lambda: sk.gn.plain(z0, dx, win), reps=5)}
    t0 = time.time()
    run_x(dx_init)
    torch.cuda.synchronize()
    ts["xla_fleet_step"] = (time.time() - t0) * 1e3 / STEPS
    for k, v in ts.items():
        log(f"  time {k} = {v:.4f} ms {tag}")
    if args.profile:
        profile_fleet(dataclasses.replace(fcfg, iterations=3), xfleet_kw, dx_init, tag)


def lmpc_qp():
    """The N=20 LMPC QP of tests/test_pallas_ipm.py:38-54 (806 rows, a
    616-row terminal set), from the port's host setup."""
    from lbmpc_tpu_torch.controllers.condensed import build_fmincon_lmpc
    from lbmpc_tpu_torch.models.mgcm import mgcm_dlti
    from lbmpc_tpu_torch.sets.terminal import get_cons
    from lbmpc_tpu_torch.synthesis import mat_ocp

    Ad, Bd, C, _ = mgcm_dlti()
    ocp = mat_ocp(Ad, Bd, C)
    cs = get_cons(x_min=[0.0, 1.1875, 0.1547, -20.0], x_max=[1.0, 2.1875, 2.1547, 20.0],
                  u_min=0.1547, u_max=2.1547, x_wp=[0.5, 1.6875, 1.1547, 0.0], u_wp=1.1547,
                  A=Ad, B=Bd, K=ocp.Ks, LAMBDA=ocp.LAMBDA, PSI=ocp.PSI,
                  LAMBDA_0=ocp.LAMBDA_0, PSI_0=ocp.PSI_0)
    return build_fmincon_lmpc(Ad, Bd, ocp.Ks, ocp.Q, ocp.R, ocp.P, ocp.T, ocp.LAMBDA,
                              ocp.PSI, cs, 20)


def qp_step_gates(name: str, dk, muk, dp, mup, strict: bool) -> tuple:
    """A QP step (d, mu) against another computation of it on the same
    inputs. strict: the K2 class on every lane — |d| median < 1e-6, max
    < 5e-2, |mu| < 1e-3. Otherwise (16 IPM iterations) float32 Mehrotra
    stalls (mu >= 1e-6) on ~8 % of the bench lanes, where two
    computations whose arithmetic differs by roundoff end far apart: every
    lane outside the K2 class must be stalled on one side, and the stalled
    shares must agree within 2 pp. Returns (max |d| over the lanes finite on
    both sides, max |d| over the lanes held to the K2 class)."""
    dd = (dk - dp).abs()
    dl = dd.amax(dim=1)
    fin = dl.isfinite()
    off = ~((dl <= 5e-2) & ((muk - mup).abs() <= 1e-3))
    stalled = ~((muk < 1e-6) & (mup < 1e-6))
    sk, sp = (~(muk < 1e-6)).float().mean().item(), (~(mup < 1e-6)).float().mean().item()
    log(f"  {name}: |dd| median={dd[fin].median().item():.3e} max={dl[fin].max().item():.3e}; "
        f"lanes outside the K2 class {int(off.sum())}, of them not stalled "
        f"{int((off & ~stalled).sum())}; stalled share {sk:.4f} / {sp:.4f}; "
        f"bit-equal: {bool(torch_equal(dk, dp) and torch_equal(muk, mup))}")
    require(dd[fin].median().item() < 1e-6, f"{name}: |dd| median < 1e-6")
    if strict:
        require(not bool(off.any()), f"{name}: |dd| max < 5e-2 and |dmu| < 1e-3 on every lane")
        return dl.max().item(), dl.max().item()
    require(not bool((off & ~stalled).any()) and abs(sk - sp) <= 0.02,
            f"{name}: every lane outside the K2 class stalled on one side, "
            "stalled shares within 2 pp")
    held = dl[~stalled]
    return dl[fin].max().item(), (held.max().item() if held.numel() else 0.0)


def f64_gates(name: str, dk, muk, dp, mup, d64) -> tuple:
    """A QP step where the K2 class cannot hold: above nz 32 the plain
    version's own median distance from the float64 solve is near 1e-6 on the
    DMS QP, and at 16 iterations float32 Mehrotra stalls (mu >= 1e-6) on a
    third of the N40 lanes or more. So the kernel is held, as K4 is, to the
    plain version in float64 on the same inputs: its median distance from it
    at most 1.5 times the float32 plain version's (+1e-8), its share of lanes
    beyond 5e-2 of it at most 0.5 pp above the plain version's, and the
    stalled shares within 2 pp. The K2-class numbers are logged beside.
    Returns (max |d| between kernel and plain over lanes finite on both
    sides, the same over the lanes not stalled on either side)."""
    dd = (dk - dp).abs()
    dl = dd.amax(dim=1)
    fin = dl.isfinite()
    ek, ep = ((a.double() - d64).abs() for a in (dk, dp))
    mk, mp = ek.median().item(), ep.median().item()
    fk, fp = ((e.amax(dim=1) > 5e-2).float().mean().item() for e in (ek, ep))
    stalled = ~((muk < 1e-6) & (mup < 1e-6))
    sk, sp = (~(muk < 1e-6)).float().mean().item(), (~(mup < 1e-6)).float().mean().item()
    log(f"  {name}: K2 class |dd| median={dd[fin].median().item():.3e} "
        f"max={dl[fin].max().item():.3e}, lanes beyond 5e-2 {int((~(dl <= 5e-2)).sum())}; "
        f"from the float64 plain version: |d| median kernel {mk:.3e} plain {mp:.3e}, lanes "
        f"beyond 5e-2 kernel {fk:.4f} plain {fp:.4f}; stalled share {sk:.4f} / {sp:.4f}")
    require(mk <= 1.5 * mp + 1e-8, f"{name}: median distance from the float64 solve at most "
            "1.5x the plain version's")
    require(fk <= fp + 0.005 and abs(sk - sp) <= 0.02,
            f"{name}: lanes beyond 5e-2 of the float64 solve at most 0.5 pp above the plain "
            "version's, stalled shares within 2 pp")
    held = dl[~stalled]
    return dl[fin].max().item(), (held.max().item() if held.numel() else 0.0)


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a, b))


def route_gates(name: str, zk, ck, zp, cp) -> float:
    """A solve on a kernel route against another route on the same inputs:
    |dz| median < 1e-6; the control the plant receives (c_0) within 5e-2 on
    every lane; at most 1 % of lanes beyond 5e-2 anywhere in z (the lanes
    whose 16-iteration first QP stalled in float32, qp_step_gates); conv
    >= 0.99 and within 0.5 pp."""
    dz = (zk - zp).abs()
    dl = dz.amax(dim=1)
    far = ~(dl <= 5e-2)
    fk, fp = ck.float().mean().item(), cp.float().mean().item()
    log(f"  {name}: |dz| median={dz.median().item():.3e} max={dz.max().item():.3e} "
        f"c_0 max={dz[:, 0].max().item():.3e}, lanes beyond 5e-2 {int(far.sum())} "
        f"(bit-equal: {torch_equal(zk, zp)}) conv {fk:.6f} / {fp:.6f}")
    require(bool(zk.isfinite().all()), f"{name}: solve finite")
    require(dz.median().item() < 1e-6 and dz[:, 0].max().item() < 5e-2
            and far.float().mean().item() <= 0.01,
            f"{name}: |dz| median < 1e-6, c_0 within 5e-2, <= 1 % of lanes beyond 5e-2")
    require(fk >= 0.99 and abs(fk - fp) <= 0.005, f"{name}: conv >= 0.99, within 0.5 pp")
    return dz.max().item()


def anchored_route_gates(name: str, zk, ck, zp, cp, za) -> float:
    """A kernel route's solve against its plain route where route_gates'
    median cannot hold: on the DMS flagship two float32 computations of the
    16-iteration first QP end ~1e-5 apart in the median (its lanes stall),
    however they round. So the kernel route is held to an independent
    computation of the same solve, the xla route on K5: its median distance
    from it at most 1.5 times the plain route's (+1e-8) and at most 2 % more
    of its lanes beyond 5e-2 of it (two float32 computations of the warm
    chain's 2-iteration QP put 4.4 % and 5.5 % of the lanes there); and, as
    route_gates holds, the applied
    control c_0 within 5e-2 of the plain route on every lane, conv >= 0.99
    and within 0.5 pp of it. Logs route_gates' numbers beside."""
    dz = (zk - zp).abs()
    ek, ep = (zk - za).abs(), (zp - za).abs()
    far = lambda e: (~(e.amax(dim=1) <= 5e-2)).float().mean().item()
    fk, fp = ck.float().mean().item(), cp.float().mean().item()
    log(f"  {name}: vs its plain route |dz| median={dz.median().item():.3e} "
        f"max={dz.max().item():.3e} c_0 max={dz[:, 0].max().item():.3e}, lanes beyond 5e-2 "
        f"{int((~(dz.amax(dim=1) <= 5e-2)).sum())}; from the xla route |dz| median kernel "
        f"{ek.median().item():.3e} plain {ep.median().item():.3e}, lanes beyond 5e-2 "
        f"{far(ek):.4f} / {far(ep):.4f}; conv {fk:.6f} / {fp:.6f}")
    require(bool(zk.isfinite().all()), f"{name}: solve finite")
    require(ek.median().item() <= 1.5 * ep.median().item() + 1e-8
            and far(ek) <= far(ep) + 0.02,
            f"{name}: as close to the xla route as its plain route (median within 1.5x, "
            "lanes beyond 5e-2 within 2 %)")
    require(dz[:, 0].max().item() < 5e-2, f"{name}: c_0 within 5e-2 of the plain route")
    require(fk >= 0.99 and abs(fk - fp) <= 0.005, f"{name}: conv >= 0.99, within 0.5 pp")
    return dz.max().item()


def kernel_route_phases(dev, tag: str, args, kernels: dict, cfg, sc, gn, dx, win,
                        dx_init, k3_ptxas: str = "") -> None:
    """Phases 12-16: the pallas_mono route (K3), the pallas route (the plain
    GN phase + K2) and the shared-H QP (K4)."""
    import torch

    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import (QPSolver, mehrotra, mehrotra_h, mehrotra_plain,
                                               step_rhs)
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    qp = sc.qp
    mI, nz = qp.G.shape
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    G, h0, Hp = f(qp.G), f(qp.h0), f(qp.Hp)
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), ipm_iters=XLA_SCHED,
              alphas=LADDER, device=dev)
    route = lambda qk, sqp_iters=2, **extra: make_lbmpc_solver_fused(
        qp, sc.A, sc.B, sc.ocp.Ks, sc.w, qp_kernel=qk, sqp_iters=sqp_iters, **kw, **extra)
    z0 = torch.zeros(BATCH, nz, dtype=torch.float32, device=dev)
    none = route_none()

    # ---- phase 12: K3 against its plain version and against K1 -> K2 -----------
    log(f"phase 12: K3 gn_mehrotra vs plain and vs K1 -> K2 cold, batch {BATCH}, "
        f"ipm {XLA_SCHED}, the inputs of a real solve's two GN iterations")
    z1 = route("pallas_mono", sqp_iters=1)(dx, win, z0)[0]
    monos = {it: MonoPhase(gn, G, h0, Hp, it) for it in XLA_SCHED}
    k3_err = k3_held = 0.0
    for zname, zin in (("z0", z0), ("z1", z1)):
        for it, mono in monos.items():
            e, d, mu, g = mono(zin, dx, win)
            ep, dp, mup, gp = mono.plain(zin, dx, win)
            e1, H1, g1 = gn(zin, dx, win)
            x2, mu2, _ = mehrotra_h(G, H1, g1, step_rhs(h0, Hp, G, dx, zin), it)
            torch.cuda.synchronize()
            # the K1 class (phase 2): near the optimum g = 2 J'e is small
            # by cancellation, so its roundoff scales with H, not with g
            hmax = H1.abs().max().item()
            ee, eg = (e - ep).abs().max().item(), (g - gp).abs().max().item()
            log(f"  {zname}, {it} iters: max|H|={hmax:.4g} max|g|={gp.abs().max().item():.4g} "
                f"error e={ee:.3e} g={eg:.3e}; mu>=1e-6 on "
                f"{(~(mu < 1e-6)).float().mean().item():.4f} of lanes")
            eg = max(ee, eg)
            require(eg <= 1e-5 * hmax, f"K3 e and g within 1e-5 max|H| ({zname}, {it} iters)")
            d_all, d_held = qp_step_gates(f"K3 vs plain ({zname}, {it} iters)",
                                          d, mu, dp, mup, it <= 8)
            k3_err, k3_held = max(k3_err, eg, d_all), max(k3_held, eg, d_held)
            # the same device code (gn_body.cuh, mehrotra_warp.cuh) on the same
            # inputs, with h formed in the same order (step_rhs)
            require(all(torch_equal(a, b) for a, b in ((e, e1), (g, g1), (d, x2), (mu, mu2))),
                    f"K3 equals K1 then K2 cold bit for bit ({zname}, {it} iters)")
    kernels["gn_mehrotra"].update(max_abs_err=k3_err, max_abs_err_held=k3_held)
    if args.stop_after < 13:
        return

    # ---- phase 13: the fused solves on the two routes -------------------------
    log(f"phase 13: fused SQP at batch {BATCH} on the pallas_mono and pallas routes, "
        f"ipm {XLA_SCHED}")
    solves = {"pallas_mono": route("pallas_mono"), "pallas": route("pallas")}
    mono_p, full_k = route("pallas_mono", plain=True), route("pallas_full")
    out, per = {}, {}
    for name, s in (*solves.items(), ("pallas_full", full_k)):
        torch.cuda.synchronize()
        zero_counts()
        out[name] = s(dx, win, z0)
        torch.cuda.synchronize()
        per[name] = route_counts()
    log(f"  launches per solve {per}")
    route_gates("pallas_mono vs its plain route", *out["pallas_mono"], *mono_p(dx, win, z0))
    (zm, cm), (zf, cf) = out["pallas_mono"], out["pallas_full"]
    log(f"  pallas_mono vs pallas_full (qp_warm off): max|dz|={(zm - zf).abs().max().item():.3e}"
        f" conv {cm.float().mean().item():.6f} / {cf.float().mean().item():.6f}")
    require(torch_equal(zm, zf) and torch_equal(cm, cf),
            "pallas_mono equals pallas_full without qp_warm bit for bit (z and conv)")
    route_gates("pallas vs pallas_full", *out["pallas"], *out["pallas_full"])
    require(per["pallas_mono"] == dict(none, gn_mehrotra=2), "pallas_mono: 2 K3 launches a solve")
    require(per["pallas"] == dict(none, mehrotra_h=2), "pallas: 2 K2 and no K1 launches a solve")
    if args.stop_after < 14:
        return

    # ---- phase 14: the two routes' fleets ---------------------------------------
    fcfg = dataclasses.replace(cfg, iterations=STEPS)
    fleets = {"pallas_mono": dict(backend="fused", sqp_iters=2, ipm_iters=XLA_SCHED,
                                  qp_kernel="pallas_mono", device=dev),
              "pallas": dict(backend="fused", sqp_iters=2, ipm_iters=IPM_SCHED,
                             qp_kernel="pallas", qp_warm=True, warm_chain=True, device=dev)}
    want = {"pallas_mono": dict(none, gn_mehrotra=2 * STEPS),
            "pallas": dict(none, mehrotra_h=2 * STEPS)}
    runs = {}
    for name, fkw in fleets.items():
        log(f"phase 14: {name} fused fleet, cohort {COHORT}, {STEPS} steps, {fkw}")
        _, run_k = build_fleet_episode(fcfg, **fkw)
        _, run_p = build_fleet_episode(fcfg, plain=True, **fkw)
        runs[name] = run_k
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        res = run_k(dx_init)
        torch.cuda.synchronize()
        fleet_s = time.time() - t0
        per = route_counts()
        sysH = res.sys_history
        conv_steps = res.solver_converged.float().mean(dim=0)
        log(f"  {fleet_s * 1e3 / STEPS:.3f} ms/step (host clock, first run, incl. warm-up) "
            f"conv min over steps={conv_steps.min().item():.6f} mean="
            f"{conv_steps.mean().item():.6f} launches {per} {tag}")
        require(tuple(sysH.shape) == (COHORT, STEPS + 1, 5)
                and bool(torch.isfinite(sysH).all()), f"{name} fleet history finite, (B, T+1, 5)")
        require(per == want[name], f"{name} fleet launches {want[name]}")
        require(conv_steps.min().item() >= 0.99, f"{name} fleet conv >= 0.99 every step")
        if name == "pallas_mono":
            kernels["gn_mehrotra"]["launches"] = per["gn_mehrotra"]
        res_p = run_p(dx_init[:256])
        d = (sysH[:256] - res_p.sys_history).abs()
        log(f"  first 256 lanes vs plain route: |d sys_history| median={d.median().item():.3e} "
            f"max={d.max().item():.3e}; plain conv="
            f"{res_p.solver_converged.float().mean().item():.6f}")
        require(d.median().item() < 1e-6 and d.max().item() < 5e-2,
                f"{name} fleet sys_history vs the plain route: median < 1e-6, max < 5e-2")
    if args.stop_after < 15:
        return

    # ---- phase 15: K4, the shared-H QP solver -----------------------------------
    log(f"phase 15: K4 mehrotra (shared H) vs plain on the N=20 LMPC QP, batch {COHORT}, "
        "20 iterations")
    lqp = lmpc_qp()
    rng = np.random.default_rng(5)
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((COHORT, 4))
    g4, h4 = (f(a).contiguous() for a in ((lqp.Gg @ dxs.T).T + lqp.g0,
                                           lqp.h0 + (lqp.Hp @ dxs.T).T))
    log(f"  G={lqp.G.shape}")
    k4, k4p = (QPSolver(lqp.H, lqp.G, iters=20, device=dev, plain=p) for p in (False, True))
    torch.cuda.synchronize()
    zero_counts()
    xk, ck = k4.solve(g4, h4)
    torch.cuda.synchronize()
    per = route_counts()
    kernels["mehrotra"]["launches"] = per["mehrotra"]
    require(per == dict(none, mehrotra=1), "QPSolver.solve launches K4 once")
    # the comparison: the same solve with each lane's final mu, and the
    # plain version in float64 at K4_OPT_ITERS iterations as the optimum
    xk, ck, muk = mehrotra(k4.G, k4.H, g4, h4, k4.iters)
    xp, cp, mup = mehrotra_plain(k4.G, k4.H, g4, h4, k4.iters)
    x64 = mehrotra_plain(k4.G.double(), k4.H.double(), g4.double(), h4.double(),
                         K4_OPT_ITERS)[0]
    nan_k, nan_p = xk.isnan().any(dim=1), xp.isnan().any(dim=1)
    fk, fp = ck.float().mean().item(), cp.float().mean().item()
    dl = (xk - xp).abs().amax(dim=1)
    fin, off = dl.isfinite(), ~(dl <= 5e-2)
    ek, ep = ((x.double() - x64).abs().amax(dim=1) for x in (xk, xp))
    far_k, far_p = ~(ek <= 5e-2), ~(ep <= 5e-2)
    sk, sp = far_k.float().mean().item(), far_p.float().mean().item()
    log(f"  kernel vs plain: |dx| median={(xk - xp)[fin].abs().median().item():.3e} "
        f"max={dl[fin].max().item():.3e}, lanes beyond 5e-2 {int(off.sum())} (of them with "
        f"mu < 1e-6 on both sides {int((off & (muk < 1e-6) & (mup < 1e-6)).sum())}); "
        f"lanes with a NaN: kernel {int(nan_k.sum())} plain {int(nan_p.sum())}; conv "
        f"kernel={fk:.6f} plain={fp:.6f}, flags agree on {(ck == cp).float().mean().item():.6f}")
    log(f"  against the float64 optimum ({K4_OPT_ITERS} iterations): lanes beyond 5e-2 kernel "
        f"{int(far_k.sum())} ({sk:.4f}) plain {int(far_p.sum())} ({sp:.4f})")
    # lanes apart although mu is small on both sides: which side left the optimum
    H64, g64 = k4.H.double(), g4.double()
    obj = lambda x: 0.5 * ((x.double() @ H64) * x.double()).sum(dim=1) + (g64 * x.double()).sum(dim=1)
    ok_, op_, o64 = obj(xk), obj(xp), obj(x64)
    for lane in torch.nonzero(off & (muk < 1e-6) & (mup < 1e-6))[:4, 0].tolist():
        log(f"  lane {lane}: mu kernel {muk[lane].item():.3e} plain {mup[lane].item():.3e}; "
            f"from the float64 optimum {ek[lane].item():.3e} / {ep[lane].item():.3e}; objective "
            f"{ok_[lane].item():.6f} / {op_[lane].item():.6f} (optimum {o64[lane].item():.6f})")
    require((xk - xp)[fin].abs().median().item() < 1e-6, "K4 |dx| median < 1e-6")
    require(sk <= sp + 0.005,
            "K4 as close to the float64 optimum as the plain version (share of lanes beyond "
            "5e-2 at most 0.5 pp above the plain version's)")
    require(not bool((nan_k & ck).any() or (nan_p & cp).any()),
            "K4: a lane with a NaN is flagged unconverged")
    require(fk > 0.95 and abs(fk - fp) <= 0.005,
            "K4 conv > 0.95 and within 0.5 pp of the plain version")
    kernels["mehrotra"].update(max_abs_err=dl[fin].max().item(), nan_lanes=int(nan_k.sum()),
                               far_from_float64=[int(far_k.sum()), int(far_p.sum())])
    if args.stop_after < 16:
        return

    # ---- phase 16: timings -------------------------------------------------------
    log("phase 16: pallas_mono / pallas / K4 timings")
    t = {"k3_16": cuda_ms(lambda: monos[16](z0, dx, win)),
         "k3_16_plain": cuda_ms(lambda: monos[16].plain(z0, dx, win), reps=2, warmup=1),
         "k3_8": cuda_ms(lambda: monos[8](z1, dx, win)),
         "k3_8_plain": cuda_ms(lambda: monos[8].plain(z1, dx, win), reps=2, warmup=1),
         "k4": graph_ms(lambda: k4.solve(g4, h4), reps=3),
         "k4_host": cuda_ms(lambda: k4.solve(g4, h4), reps=10),
         "k4_plain": cuda_ms(lambda: k4p.solve(g4, h4), reps=1, warmup=1),
         "mono_solve": cuda_ms(lambda: solves["pallas_mono"](dx, win, z0), reps=5),
         "pallas_solve": cuda_ms(lambda: solves["pallas"](dx, win, z0), reps=5)}
    for name, run in runs.items():
        t0 = time.time()
        run(dx_init)
        torch.cuda.synchronize()
        t[f"{name}_fleet_step"] = (time.time() - t0) * 1e3 / STEPS
    for k, v in t.items():
        log(f"  time {k} = {v:.4f} ms {tag}")
    ne = (N - 2) * 5 + 8
    b3 = {it: bound_ms(*mono_work(BATCH, N, Q, ne, nz, gn.cst.numel(), mI, it))
          for it in XLA_SCHED}
    b4 = bound_ms(*shared_qp_work(COHORT, lqp.G.shape[0], lqp.nz, 20))
    kernels["gn_mehrotra"].update(ms=t["k3_16"], plain_ms=t["k3_16_plain"], bound_ms=b3[16][0],
                                  bound_by=b3[16][1])
    kernels["mehrotra"].update(ms=t["k4"], ms_host=t["k4_host"], plain_ms=t["k4_plain"],
                               bound_ms=b4[0], bound_by=b4[1])
    k4_report(dev, tag, kernels, lqp.G.shape, COHORT)
    log(f"  bound K3 16 iters {b3[16][0]:.4f} ms ({b3[16][1]}), 8 iters {b3[8][0]:.4f} ms "
        f"({b3[8][1]}); K4 {b4[0]:.4f} ms ({b4[1]}) {tag}")
    kernels["gn_mehrotra"].update(ms_8_iters=t["k3_8"], plain_ms_8_iters=t["k3_8_plain"],
                                  bound_ms_8_iters=b3[8][0])
    narrow_k3_report(dev, tag, kernels, k3_ptxas, gn, G, h0, Hp)


def wide_phases(dev, tag: str, args, kernels: dict, dx_init) -> None:
    """Phases 17-23: the kernel routes above nz 32 — K6a/K6b (the slab-blocked
    Cholesky behind LBMPC_CHOL_BLOCKED=1), K1w (gn_wide) and K2w
    (mehrotra_h_wide) — on the DMS flagship and the uncut LBMPC_N40."""
    import os

    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.ops import chol_kernel as ck
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.qp_kernel import WidePlan, mehrotra_h, mehrotra_h_plain, step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

    f32 = torch.float32
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    shapes = {}
    for name in ("DMS_LBMPC_q100", "LBMPC_N40"):
        c = lt.make_preset(name)
        c = dataclasses.replace(c, solver=dataclasses.replace(c.solver, sqp_iters=2,
                                                              dtype="float32"))
        s = build_scenario(c)
        shapes[c.family] = (c, s, dict(family=c.family, delta=c.plant.ts,
                                       bandwidth=c.oracle.bandwidth, ridge=c.oracle.ridge,
                                       dx_ref=np.asarray(c.dx_ref)))
    dcfg, ds, dkw = shapes["casadi"]
    ncfg, ns, nkw = shapes["fmincon"]
    log(f"wide shapes: DMS flagship N={ds.qp.N} nz={ds.nz} G={ds.qp.G.shape} batch {DMS_BATCH}; "
        f"LBMPC_N40 uncut N={ns.qp.N} nz={ns.nz} G={ns.qp.G.shape} cohort {COHORT}")
    rng = np.random.default_rng(3)
    _, dwin, _ = bench_inputs(rng, DMS_BATCH, ds.nz, dev)
    x0 = np.asarray(dcfg.x_init_abs) - np.asarray(dcfg.plant.x_wp)
    ddx = f(x0 + 0.01 * rng.standard_normal((DMS_BATCH, 4)))
    dz0 = torch.zeros(DMS_BATCH, ds.nz, dtype=f32, device=dev)
    ndx, nwin, _ = bench_inputs(np.random.default_rng(6), COHORT, ns.nz, dev)
    nz0 = torch.zeros(COHORT, ns.nz, dtype=f32, device=dev)
    dms = lambda **extra: make_lbmpc_solver_fused(
        ds.qp, ds.A, ds.B, ds.ocp.Ks, ds.w, sqp_iters=2, alphas=LADDER, device=dev,
        **{**dict(dkw, ipm_iters=XLA_SCHED), **extra})

    def with_env(env: dict, build):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            return build()
        finally:
            for k, v in old.items():
                if v is None:
                    del os.environ[k]
                else:
                    os.environ[k] = v

    # ---- phase 17: K6a / K6b against K5a / K5b ---------------------------------
    log("phase 17: K6 chol_blocked vs K5 and vs plain (bit for bit), M from real xla-route "
        "solves (first and last IPM iteration, equilibrated)")
    cases = {}
    with CholRecorder() as rec:
        dms()(ddx, dwin, dz0)
    cases[f"n={ds.nz} B={DMS_BATCH}"] = (rec.first, rec.last)
    with CholRecorder() as rec:
        make_lbmpc_solver_fused(ns.qp, ns.A, ns.B, ns.ocp.Ks, ns.w, sqp_iters=2,
                                ipm_iters=XLA_SCHED, alphas=LADDER, device=dev,
                                **nkw)(ndx[:BATCH], nwin.index(torch.arange(BATCH, device=dev)),
                                       nz0[:BATCH])
    cases[f"n={ns.nz} B={BATCH}"] = (rec.first, rec.last)
    torch.cuda.synchronize()
    k6_err = {k.name: 0.0 for k in ck.BLOCKED_KERNELS}
    for shape, pairs in cases.items():
        for it, (M, b) in zip(("first", "last"), pairs):
            Lb, xb = ck.chol_factor_solve_blocked(M, b)
            xsb = ck.chol_solve_blocked(M, b)
            L, x = ck.chol_factor_solve(M, b)
            xs = ck.chol_solve(M, b)
            Lp, xp = ck.chol_factor_solve_blocked(M, b, plain=True)
            torch.cuda.synchronize()
            e = (mismatch(Lb, L), mismatch(xb, x), mismatch(xsb, xs))
            log(f"  {shape} {it} iteration: K6a vs K5a L {e[0]:.3e} x {e[1]:.3e}; "
                f"K6b vs K5b x {e[2]:.3e}; vs the plain version L {mismatch(Lb, Lp):.3e} "
                f"x {mismatch(xb, xp):.3e}; max|x|={finite_max(x):.4g}")
            require(torch_equal(Lb, L) and torch_equal(xb, x),
                    f"K6a equals K5a bit for bit (L and x) at {shape}, {it} iteration")
            require(torch_equal(xsb, xs), f"K6b equals K5b bit for bit at {shape}, {it} iteration")
            require(torch_equal(Lb, Lp) and torch_equal(xb, xp) and torch_equal(xsb, xp),
                    f"K6a and K6b equal their plain version bit for bit at {shape}, {it} "
                    "iteration")
            k6_err["chol_factor_solve_blocked"] = max(k6_err["chol_factor_solve_blocked"],
                                                      mismatch(Lb, Lp), mismatch(xb, xp))
            k6_err["chol_solve_blocked"] = max(k6_err["chol_solve_blocked"], mismatch(xsb, xp))
    # seeded SPD systems at the edges of the switch's domain (n_p >= 32: n 25
    # to 128), one lane, a ragged few and a full batch
    for n in (25, 32, 33, 64, 65, 128):
        for B in (1, 3, DMS_BATCH):
            M, b = spd_systems(dev, n, B, seed=100 * n + B)
            Lb, xb = ck.chol_factor_solve_blocked(M, b)
            xsb = ck.chol_solve_blocked(M, b)
            L, x = ck.chol_factor_solve(M, b)
            xs = ck.chol_solve(M, b)
            Lp, xp = ck.chol_factor_solve(M, b, plain=True)
            torch.cuda.synchronize()
            require(torch_equal(Lb, L) and torch_equal(xb, x) and torch_equal(Lb, Lp)
                    and torch_equal(xb, xp) and torch_equal(xsb, xs),
                    f"K6a = K5a = plain (L and x) and K6b = K5b bit for bit, seeded n={n} B={B}")
            k6_err["chol_factor_solve_blocked"] = max(k6_err["chol_factor_solve_blocked"],
                                                      mismatch(Lb, Lp), mismatch(xb, xp))
            k6_err["chol_solve_blocked"] = max(k6_err["chol_solve_blocked"], mismatch(xsb, xp))
    for k, v in k6_err.items():
        kernels[k]["max_abs_err"] = v
    if args.stop_after < 18:
        return

    # ---- phase 18: the DMS xla solve with LBMPC_CHOL_BLOCKED=1 ------------------
    log(f"phase 18: DMS flagship on the xla route with LBMPC_CHOL_BLOCKED=1, batch "
        f"{DMS_BATCH}, against the switch off; then LBMPC_CHOL_STORE=0")
    d_off = dms()
    d_on = with_env({"LBMPC_CHOL_BLOCKED": "1"}, dms)
    d_on_ns = with_env({"LBMPC_CHOL_BLOCKED": "1", "LBMPC_CHOL_STORE": "0"}, dms)
    zo, co = d_off(ddx, dwin, dz0)
    torch.cuda.synchronize()
    zero_counts()
    zb_, cb_ = d_on(ddx, dwin, dz0)
    torch.cuda.synchronize()
    per = chol_counts()
    log(f"  switch on: launches {per}; max|z - z_off|={mismatch(zb_, zo):.3e} conv "
        f"{cb_.float().mean().item():.6f} / {co.float().mean().item():.6f}")
    require(torch_equal(zb_, zo) and torch_equal(cb_, co),
            "DMS xla solve with LBMPC_CHOL_BLOCKED=1 equals it without, bit for bit (z, conv)")
    require(per == dict(chol_none(), chol_factor_solve_blocked=24, chol_resolve=24),
            "LBMPC_CHOL_BLOCKED=1: 24 K6a + 24 K5c per solve, no K5a")
    kernels["chol_factor_solve_blocked"]["launches"] = per["chol_factor_solve_blocked"]
    zero_counts()
    zn_, cn_ = d_on_ns(ddx, dwin, dz0)
    torch.cuda.synchronize()
    per = chol_counts()
    log(f"  switch on, LBMPC_CHOL_STORE=0: launches {per}; max|z - z_off|="
        f"{mismatch(zn_, zo):.3e}")
    require(per == dict(chol_none(), chol_solve_blocked=48),
            "LBMPC_CHOL_BLOCKED=1 with LBMPC_CHOL_STORE=0: 48 K6b per solve, nothing else")
    require(torch_equal(zn_, zo) and torch_equal(cn_, co),
            "LBMPC_CHOL_STORE=0 on K6b equals the K5 store route bit for bit (z, conv)")
    kernels["chol_solve_blocked"]["launches"] = per["chol_solve_blocked"]
    xla_conv = co.float().mean().item()
    if args.stop_after < 19:
        return

    # ---- phase 19: K1w against its plain version ---------------------------------
    log("phase 19: K1w gn_wide vs plain at the DMS and the uncut N40 shapes")
    gns = {"casadi": GNPhase(ds.qp, ds.A, ds.B, ds.ocp.Ks, ds.w, device=dev, **dkw),
           "fmincon": GNPhase(ns.qp, ns.A, ns.B, ns.ocp.Ks, ns.w, device=dev, **nkw)}
    gin = {"casadi": (dz0, ddx, dwin), "fmincon": (nz0, ndx, nwin)}
    k1w = {}
    err = 0.0
    for fam, gn in gns.items():
        require(gn.wide and not gn.narrow, f"{fam}: GNPhase routes to K1w")
        zero_counts()
        e_k, H_k, g_k = gn(*gin[fam])
        torch.cuda.synchronize()
        per = route_counts()
        e_p, H_p, g_p = gn.plain(*gin[fam])
        hmax = H_p.abs().max().item()
        errs = [(a - b).abs().max().item() for a, b in ((e_k, e_p), (H_k, H_p), (g_k, g_p))]
        log(f"  {fam} B={e_k.shape[0]}: max|H|={hmax:.6g} max err e={errs[0]:.3e} "
            f"H={errs[1]:.3e} g={errs[2]:.3e} (relative to max|H|: {max(errs) / hmax:.3e}); "
            f"launches {per}")
        require(all(np.isfinite(errs)) and max(errs) <= 1e-5 * hmax,
                f"K1w e, H, g within 1e-5 * max|H| of the plain version ({fam})")
        require(torch_equal(H_k, H_k.transpose(1, 2)), f"K1w H exactly symmetric ({fam})")
        require(per == dict(route_none(), gn_wide=1), f"K1w launched once, nothing else ({fam})")
        err = max(err, max(errs))
        k1w[fam] = (H_k, g_k)
    kernels["gn_wide"]["max_abs_err"] = err
    if args.stop_after < 20:
        return

    # ---- phase 20: K2w against its plain version ---------------------------------
    log("phase 20: K2w mehrotra_h_wide vs plain on the QPs built from K1w's H and g")
    k2w_err = k2w_held = 0.0
    qps, plans = {}, {}
    for fam, (c, s, _) in shapes.items():
        zz, dd, _ = gin[fam]
        G = f(s.qp.G)
        h = step_rhs(f(s.qp.h0), f(s.qp.Hp), G, dd, zz)
        qps[fam] = (G, *k1w[fam], h)
        plans[fam] = WidePlan(G)
    for fam, it in (("casadi", 8), ("casadi", 16), ("fmincon", 8), ("fmincon", 16)):
        G, H, g, h = qps[fam]
        pl = plans[fam]
        zero_counts()
        x, mu, st = mehrotra_h(G, H, g, h, it, want_state=True, plan=pl)
        torch.cuda.synchronize()
        per = route_counts()
        xp, mup, _ = mehrotra_h_plain(G, H, g, h, it)
        x64 = mehrotra_h_plain(G.double(), H.double(), g.double(), h.double(), it)[0]
        require(per == dict(route_none(), mehrotra_h_wide=1),
                f"K2w launched once, nothing else ({fam}, {it} iters)")
        name = f"K2w vs plain ({fam}, {it} iters)"
        if fam == "fmincon" and it == 8:
            d_all, d_held = qp_step_gates(name, x, mu, xp, mup, True)
        else:
            d_all, d_held = f64_gates(name, x, mu, xp, mup, x64)
        k2w_err, k2w_held = max(k2w_err, d_all), max(k2w_held, d_held)
        xc, muc, _ = mehrotra_h(G, H, g, h, it, warm=(torch.clamp(h, min=1.0),
                                                      torch.ones_like(h)), plan=pl)
        require(torch_equal(xc, x) and torch_equal(muc, mu),
                f"K2w cold_state warm-in equals the cold solve bit for bit ({fam}, {it} iters)")
        if it == 8:
            xw, muw, _ = mehrotra_h(G, H, g, h, 2, warm=st, plan=pl)
            xwp, muwp, _ = mehrotra_h_plain(G, H, g, h, 2, warm=st)
            st64 = tuple(a.double() for a in st)
            f64_gates(f"K2w vs plain ({fam}, 2 iters warm from K2w's 8)", xw, muw, xwp, muwp,
                      mehrotra_h_plain(G.double(), H.double(), g.double(), h.double(), 2,
                                       warm=st64)[0])
    kernels["mehrotra_h_wide"].update(max_abs_err=k2w_err, max_abs_err_held=k2w_held)
    if args.stop_after < 21:
        return

    # ---- phase 21: the DMS flagship on the kernel routes --------------------------
    log(f"phase 21: DMS flagship fused SQP at batch {DMS_BATCH} on pallas_full, pallas "
        "(ipm (16, 8)) and the pallas_full warm chain (ipm (16, 2), qp_warm)")
    routes = {"pallas_full": dict(qp_kernel="pallas_full"),
              "pallas": dict(qp_kernel="pallas"),
              "pallas_full warm": dict(qp_kernel="pallas_full", ipm_iters=(16, 2),
                                       qp_warm=True)}
    want = {"pallas_full": dict(route_none(), gn_wide=2, mehrotra_h_wide=2),
            "pallas": dict(route_none(), mehrotra_h_wide=2),
            "pallas_full warm": dict(route_none(), gn_wide=2, mehrotra_h_wide=2)}
    dsolvers = {}
    for name, extra in routes.items():
        sk, sp = dms(**extra), dms(plain=True, **extra)
        dsolvers[name] = (sk, sp)
        torch.cuda.synchronize()
        zero_counts()
        zk, ckv = sk(ddx, dwin, dz0)
        torch.cuda.synchronize()
        per = route_counts()
        zp, cpv = sp(ddx, dwin, dz0)
        log(f"  {name}: launches {per}; conv kernel {ckv.float().mean().item():.6f}, plain "
            f"route {cpv.float().mean().item():.6f}, xla route {xla_conv:.6f}")
        anchored_route_gates(f"DMS {name}", zk, ckv, zp, cpv, zo)
        require(per == want[name], f"DMS {name}: launches {want[name]}")
    if args.stop_after < 22:
        return

    # ---- phase 22: the uncut LBMPC_N40 warm-chain hybrid fleet ---------------------
    log(f"phase 22: uncut LBMPC_N40 warm-chain hybrid fleet on pallas_full, cohort {COHORT}, "
        f"{STEPS} steps (this slice's main path)")
    fcfg = dataclasses.replace(ncfg, iterations=STEPS)
    fleet_kw = dict(backend="hybrid", ipm_iters=IPM_SCHED, sqp_iters=2, qp_warm=True,
                    warm_chain=True, qp_kernel="pallas_full", device=dev)
    _, run_k = build_fleet_episode(fcfg, **fleet_kw)
    _, run_p = build_fleet_episode(fcfg, plain=True, **fleet_kw)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    res = run_k(dx_init)
    torch.cuda.synchronize()
    fleet_s = time.time() - t0
    per = route_counts()
    conv_steps = res.solver_converged.float().mean(dim=0)
    sysH = res.sys_history
    log(f"  {fleet_s * 1e3 / STEPS:.3f} ms/step (host clock, first run, incl. warm-up) "
        f"launches {per} {tag}")
    log("  conv per step: " + " ".join(f"{v:.6f}" for v in conv_steps.tolist()))
    require(tuple(sysH.shape) == (COHORT, STEPS + 1, 5) and bool(torch.isfinite(sysH).all()),
            "N40 fleet history finite, (B, T+1, 5)")
    require(conv_steps.min().item() >= 0.99, "N40 fleet conv >= 0.99 every step")
    require(per["gn_wide"] > 0 and per["mehrotra_h_wide"] > 0
            and per == dict(route_none(), gn_wide=per["gn_wide"],
                            mehrotra_h_wide=per["mehrotra_h_wide"]),
            "N40 fleet launches K1w and K2w only")
    for k in ("gn_wide", "mehrotra_h_wide"):
        kernels[k]["launches"] = per[k]
    # the plain route on the same cohort: its batched torch products round
    # by B (cuBLAS picks their kernels by the batch), so its run of the
    # first 256 lanes alone parts from its cohort run (logged below) and
    # is not what the kernel route's cohort is held to
    res_p = run_p(dx_init)
    d = (sysH[:256] - res_p.sys_history[:256]).abs()
    log(f"  first 256 lanes vs plain route: |d sys_history| median={d.median().item():.3e} "
        f"max={d.max().item():.3e}; plain conv="
        f"{res_p.solver_converged[:256].float().mean().item():.6f}")
    require(d.median().item() < 1e-6 and d.max().item() < 5e-2,
            "N40 fleet sys_history vs the plain route: median < 1e-6, max < 5e-2")
    k256, p256 = run_k(dx_init[:256]), run_p(dx_init[:256])
    log(f"  the first 256 lanes alone: kernel route bit for bit its cohort's "
        f"{torch_equal(k256.sys_history, sysH[:256])}; plain route |d| max "
        f"{(p256.sys_history - res_p.sys_history[:256]).abs().max().item():.3e} from its "
        f"cohort's, {(p256.sys_history - sysH[:256]).abs().max().item():.3e} from the kernel "
        f"route's")
    require(torch_equal(k256.sys_history, sysH[:256])
            and torch_equal(k256.solver_converged, res.solver_converged[:256]),
            "N40 fleet: the kernel route's first 256 lanes alone equal its cohort's, bit for bit")
    if args.stop_after < 23:
        return

    # ---- phase 23: timings -----------------------------------------------------------
    log("phase 23: K1w / K2w / K6 timings and the wide solves and fleet")
    t = {}
    for fam, gn in gns.items():
        t[f"k1w_{fam}"] = graph_ms(lambda: gn(*gin[fam]))
        t[f"k1w_{fam}_plain"] = cuda_ms(lambda: gn.plain(*gin[fam]), reps=3)
    k1w_report(dev, tag, kernels, gns, gin)
    for fam in ("casadi", "fmincon"):
        G, H, g, h = qps[fam]
        pl = plans[fam]
        st = mehrotra_h(G, H, g, h, 8, want_state=True, plan=pl)[2]
        for it in (16, 8):
            t[f"k2w_{fam}_{it}"] = cuda_ms(lambda: mehrotra_h(G, H, g, h, it, want_state=True,
                                                              plan=pl), reps=3)
            t[f"k2w_{fam}_{it}_plain"] = cuda_ms(lambda: mehrotra_h_plain(G, H, g, h, it),
                                                 reps=2, warmup=1)
        t[f"k2w_{fam}_2"] = cuda_ms(lambda: mehrotra_h(G, H, g, h, 2, warm=st, plan=pl), reps=5)
    k6_report(dev, tag, kernels, [(label, *cases[label][1]) for label in cases])
    for name, (sk, sp) in dsolvers.items():
        t[f"dms_{name.replace(' ', '_')}_solve"] = cuda_ms(lambda: sk(ddx, dwin, dz0), reps=3,
                                                           warmup=1)
    t["dms_xla_blocked_solve"] = cuda_ms(lambda: d_on(ddx, dwin, dz0), reps=2, warmup=1)
    t["dms_xla_solve"] = cuda_ms(lambda: d_off(ddx, dwin, dz0), reps=2, warmup=1)
    t0 = time.time()
    run_k(dx_init)
    torch.cuda.synchronize()
    t["n40_fleet_step"] = (time.time() - t0) * 1e3 / STEPS
    for k, v in t.items():
        log(f"  time {k} = {v:.4f} ms {tag}")
    # the bounds at the main path's shapes: K1w and K2w at the N40 cohort
    ne = (ns.qp.N - 2) * 5 + 8
    mI_n = ns.qp.G.shape[0]
    b1 = bound_ms(*gn_work(COHORT, ns.qp.N, Q, ne, ns.nz, gns["fmincon"].cst.numel()))
    # K2w's bounds, structural (G's nonzeros: the work the kernel's data
    # needs) and dense
    b2, b2d = (bound_ms(*qp_work(COHORT, mI_n, ns.nz, IPM_SCHED[0], False, True, G_))
               for G_ in (ns.qp.G, None))
    kernels["gn_wide"].update(ms=t["k1w_fmincon"], plain_ms=t["k1w_fmincon_plain"],
                              bound_ms=b1[0], bound_by=b1[1])
    kernels["mehrotra_h_wide"].update(ms=t["k2w_fmincon_8"], plain_ms=t["k2w_fmincon_8_plain"],
                                      bound_ms=b2[0], bound_by=b2[1], bound_ms_dense=b2d[0])
    dne = ds.qp.N * 5 + 8
    bd1 = bound_ms(*gn_work(DMS_BATCH, ds.qp.N, Q, dne, ds.nz, gns["casadi"].cst.numel()))
    bd2 = {(it, kind): bound_ms(*qp_work(DMS_BATCH, ds.qp.G.shape[0], ds.nz, it, False, True,
                                         G_))
           for it in (16, 8) for kind, G_ in (("structural", ds.qp.G), ("dense", None))}
    log(f"  bound K1w N40 cohort {b1[0]:.4f} ms ({b1[1]}), DMS {bd1[0]:.4f} ms ({bd1[1]}) "
        f"{tag}")
    log(f"  bound K2w structural / dense: N40 8 iters {b2[0]:.4f} / {b2d[0]:.4f} ms "
        f"({b2[1]}); DMS 16 iters {bd2[(16, 'structural')][0]:.4f} / "
        f"{bd2[(16, 'dense')][0]:.4f} ms, 8 iters {bd2[(8, 'structural')][0]:.4f} / "
        f"{bd2[(8, 'dense')][0]:.4f} ms ({bd2[(8, 'structural')][1]}) {tag}")
    split_k2w(dev, tag, [(f"DMS {it} iters", qps["casadi"], plans["casadi"], it, None)
                         for it in (16, 8)]
              + [("N40 8 iters", qps["fmincon"], plans["fmincon"], 8, None),
                 ("N40 2 iters warm", qps["fmincon"], plans["fmincon"], 2,
                  mehrotra_h(*qps["fmincon"], 8, want_state=True, plan=plans["fmincon"])[2])])


def narrow_split_tool():
    """tools/k2_split.py: K2's and K3's phase-clock builds and readers."""
    split_tool()
    import k2_split

    return k2_split


def narrow_inputs(dev, gn, G, h0, Hp, B: int, seed: int = 2) -> dict:
    """The bench QP at batch B on seeded inputs (H and g from K1, h in
    step_rhs's order), in tools/k2_split.py's layout."""
    from lbmpc_tpu_torch.ops.qp_kernel import step_rhs

    dx, win, z = bench_inputs(np.random.default_rng(seed), B, G.shape[1], dev)
    _, H, g = gn(z, dx, win)
    return dict(gn=gn, G=G, h0=h0, Hp=Hp, H=H, g=g, h=step_rhs(h0, Hp, G, dx, z),
                ins=(z, dx, win))


def narrow_cut(qp: dict, B: int, dev) -> dict:
    """The first B lanes of narrow_inputs' batch."""
    import torch

    z, dx, win = qp["ins"]
    c = lambda a: a[:B].contiguous()
    return dict(qp, H=c(qp["H"]), g=c(qp["g"]), h=c(qp["h"]),
                ins=(c(z), c(dx), win.index(torch.arange(B, device=dev))))


def narrow_k2_report(dev, tag: str, kernels: dict, ptxas: str, gn, G, h0, Hp) -> None:
    """Phase 6's K2 report: its times at 8 cold and 2 warm iterations at
    batch 2048, the cohort and the repair's K, its lanes a block and an SM,
    its ptxas registers and spills, and its split by phase (the clocked
    build of tools/k2_split.py, at batch 2048)."""
    from lbmpc_tpu_torch.ops import mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h, narrow_launch

    tool = narrow_split_tool()
    mI, nz = G.shape
    big = narrow_inputs(dev, gn, G, h0, Hp, COHORT)
    log(f"  K2 ptxas: {ptxas} {tag}")
    by_batch = {}
    for B in (BATCH, COHORT, REPAIR_K):
        qp = narrow_cut(big, B, dev)
        H, g, h = qp["H"], qp["g"], qp["h"]
        st = mehrotra_h(G, H, g, h, IPM_SCHED[0], want_state=True)[2]
        t8 = cuda_ms(lambda: mehrotra_h(G, H, g, h, IPM_SCHED[0], want_state=True), reps=10)
        t2 = cuda_ms(lambda: mehrotra_h(G, H, g, h, IPM_SCHED[1], warm=st), reps=10)
        warps, blocks, smem = narrow_launch(mI, nz, B, sms=qp_kernel.sm_count(dev))
        lanes = tool.resident_lanes(qp_kernel.KERNEL, mI, nz, 0, warps)
        require(tool.smem_bytes(qp_kernel.KERNEL, mI, nz, 0, warps) == smem,
                f"K2's shared memory at B={B} is the host's narrow_smem_bytes ({smem} B)")
        by_batch[B] = [t8, t2]
        log(f"  time k2 B={B}: {IPM_SCHED[0]} iters {t8:.4f} ms, {IPM_SCHED[1]} warm "
            f"{t2:.4f} ms; {warps} lanes a block, {blocks} blocks, {smem} B shared, "
            f"{lanes} lanes an SM {tag}")
    kernels["mehrotra_h"].update(ms_by_batch={str(k): v for k, v in by_batch.items()},
                                 ms_2_iters=by_batch[BATCH][1], ptxas=ptxas)
    qp = narrow_cut(big, BATCH, dev)
    st = mehrotra_h(G, qp["H"], qp["g"], qp["h"], IPM_SCHED[0], want_state=True)[2]
    tool.split_cases(qp, tool.kernels(clocked=True),
                     {"k2": qp_kernel.KERNEL, "k3": mono_kernel.KERNEL},
                     [("k2", IPM_SCHED[0], None), ("k2", IPM_SCHED[1], st)],
                     lambda c: log(f"  split K2 B={c['B']} {c['iters']}"
                                   f"{' warm' if c['warm'] else ''} iters: "
                                   f"{split_tool().format_split(c)} {tag}"))


def narrow_k3_report(dev, tag: str, kernels: dict, ptxas: str, gn, G, h0, Hp) -> None:
    """Phase 16's K3 report, as narrow_k2_report's for K2: at 16 and 8
    iterations (the xla route's schedule)."""
    from lbmpc_tpu_torch.ops import mono_kernel, qp_kernel
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import narrow_launch

    tool = narrow_split_tool()
    mI, nz = G.shape
    big = narrow_inputs(dev, gn, G, h0, Hp, COHORT, seed=7)
    monos = {it: MonoPhase(gn, G, h0, Hp, it) for it in XLA_SCHED}
    log(f"  K3 ptxas: {ptxas} {tag}")
    by_batch = {}
    for B in (BATCH, COHORT, REPAIR_K):
        ins = narrow_cut(big, B, dev)["ins"]
        by_batch[B] = [cuda_ms(lambda: monos[it](*ins), reps=5) for it in XLA_SCHED]
        warps, blocks, smem = narrow_launch(mI, nz, B, q=Q, sms=qp_kernel.sm_count(dev))
        lanes = tool.resident_lanes(mono_kernel.KERNEL, mI, nz, Q, warps)
        require(tool.smem_bytes(mono_kernel.KERNEL, mI, nz, Q, warps) == smem,
                f"K3's shared memory at B={B} is the host's narrow_smem_bytes ({smem} B)")
        log(f"  time k3 B={B}: {XLA_SCHED[0]} iters {by_batch[B][0]:.4f} ms, {XLA_SCHED[1]} "
            f"iters {by_batch[B][1]:.4f} ms; {warps} lanes a block, {blocks} blocks, {smem} B "
            f"shared, {lanes} lanes an SM {tag}")
    kernels["gn_mehrotra"].update(ms_by_batch={str(k): v for k, v in by_batch.items()},
                                  ptxas=ptxas)
    tool.split_cases(narrow_cut(big, BATCH, dev), tool.kernels(clocked=True),
                     {"k2": qp_kernel.KERNEL, "k3": mono_kernel.KERNEL},
                     [("k3", it, None) for it in XLA_SCHED],
                     lambda c: log(f"  split K3 B={c['B']} {c['iters']} iters (loop): "
                                   f"{split_tool().format_split(c)} {tag}"))


def compare_tool():
    """tools/k1w_k5_compare.py: ptxas summaries and K1w's and K5's shared
    memory and lanes an SM as the kernels compute them."""
    split_tool()
    import k1w_k5_compare

    return k1w_k5_compare


def chol_report(dev, tag: str, kernels: dict, runs) -> None:
    """Phase 11's K5 report: K5a's, K5b's and K5c's device time on each
    (label, M, b) of `runs` (the last IPM iteration's systems: the fleet's
    n=21 at the cohort and at batch 2048, the DMS flagship's n=101), with
    the lanes a block the host picks, the lanes an SM the kernel holds, and
    the kernel's shared memory held to the host's."""
    from lbmpc_tpu_torch.ops import chol_kernel as ck
    from lbmpc_tpu_torch.ops.qp_kernel import sm_count

    tool = compare_tool()
    rows = {k.name: {"ms_by_batch": {}, "lanes_a_block": {}, "lanes_an_sm": {}}
            for k in ck.KERNELS}
    for label, M, b in runs:
        B, n = b.shape
        L = ck.chol_factor_solve(M, b)[0]
        calls = {"chol_factor_solve": lambda: ck.chol_factor_solve(M, b),
                 "chol_solve": lambda: ck.chol_solve(M, b),
                 "chol_resolve": lambda: ck.chol_resolve(L, b)}
        lanes, blocks, smem = ck.chol_launch(n, B, sms=sm_count(dev))
        for kind, (name, fn) in enumerate(calls.items()):
            c_smem, resident = tool.k5_shape(ck.FACTOR_SOLVE, kind, n, lanes)
            require(c_smem == smem, f"{name}'s shared memory at {label} is the host's "
                    f"chol_smem_bytes ({smem} B)")
            ms = graph_ms(fn)
            rows[name]["ms_by_batch"][label] = ms
            rows[name]["lanes_a_block"][label] = lanes
            rows[name]["lanes_an_sm"][label] = resident
            log(f"  time {name} {label}: {ms:.4f} ms (device); {lanes} lanes a block, "
                f"{blocks} blocks, {smem} B shared, {resident} lanes an SM {tag}")
    for name, row in rows.items():
        kernels[name].update(row)


def spd_systems(dev, n: int, B: int, seed: int):
    """A seeded batch of SPD systems (M, b), equilibrated as the IPM's are
    (unit diagonal)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(B, n, n, device=dev, generator=gen)
    M = A @ A.transpose(1, 2) + n * torch.eye(n, device=dev)
    dg = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2))
    return ((M * dg[:, :, None] * dg[:, None, :]).contiguous(),
            torch.randn(B, n, device=dev, generator=gen))


def k6_tool():
    """tools/k6_compare.py: K6's shared memory and lanes an SM as the kernel
    computes them."""
    split_tool()
    import k6_compare

    return k6_compare


def k6_report(dev, tag: str, kernels: dict, runs) -> None:
    """Phase 23's K6 report: K6a's and K6b's device time (graph replay) on
    each (label, M, b) of `runs` (the last IPM iteration's systems: the DMS
    flagship's n=101 at batch 1024 and the uncut N40's n=41 at 2048) beside
    K5a's and K5b's (the same function) and the host-clocked reading
    (ms_host), with the warps a lane and lanes a block the host picks, the
    lanes an SM the kernel holds, and the kernel's shared memory held to the
    host's; at the first, the plain version, the library pair and the
    bound."""
    import torch

    from lbmpc_tpu_torch.ops import chol_kernel as ck
    from lbmpc_tpu_torch.ops.qp_kernel import sm_count

    calls = {"chol_factor_solve_blocked": ("chol_factor_solve", ck.chol_factor_solve_blocked,
                                           ck.chol_factor_solve),
             "chol_solve_blocked": ("chol_solve", ck.chol_solve_blocked, ck.chol_solve)}
    keys = ("ms_by_batch", "ms_host_by_batch", "k5_ms_by_batch", "bound_ms_by_batch",
            "warps_a_lane", "lanes_a_block", "lanes_an_sm")
    rows = {name: {k: {} for k in keys} for name in calls}
    for i, (label, M, b) in enumerate(runs):
        B, n = b.shape
        warps, lanes, blocks, smem = ck.blocked_launch(n, B, sms=sm_count(dev))
        for kind, (name, (k5name, k6, k5)) in enumerate(calls.items()):
            c_smem, resident = k6_tool().c_shape(ck.FACTOR_SOLVE_BLOCKED, kind, n, warps, lanes)
            require(c_smem == smem, f"{name}'s shared memory at {label} is the host's "
                    f"blocked_smem_bytes ({smem} B)")
            ms, ms5 = graph_ms(lambda: k6(M, b)), graph_ms(lambda: k5(M, b))
            host = cuda_ms(lambda: k6(M, b))
            bd, bd_by = bound_ms(*chol_work(k5name, B, n))
            for k, val in zip(keys, (ms, host, ms5, bd, warps, lanes, resident)):
                rows[name][k][label] = val
            log(f"  time {name} {label}: {ms:.4f} ms (device; host-clocked {host:.4f}), "
                f"{k5name} {ms5:.4f} ms, bound {bd:.4f} ms ({bd_by}); {warps} warps a lane, "
                f"{lanes} lanes a block, {blocks} blocks, {smem} B shared, {resident} lanes "
                f"an SM {tag}")
            if i == 0:
                lib = lambda: torch.cholesky_solve(b[..., None], torch.linalg.cholesky_ex(M)[0])
                pms, lms = cuda_ms(lambda: k6(M, b, plain=True), reps=3), cuda_ms(lib, reps=5)
                kernels[name].update(ms=ms, ms_host=host, plain_ms=pms, library_ms=lms,
                                     bound_ms=bd, bound_by=bd_by)
                log(f"  time {name} {label}: plain {pms:.4f} ms, library {lms:.4f} ms {tag}")
    for name, row in rows.items():
        kernels[name].update(row)


def k1k4_tool():
    """tools/k1_k4_compare.py: K1's and K4's shared memory and lanes an SM as
    the kernels compute them."""
    split_tool()
    import k1_k4_compare

    return k1_k4_compare


def k1_report(dev, tag: str, kernels: dict, gn) -> None:
    """Phase 6's K1 report: its device time (graph replay) at the cohort,
    batch 2048 and the repair's K on seeded bench inputs, with the lanes a
    block the host picks, the lanes an SM the kernel holds, and the
    kernel's shared memory held to the host's."""
    import torch

    from lbmpc_tpu_torch.ops import gn_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import narrow_gn_launch
    from lbmpc_tpu_torch.ops.qp_kernel import sm_count

    dx, win, z = bench_inputs(np.random.default_rng(2), COHORT, gn.nz, dev)
    row = {"ms_by_batch": {}, "lanes_a_block": {}, "lanes_an_sm": {}}
    for B in (COHORT, BATCH, REPAIR_K):
        ins = (z[:B].contiguous(), dx[:B].contiguous(), win.index(torch.arange(B, device=dev)))
        lanes, blocks, smem = narrow_gn_launch(gn.nz, Q, B, sms=sm_count(dev))
        c_smem, resident = k1k4_tool().launch_shape(gn_kernel.KERNEL, "gn_phase", gn.nz, Q,
                                                    lanes)
        require(c_smem == smem, f"K1's shared memory at B={B} is the host's "
                f"narrow_gn_smem_bytes ({smem} B)")
        ms = graph_ms(lambda: gn(*ins))
        row["ms_by_batch"][str(B)] = ms
        row["lanes_a_block"][str(B)] = lanes
        row["lanes_an_sm"][str(B)] = resident
        log(f"  time k1 B={B}: {ms:.4f} ms (device); {lanes} lanes a block, {blocks} blocks, "
            f"{smem} B shared, {resident} lanes an SM {tag}")
    kernels["gn_phase"].update(row)


def k4_report(dev, tag: str, kernels: dict, shape: tuple, B: int) -> None:
    """Phase 16's K4 launch report at (mI, nz) = shape and batch B: the lanes
    a block the host picks, the lanes an SM the kernel holds, and the
    kernel's shared memory held to the host's."""
    from lbmpc_tpu_torch.ops import qp_kernel
    from lbmpc_tpu_torch.ops.qp_kernel import shared_launch, sm_count

    mI, nz = shape
    lanes, blocks, smem = shared_launch(mI, nz, B, sms=sm_count(dev))
    c_smem, resident = k1k4_tool().launch_shape(qp_kernel.KERNEL_SHARED, "mehrotra", mI, nz,
                                                lanes)
    require(c_smem == smem, f"K4's shared memory at B={B} is the host's shared_smem_bytes "
            f"({smem} B)")
    kernels["mehrotra"].update(lanes_a_block=lanes, lanes_an_sm=resident)
    log(f"  K4 B={B}: {lanes} lanes a block, {blocks} blocks, {smem} B shared, {resident} "
        f"lanes an SM {tag}")


def k1w_report(dev, tag: str, kernels: dict, gns: dict, gin: dict) -> None:
    """Phase 23's K1w report: its device time at the N40 shape at the
    cohort, batch 2048 and the repair's K, and at the DMS flagship's batch,
    with the lanes a block the host picks, the lanes an SM the kernel holds,
    and the kernel's shared memory held to the host's."""
    import torch

    from lbmpc_tpu_torch.ops import gn_kernel
    from lbmpc_tpu_torch.ops.gn_kernel import wide_launch
    from lbmpc_tpu_torch.ops.qp_kernel import sm_count

    tool = compare_tool()
    row = {"ms_by_batch": {}, "lanes_a_block": {}, "lanes_an_sm": {}}
    for fam, batches in (("fmincon", (COHORT, BATCH, REPAIR_K)), ("casadi", (DMS_BATCH,))):
        gn = gns[fam]
        z, dx, win = gin[fam]
        q = win.X.shape[-2]
        for B in batches:
            idx = torch.arange(B, device=dev)
            ins = (z[:B].contiguous(), dx[:B].contiguous(), win.index(idx))
            lanes, blocks, smem = wide_launch(gn.nz, q, B, sms=sm_count(dev))
            c_smem, resident = tool.k1w_shape(gn_kernel.KERNEL_WIDE, gn.nz, q, lanes,
                                              fam == "casadi")
            require(c_smem == smem, f"K1w's shared memory at nz={gn.nz} B={B} is the host's "
                    f"wide_smem_bytes ({smem} B)")
            label = f"nz={gn.nz} B={B}"
            ms = graph_ms(lambda: gn(*ins))
            row["ms_by_batch"][label] = ms
            row["lanes_a_block"][label] = lanes
            row["lanes_an_sm"][label] = resident
            log(f"  time k1w {fam} {label}: {ms:.4f} ms (device); {lanes} lanes a block, "
                f"{blocks} blocks, {smem} B shared, {resident} lanes an SM {tag}")
    kernels["gn_wide"].update(row)


def split_tool():
    """tools/k2w_split.py: K2w's and K3w's phase-clock builds and readers."""
    if str(ROOT / "tools") not in sys.path:
        sys.path.insert(0, str(ROOT / "tools"))
    import k2w_split

    return k2w_split


def split_k2w(dev, tag: str, cases) -> None:
    """Log K2w's time by phase on each (name, (G, H, g, h), plan, iters,
    warm) case: one launch of the phase-clock build (its own launch count,
    not the package kernel's), the share of a block's cycles per phase."""
    from lbmpc_tpu_torch.ops import qp_kernel

    tool = split_tool()
    k = tool.clocked_kernels()["k2w"]
    read = tool.reader(k)
    package, qp_kernel.KERNEL_WIDE = qp_kernel.KERNEL_WIDE, k
    try:
        for name, (G, H, g, h), plan, it, warm in cases:
            qp_kernel.mehrotra_h(G, H, g, h, it, warm=warm, want_state=True, plan=plan)
            split = tool.read_split(read, min(g.shape[0], tool.CLOCK_BLOCKS), it)
            log(f"  split K2w {name}: {tool.format_split(split)} {tag}")
    finally:
        qp_kernel.KERNEL_WIDE = package


def split_k3w(dev, tag: str, cases) -> None:
    """Log K3w's Mehrotra loop by phase on each (name, MonoPhase, inputs,
    iters) case, as split_k2w does for K2w."""
    from lbmpc_tpu_torch.ops import mono_kernel

    tool = split_tool()
    k = tool.clocked_kernels()["k3w"]
    read = tool.reader(k)
    package, mono_kernel.KERNEL_WIDE = mono_kernel.KERNEL_WIDE, k
    try:
        for name, mono, ins, it in cases:
            mono(*ins)
            split = tool.read_split(read, min(ins[0].shape[0], tool.CLOCK_BLOCKS), it)
            log(f"  split K3w {name}: {tool.format_split(split)} {tag}")
    finally:
        mono_kernel.KERNEL_WIDE = package


def family_inputs(seed: int, B: int, cfg, nz: int, device):
    """bench_inputs for a preset's family: dx around its start (fmincon: the
    delta dx_init; casadi: x_init_abs - x_wp), a random window, a small z."""
    import torch

    rng = np.random.default_rng(seed)
    dx, win, z = bench_inputs(rng, B, nz, device)
    if cfg.family == "casadi":
        x0 = np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp)
        dx = torch.as_tensor(x0 + 0.01 * rng.standard_normal((B, 4)), dtype=torch.float32,
                             device=device)
    return dx, win, z


def mono_wide_phases(dev, tag: str, args, kernels: dict, cfg, dx_init) -> None:
    """Phases 24-29: pallas_mono above nz 32 and for the casadi family (K3w
    gn_mehrotra_wide), the per-problem SQP behind the vmapped repair and the
    deferred-repair fleet solver, and the golden-parity episodes."""
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.sqp_fused import (MONO_TILE, make_lbmpc_solver_fleet,
                                                       make_lbmpc_solver_fused, mono_vmem_need)
    from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
    from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h, mehrotra_h_plain, step_rhs
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

    f32 = torch.float32
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    shapes = {}
    for fam, name, N_ in (("fmincon", "LBMPC_N40", None), ("casadi", "DMS_LBMPC_q100", DMS_MONO_N)):
        c = lt.make_preset(name)
        if N_ is not None:
            c = dataclasses.replace(c, ocp=dataclasses.replace(c.ocp, N=N_))
        c = dataclasses.replace(c, solver=dataclasses.replace(c.solver, sqp_iters=2,
                                                              dtype="float32"))
        s = build_scenario(c)
        need = mono_vmem_need(s.qp, fam, c.oracle.q, MONO_TILE)
        log(f"K3w shape {fam}: {name} N={s.qp.N} nz={s.nz} G={s.qp.G.shape}; the reference's "
            f"VMEM model at tile {MONO_TILE}: {need / 2**20:.1f}M (its budget: 54.0M + 6M)")
        shapes[fam] = (c, s, dict(family=fam, delta=c.plant.ts, bandwidth=c.oracle.bandwidth,
                                  ridge=c.oracle.ridge, dx_ref=np.asarray(c.dx_ref)))
    ncfg, ns, nkw = shapes["fmincon"]

    # ---- phase 24: K3w against K1w -> K2w and against its plain version ----------
    t_phase = time.time()
    log(f"phase 24: K3w gn_mehrotra_wide vs K1w -> step_rhs -> K2w (bit for bit) and vs "
        f"plain, uncut LBMPC_N40 at {COHORT} lanes and the DMS preset cut to N={DMS_MONO_N} "
        f"at {DMS_BATCH}, 16 and 8 iterations")
    k3w_err = k3w_held = 0.0
    monos, mono_in = {}, {}
    for fam, B in (("fmincon", COHORT), ("casadi", DMS_BATCH)):
        c, s, kw = shapes[fam]
        gn = GNPhase(s.qp, s.A, s.B, s.ocp.Ks, s.w, device=dev, **kw)
        G, h0, Hp = f(s.qp.G), f(s.qp.h0), f(s.qp.Hp)
        dx, win, z = family_inputs(7, B, c, s.nz, dev)
        mono_in[fam] = (z, dx, win)
        e1, H1, g1 = gn(z, dx, win)
        h = step_rhs(h0, Hp, G, dx, z)
        hmax = H1.abs().max().item()
        for it in (16, 8):
            mono = monos[(fam, it)] = MonoPhase(gn, G, h0, Hp, it)
            require(mono.wide and not mono.narrow, f"{fam}: MonoPhase routes to K3w")
            torch.cuda.synchronize()
            zero_counts()
            e, d, mu, g = mono(z, dx, win)
            torch.cuda.synchronize()
            per = route_counts()
            require(per == dict(route_none(), gn_mehrotra_wide=1),
                    f"K3w launched once, nothing else ({fam}, {it} iters)")
            x2, mu2, _ = mehrotra_h(G, H1, g1, h, it)
            torch.cuda.synchronize()
            same = {k: torch_equal(a, b) for k, a, b in
                    (("e", e, e1), ("g", g, g1), ("d", d, x2), ("mu", mu, mu2))}
            log(f"  {fam} B={B} {it} iters: equal to K1w -> K2w {same}; mu>=1e-6 on "
                f"{(~(mu < 1e-6)).float().mean().item():.4f} of lanes")
            require(all(same.values()),
                    f"K3w equals K1w -> step_rhs -> K2w cold bit for bit ({fam}, {it} iters)")
            # determinism: a second launch, and 64 copies of lane 0
            again = mono(z, dx, win)
            rep = mono(*(a[:1].expand((64,) + a.shape[1:]).contiguous() for a in (z, dx)),
                       type(win)(*(a[:1].expand((64,) + a.shape[1:]).contiguous()
                                   for a in win)))
            require(all(torch_equal(a, b) for a, b in zip(again, (e, d, mu, g)))
                    and all(torch_equal(a, a[:1].expand_as(a)) for a in rep),
                    f"K3w deterministic: a second launch equal, 64 copies of a lane equal ({fam})")
            ep, dp, mup, gp = mono.plain(z, dx, win)
            eg = max((e - ep).abs().max().item(), (g - gp).abs().max().item())
            log(f"  vs plain: e, g error {eg:.3e} (max|H|={hmax:.4g})")
            require(eg <= 1e-5 * hmax, f"K3w e and g within 1e-5 max|H| of plain ({fam}, {it})")
            name = f"K3w vs plain ({fam}, {it} iters)"
            if fam == "fmincon" and it == 8:
                d_all, d_held = qp_step_gates(name, d, mu, dp, mup, True)
            else:
                d64 = mehrotra_h_plain(G.double(), H1.double(), g1.double(), h.double(), it)[0]
                d_all, d_held = f64_gates(name, d, mu, dp, mup, d64)
            k3w_err, k3w_held = max(k3w_err, eg, d_all), max(k3w_held, eg, d_held)
    kernels["gn_mehrotra_wide"].update(max_abs_err=k3w_err, max_abs_err_held=k3w_held)
    t = {}
    for (fam, it), mono in monos.items():
        t[f"k3w_{fam}_{it}"] = cuda_ms(lambda: mono(*mono_in[fam]), reps=3)
    for fam in ("fmincon", "casadi"):
        t[f"k3w_{fam}_16_plain"] = cuda_ms(lambda: monos[(fam, 16)].plain(*mono_in[fam]),
                                           reps=2, warmup=1)
    b3w = {}
    for fam, B in (("fmincon", COHORT), ("casadi", DMS_BATCH)):
        c, s, kw = shapes[fam]
        ne = (s.qp.N - 2 if fam == "fmincon" else s.qp.N) * 5 + 8
        for it in (16, 8):
            for kind, G_ in (("structural", s.qp.G), ("dense", None)):
                b3w[(fam, it, kind)] = bound_ms(*mono_work(B, s.qp.N, Q, ne, s.nz,
                                                           monos[(fam, it)].gn.cst.numel(),
                                                           s.qp.G.shape[0], it, G_))
    for k, v in t.items():
        log(f"  time {k} = {v:.4f} ms {tag}")
    log("  bound K3w " + ", ".join(f"{fam} {it} iters {kind} {b[0]:.4f} ms ({b[1]})"
                                  for (fam, it, kind), b in b3w.items()) + f" {tag}")
    kernels["gn_mehrotra_wide"].update(
        ms=t["k3w_fmincon_16"], plain_ms=t["k3w_fmincon_16_plain"],
        bound_ms=b3w[("fmincon", 16, "structural")][0],
        bound_by=b3w[("fmincon", 16, "structural")][1],
        bound_ms_dense=b3w[("fmincon", 16, "dense")][0], ms_8_iters=t["k3w_fmincon_8"],
        bound_ms_8_iters=b3w[("fmincon", 8, "structural")][0])
    split_k3w(dev, tag, [(f"{fam} {it} iters", monos[(fam, it)], mono_in[fam], it)
                         for fam, it in (("fmincon", 16), ("casadi", 16))])
    log(f"  phase 24 took {time.time() - t_phase:.1f} s")
    if args.stop_after < 25:
        return

    # ---- phase 25: the fused solve on pallas_mono at N40 -------------------------
    t_phase = time.time()
    log(f"phase 25: N40 fused SQP at batch {BATCH} on pallas_mono (K3w), ipm {XLA_SCHED}, "
        "against pallas_full without qp_warm, its plain route and the xla route")
    route = lambda qk, **extra: make_lbmpc_solver_fused(
        ns.qp, ns.A, ns.B, ns.ocp.Ks, ns.w, qp_kernel=qk, sqp_iters=2, ipm_iters=XLA_SCHED,
        alphas=LADDER, device=dev, **nkw, **extra)
    sdx, swin, _ = family_inputs(8, BATCH, ncfg, ns.nz, dev)
    sz0 = torch.zeros(BATCH, ns.nz, dtype=f32, device=dev)
    solves = {"pallas_mono": route("pallas_mono"), "pallas_full": route("pallas_full"),
              "xla": route("xla")}
    out, per = {}, {}
    for name, s in solves.items():
        torch.cuda.synchronize()
        zero_counts()
        out[name] = s(sdx, swin, sz0)
        torch.cuda.synchronize()
        per[name] = {**route_counts(), **chol_counts()}
    log(f"  launches per solve {per}")
    none = {**route_none(), **chol_none()}
    require(per["pallas_mono"] == dict(none, gn_mehrotra_wide=2),
            "N40 pallas_mono: 2 K3w launches a solve, nothing else")
    (zm, cm), (zf, cf), (zx, cx) = out["pallas_mono"], out["pallas_full"], out["xla"]
    log(f"  pallas_mono vs pallas_full (qp_warm off): max|dz|={mismatch(zm, zf):.3e} conv "
        f"{cm.float().mean().item():.6f} / {cf.float().mean().item():.6f}")
    require(torch_equal(zm, zf) and torch_equal(cm, cf),
            "N40 pallas_mono equals pallas_full without qp_warm bit for bit (z and conv)")
    anchored_route_gates("N40 pallas_mono", zm, cm, *route("pallas_mono", plain=True)(
        sdx, swin, sz0), zx)
    t25 = cuda_ms(lambda: solves["pallas_mono"](sdx, swin, sz0), reps=3)
    log(f"  time n40_mono_solve = {t25:.4f} ms {tag}")
    log(f"  phase 25 took {time.time() - t_phase:.1f} s")
    if args.stop_after < 26:
        return

    # ---- phase 26: the reference's hybrid fleet on pallas_mono at N40 ------------
    t_phase = time.time()
    log(f"phase 26: uncut LBMPC_N40 hybrid fleet on pallas_mono as the reference builds it "
        f"(vmapped repair, 1 GN x 8 IPM from the fused iterate), cohort {COHORT}, {STEPS} "
        f"steps, ipm {XLA_SCHED} (this slice's main path)")
    fcfg = dataclasses.replace(ncfg, iterations=STEPS)
    fleet_kw = dict(backend="hybrid", ipm_iters=XLA_SCHED, sqp_iters=2, qp_kernel="pallas_mono",
                    device=dev)
    _, run_k = build_fleet_episode(fcfg, **fleet_kw)
    _, run_p = build_fleet_episode(fcfg, plain=True, **fleet_kw)
    hyb = run_k.solver
    require((hyb.repair_backend, hyb.repair_warm) == ("vmapped", "fused"),
            "the pallas_mono hybrid fleet repairs on the vmapped backend from the fused iterate")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    res = run_k(dx_init)
    torch.cuda.synchronize()
    fleet_s = time.time() - t0
    per = {**route_counts(), **chol_counts()}
    conv_steps = res.solver_converged.float().mean(dim=0)
    sysH = res.sys_history
    log(f"  {fleet_s * 1e3 / STEPS:.3f} ms/step (host clock, first run, incl. warm-up) "
        f"launches {per} {tag}")
    log("  conv per step: " + " ".join(f"{v:.6f}" for v in conv_steps.tolist()))
    require(tuple(sysH.shape) == (COHORT, STEPS + 1, 5) and bool(torch.isfinite(sysH).all()),
            "N40 pallas_mono fleet history finite, (B, T+1, 5)")
    require(per == dict(none, gn_mehrotra_wide=2 * STEPS),
            f"N40 pallas_mono fleet: {2 * STEPS} K3w launches and nothing else")
    kernels["gn_mehrotra_wide"]["launches"] = per["gn_mehrotra_wide"]
    # the cold (16, 8) schedule at nz=41 flags a growing share of lanes from
    # step ~12 on, beyond the K=96 lanes the repair takes; the reference's
    # own fused fleet decays the same way (tools/fleet_conv_reference.py).
    # So conv is held to the plain route's on the whole cohort, step by step
    res_p = run_p(dx_init)
    conv_p = res_p.solver_converged.float().mean(dim=0)
    log("  plain route conv per step: " + " ".join(f"{v:.6f}" for v in conv_p.tolist()))
    require((conv_steps - conv_p).abs().max().item() <= 0.005,
            "N40 pallas_mono fleet conv within 0.5 pp of the plain route's every step")
    d = (sysH - res_p.sys_history).abs()
    far_p = ~(d.amax(dim=(1, 2)) <= 5e-2)
    ever = ~(res.solver_converged.all(dim=1) & res_p.solver_converged.all(dim=1))
    log(f"  vs plain route: |d sys_history| first 256 lanes median="
        f"{d[:256].median().item():.3e} max={d[:256].max().item():.3e}; all lanes median="
        f"{d.median().item():.3e}, lanes beyond 5e-2 {int(far_p.sum())} (of them unconverged "
        f"at some step on a side {int((far_p & ever).sum())})")
    require(d.median().item() < 1e-6, "N40 pallas_mono fleet sys_history vs the plain route: "
            "median < 1e-6")
    # at 16 cold IPM iterations 40 % of the N40 lanes stall (phase 24), and
    # there two float32 computations end apart and their trajectories part:
    # the kernel route is held, as anchored_route_gates holds the DMS solves,
    # to an independent computation of the same fleet, the xla route's
    _, run_x = build_fleet_episode(fcfg, backend="hybrid", ipm_iters=XLA_SCHED, sqp_iters=2,
                                   alphas=LADDER, device=dev)
    hx = run_x(dx_init).sys_history
    far = lambda h: (~((h - hx).abs().amax(dim=(1, 2)) <= 5e-2)).float().mean().item()
    mk, mp = (sysH - hx).abs().median().item(), (res_p.sys_history - hx).abs().median().item()
    log(f"  from the xla route's fleet: |d sys_history| median kernel {mk:.3e} plain {mp:.3e}, "
        f"lanes beyond 5e-2 kernel {far(sysH):.4f} plain {far(res_p.sys_history):.4f}")
    require(mk <= 1.5 * mp + 1e-8 and far(sysH) <= far(res_p.sys_history) + 0.02,
            "N40 pallas_mono fleet as close to the xla route's fleet as its plain route "
            "(median within 1.5x, lanes beyond 5e-2 within 2 pp)")
    t0 = time.time()
    run_k(dx_init)
    torch.cuda.synchronize()
    log(f"  time n40_mono_fleet_step = {(time.time() - t0) * 1e3 / STEPS:.4f} ms {tag}")
    log(f"  phase 26 took {time.time() - t_phase:.1f} s")
    if args.stop_after < 27:
        return

    # ---- phase 27: the N=20 hybrid fleets as the reference builds them -----------
    t_phase = time.time()
    fcfg = dataclasses.replace(cfg, iterations=STEPS)
    fleets = {"xla": (dict(backend="hybrid", sqp_iters=2, ipm_iters=XLA_SCHED, device=dev),
                      dict(chol_factor_solve=24 * STEPS, chol_resolve=24 * STEPS)),
              "pallas_mono": (dict(backend="hybrid", sqp_iters=2, ipm_iters=XLA_SCHED,
                                   qp_kernel="pallas_mono", device=dev),
                              dict(gn_mehrotra=2 * STEPS))}
    for name, (fkw, launched) in fleets.items():
        log(f"phase 27: N=20 hybrid fleet on {name} with the vmapped repair, cohort {COHORT}, "
            f"{STEPS} steps, {fkw}")
        _, run = build_fleet_episode(fcfg, **fkw)
        require(run.solver.repair_backend == "vmapped", f"{name}: the vmapped repair")
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        res = run(dx_init)
        torch.cuda.synchronize()
        fleet_s = time.time() - t0
        per = {**route_counts(), **chol_counts()}
        conv_steps = res.solver_converged.float().mean(dim=0)
        log(f"  {fleet_s * 1e3 / STEPS:.3f} ms/step (host clock, first run, incl. warm-up) "
            f"conv min over steps={conv_steps.min().item():.6f} mean="
            f"{conv_steps.mean().item():.6f} launches {per} {tag}")
        require(bool(torch.isfinite(res.sys_history).all()), f"{name} hybrid fleet finite")
        require(conv_steps.min().item() >= 0.99, f"{name} hybrid fleet conv >= 0.99 every step")
        require(per == dict(none, **launched), f"{name} hybrid fleet launches {launched}")
        t0 = time.time()
        run(dx_init)
        torch.cuda.synchronize()
        log(f"  time n20_{name}_hybrid_fleet_step = {(time.time() - t0) * 1e3 / STEPS:.4f} ms "
            f"{tag}")
    log(f"  phase 27 took {time.time() - t_phase:.1f} s")
    if args.stop_after < 28:
        return

    # ---- phase 28: make_lbmpc_solver_fleet on pallas_mono --------------------------
    t_phase = time.time()
    R = COHORT // BATCH
    log(f"phase 28: make_lbmpc_solver_fleet on pallas_mono at N=20, R={R} x B={BATCH}, "
        "the reference's defaults (sqp 2, ipm 16, one deferred vmapped repair of "
        f"{round(COHORT / 128)} lanes, 1 GN x 20 IPM)")
    sc20 = build_scenario(cfg)
    fleet = make_lbmpc_solver_fleet(sc20.qp, sc20.A, sc20.B, sc20.ocp.Ks, sc20.w,
                                    qp_kernel="pallas_mono", alphas=LADDER, device=dev,
                                    family="fmincon", delta=cfg.plant.ts,
                                    bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                                    dx_ref=np.asarray(cfg.dx_ref))
    fdx, fwin, _ = bench_inputs(np.random.default_rng(9), COHORT, sc20.nz, dev)
    split = lambda a: a.reshape((R, BATCH) + a.shape[1:])
    fwin = type(fwin)(*(split(a) for a in fwin))
    fz0 = torch.zeros(R, BATCH, sc20.nz, dtype=f32, device=dev)
    fdx = split(fdx)
    torch.cuda.synchronize()
    zero_counts()
    zf_, cf_ = fleet(fdx, fwin, fz0)
    torch.cuda.synchronize()
    per = {**route_counts(), **chol_counts()}
    fused_conv = torch.stack([fleet.fused.raw(fdx[r], fwin.index(r), fz0[r])[1]
                              for r in range(R)]).float().mean().item()
    conv = cf_.float().mean().item()
    log(f"  conv before the repair {fused_conv:.6f}, after {conv:.6f}; launches {per}")
    require(tuple(zf_.shape) == (R, BATCH, sc20.nz) and bool(zf_.isfinite().all()),
            "fleet solver z finite, (R, B, nz)")
    require(conv >= 0.99 and conv >= fused_conv, "fleet solver conv >= 0.99, not below the "
            "fused batches'")
    require(per == dict(none, gn_mehrotra=2 * R), f"fleet solver: {2 * R} K3 launches")
    t28 = cuda_ms(lambda: fleet(fdx, fwin, fz0), reps=3, warmup=1)
    log(f"  time fleet_solver_call = {t28:.4f} ms ({COHORT} solves) {tag}")
    log(f"  phase 28 took {time.time() - t_phase:.1f} s")
    if args.stop_after < 29:
        return
    golden_phases(dev, tag)


def golden_phases(dev, tag: str) -> None:
    """Phase 29: the golden trajectories of the reference MATLAB runs
    (tests/golden) on the card, with the bounds of tests/test_parity.py."""
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

    gold = lambda name: dict(np.load(ROOT / "tests" / "golden" / f"{name}.npz"))
    t_phase = time.time()
    steps = GOLDEN_F32_STEPS
    log(f"phase 29: golden parity on the card: the float32 pallas_mono hybrid at LBMPC_N50 "
        f"(K3w, B={GOLDEN_B}, every flagged lane repaired, {steps} steps), LMPC_N50 pointwise "
        f"(float64, 1000 states), LBMPC_N50 float64 ({GOLDEN_F64_STEPS} steps)")
    cfg = lt.make_preset("LBMPC_N50", iterations=steps)
    _, run = build_fleet_episode(cfg, backend="hybrid", qp_kernel="pallas_mono",
                                 ipm_iters=XLA_SCHED, sqp_iters=2, repair_frac=1.0, device=dev)
    zero_counts()
    t0 = time.time()
    res = run(np.broadcast_to(np.asarray(cfg.dx_init), (GOLDEN_B, 4)).copy())
    torch.cuda.synchronize()
    per = route_counts()
    g = gold("LBMPC_N50")
    held = GOLDEN_F32_HELD
    conv = res.solver_converged[0].cpu().numpy()
    err = np.abs(res.sys_history[0].cpu().numpy().T - g["sysH"][:, : steps + 1])
    out = np.nonzero((err.max(axis=0) > 2e-2) | (err[:2].max(axis=0) > 2e-3))[0]
    same = torch_equal(res.sys_history, res.sys_history[:1].expand_as(res.sys_history))
    parted = (res.sys_history != res.sys_history[:1]).any(dim=2).any(dim=0).nonzero()
    same = f"{same} (first step where they part: {int(parted[0]) if parted.numel() else None})"
    log(f"  f32 pallas_mono hybrid: {(time.time() - t0) * 1e3 / steps:.3f} ms/step; over "
        f"{held} steps: |sysH - golden| max {err[:, :held + 1].max():.3e}, first two states "
        f"{err[:2, :held + 1].max():.3e}, conv {conv[:held].mean():.6f}; over {steps}: first "
        f"step out of the envelope {int(out[0]) if out.size else None}, max {err.max():.3e}, "
        f"unconverged steps {np.nonzero(~conv)[0].tolist()[:12]} ({int((~conv).sum())}); lanes "
        f"identical {same}; launches {per} {tag}")
    # past ~40 steps this float32 configuration leaves the golden envelope,
    # the reference's own too (tools/n50_float32_reference.py)
    require(bool(conv[:held].all()) and bool(res.sys_history.isfinite().all()),
            f"N50 f32 pallas_mono hybrid: conv on each of the first {held} steps, finite")
    require(err[:, :held + 1].max() < 2e-2 and err[:2, :held + 1].max() < 2e-3,
            f"N50 f32 pallas_mono hybrid within the reference's envelope over {held} steps "
            "(max < 2e-2, first two states < 2e-3)")
    require(per["gn_mehrotra_wide"] == 2 * steps, f"N50 hybrid: {2 * steps} K3w launches")
    require(not parted.numel(), f"N50 f32 pallas_mono hybrid: the {GOLDEN_B} identical lanes "
            f"stay identical, bit for bit, over all {steps} steps")

    t0 = time.time()
    sc = build_scenario("LMPC_N50", device=dev)
    gl = gold("LMPC_N50")
    dxs = torch.tensor(gl["sysH"][:4, :-1].T, device=dev)
    z, conv = sc.solve(dxs, None, None)
    Ks = torch.tensor(np.atleast_2d(sc.ocp.Ks), device=dev)
    du = ((dxs @ Ks.T)[:, 0] + z[:, 0]).cpu().numpy()
    err = np.abs(du - gl["sysH"][4, 1:])
    art = (z[:, -1:] @ torch.tensor(sc.ocp.LAMBDA, device=dev)[:1].T)[:, 0].cpu().numpy()
    aerr = np.abs(art - gl["art_refH"][1:])
    log(f"  LMPC_N50 pointwise ({dxs.shape[0]} states, {time.time() - t0:.1f} s): du error "
        f"median {np.median(err):.3e} max {err.max():.3e}, {(err > 1e-4).sum()} above 1e-4; "
        f"theta median {np.median(aerr):.3e} max {aerr.max():.3e}; conv "
        f"{conv.float().mean().item():.6f}")
    require(bool(conv.all()) and np.median(err) < 2e-6 and err.max() < 5e-4
            and (err > 1e-4).sum() < 10 and np.median(aerr) < 1e-7 and aerr.max() < 5e-4,
            "LMPC_N50 pointwise within the reference's bounds")

    t0 = time.time()
    steps = GOLDEN_F64_STEPS
    res = build_scenario(lt.make_preset("LBMPC_N50", iterations=steps), device=dev).run()
    torch.cuda.synchronize()
    g = gold("LBMPC_N50")
    err = np.abs(res.sys_history.cpu().numpy().T - g["sysH"][:, : steps + 1])
    aerr = np.abs(res.art_history[:, 0].cpu().numpy() - g["art_refH"][1: steps + 1])
    log(f"  LBMPC_N50 float64: {(time.time() - t0) * 1e3 / steps:.3f} ms/step, conv "
        f"{res.solver_converged.float().mean().item():.6f}, |sysH - golden| max {err.max():.3e}, "
        f"theta max {aerr.max():.3e} {tag}")
    require(bool(res.solver_converged.all()) and err.max() < 5e-4 and aerr.max() < 2e-4,
            "LBMPC_N50 float64 within the reference's bounds (max < 5e-4, theta < 2e-4)")
    log(f"  phase 29 took {time.time() - t_phase:.1f} s")


def nmpc_episodes(dev, tag: str, jobs: list) -> dict:
    """NMPC closed loops on the card (build_scenario(cfg).run(), or
    run_batch(dx) for a job (what, cfg, dx)), each on its own CUDA stream in
    its own host thread, all at once: a solve replays a CUDA graph of ~10^5
    small kernels, one block each, so one episode leaves the card nearly
    idle. Each solver's graph is captured first, one at a time (no capture
    may run beside another thread's work). Returns {what: (scenario,
    result, ms a step)}; no kernel launched (the NMPC path runs on ops/ipm
    and torch.linalg)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    t0 = time.time()
    scs = {}
    for what, cfg, dx in jobs:
        sc = build_scenario(cfg, device=dev)
        B = 1 if dx is None else len(dx)
        sc.solve(torch.zeros(B, 4, dtype=torch.float64, device=dev), None,
                 torch.zeros(B, sc.nz, dtype=torch.float64, device=dev))
        scs[what] = sc
    torch.cuda.synchronize()
    log(f"  {len(jobs)} solvers built and their graphs captured in {time.time() - t0:.1f} s")

    def episode(what, cfg, dx):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            t1 = time.time()
            res = scs[what].run() if dx is None else scs[what].run_batch(dx)
            stream.synchronize()
        return res, (time.time() - t1) * 1e3 / cfg.iterations

    zero_counts()
    t0 = time.time()
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = [(what, ex.submit(episode, what, cfg, dx)) for what, cfg, dx in jobs]
        done = {what: f.result() for what, f in futs}
    torch.cuda.synchronize()
    counts = {**route_counts(), **chol_counts()}
    log(f"  {len(jobs)} episodes at once: {time.time() - t0:.1f} s {tag}")
    out = {}
    for what, cfg, dx in jobs:
        sc, (res, ms) = scs[what], done[what]
        graphed = sc.solve.parts["graphed"]
        replays = (graphed.replays, graphed.fallbacks) if graphed is not None else None
        conv = res.solver_converged.float().mean().item()
        log(f"  {what}: {ms:.3f} ms/step (host clock, {len(jobs)} episodes at once), conv "
            f"{conv:.6f}, graph replays/fallbacks {replays} {tag}")
        require(all(t.device.type == "cuda" for t in (res.sys_history, res.art_history,
                                                      res.solver_converged, res.final_x)),
                f"{what}: tensors on cuda")
        require(res.sys_history.dtype == torch.float64 and bool(res.sys_history.isfinite().all()),
                f"{what}: float64, finite")
        out[what] = (sc, res, ms)
    require(not any(counts.values()), "the NMPC episodes: no kernel launched (the NMPC path is "
            "plain)")
    return out


def nmpc_phases(dev, tag: str, args) -> None:
    """Phases 30-31: the NMPC family (controllers/nmpc on ops/ipm, float64,
    a CUDA graph of each solve) against the reference MATLAB runs' goldens
    at the reference's tier-1 lengths, with the bounds of
    tests/test_parity.py, test_parity_sweep.py and test_regulation.py; then
    a batch of NMPC_N50 closed loops as users run one."""
    import torch

    import lbmpc_tpu_torch as lt

    gold = lambda name: np.load(ROOT / "tests" / "golden" / f"{name}.npz") if (
        ROOT / "tests" / "golden" / f"{name}.npz").exists() else np.load(
        ROOT / "tests" / "golden" / f"{name}.npy")
    t_phase = time.time()
    log("phase 30: NMPC goldens on the card (float64): NMPC_N50 and NMPC_N40 (60 steps), the "
        "casadi NMPC at N=100 (120 steps, DSS_tNMPC), REG_NMPC (150), REG_LMPC (250), the "
        "collocation NMPC against the RK4 NMPC at NMPC_N20 (30)")
    casadi = lt.make_preset("NMPC_N50", iterations=120)
    casadi = dataclasses.replace(casadi, family="casadi",
                                 ocp=dataclasses.replace(casadi.ocp, N=100))
    base = lt.make_preset("NMPC_N20", iterations=30)
    coll = dataclasses.replace(base, solver=dataclasses.replace(base.solver,
                                                                nmpc_prediction="collocation"))
    eps = nmpc_episodes(dev, tag, [
        ("REG_NMPC", lt.make_preset("REG_NMPC", iterations=150), None),
        ("casadi NMPC N=100", casadi, None),
        ("NMPC_N50", lt.make_preset("NMPC_N50", iterations=60), None),
        ("NMPC_N40", lt.make_preset("NMPC_N40", iterations=60), None),
        ("REG_LMPC", lt.make_preset("REG_LMPC", iterations=250), None),
        ("collocation NMPC_N20", coll, None),
        ("RK4 NMPC_N20", base, None)])
    for N in (50, 40):
        res = eps[f"NMPC_N{N}"][1]
        steps = res.sys_history.shape[0] - 1
        g = gold(f"NMPC_N{N}")
        err = np.abs(res.sys_history.cpu().numpy().T - g["sysH"][:, : steps + 1])
        aerr = np.abs(res.art_history[:, 0].cpu().numpy() - g["art_refH"][1: steps + 1])
        log(f"    NMPC_N{N}: |sysH - golden| max by row "
            f"{np.array2string(err.max(axis=1), precision=3)}, theta max {aerr.max():.3e}")
        require(bool(res.solver_converged.all()) and err[:3].max() < 1e-4
                and err[3].max() < 5e-3 and err[4].max() < 1e-3
                and (N != 50 or aerr.max() < 5e-4),
                f"NMPC_N{N} within the reference's bounds (slow states 1e-4, x4 5e-3, input "
                "1e-3" + (", theta 5e-4)" if N == 50 else ")"))
    res = eps["casadi NMPC N=100"][1]
    steps = casadi.iterations
    ours = res.sys_history.cpu().numpy()[1: steps + 1, :4] + np.asarray(casadi.plant.x_wp)
    err = np.abs(ours.T - gold("DSS_tNMPC")[:, 1: steps + 1]).max(axis=1)
    log(f"    casadi NMPC N=100: |x - DSS_tNMPC| max by state {np.array2string(err, precision=3)}")
    require(bool(res.solver_converged.all()) and err[0] < 1e-5 and err[1] < 1e-5
            and err[2] < 1e-4 and err[3] < 1e-2,
            "casadi NMPC N=100 within the reference's bounds (1e-5, 1e-5, 1e-4, 1e-2)")
    res = eps["REG_NMPC"][1]
    h = res.sys_history.cpu().numpy()
    art = res.art_history.abs().max().item()
    log(f"    REG_NMPC: dx1 {h[0, 0]:.4f} -> {h[-1, 0]:.6f}, min dx2 {h[:, 1].min():.6f}, "
        f"|art| max {art:.3e}")
    require(bool(res.solver_converged.all()) and art < 1e-12 and abs(h[-1, 0]) < 0.75 * abs(h[0, 0])
            and h[:, 1].min() > -0.5 - 1e-6,
            "REG_NMPC: converged, theta pinned, |dx1| below 0.75 of its start, dx2 > -0.5")
    res = eps["REG_LMPC"][1]
    h = res.sys_history.cpu().numpy()
    art = res.art_history.abs().max().item()
    log(f"    REG_LMPC: dx1 {h[0, 0]:.4f} -> {h[-1, 0]:.6f}, |art| max {art:.3e}")
    require(bool(res.solver_converged.all()) and art < 1e-12 and abs(h[-1, 0]) < 0.25 * abs(h[0, 0]),
            "REG_LMPC: converged, theta pinned, |dx1| below 0.25 of its start")
    rk4, col = eps["RK4 NMPC_N20"][1], eps["collocation NMPC_N20"][1]
    d = (col.sys_history - rk4.sys_history).abs().max().item()
    log(f"    |collocation - RK4| max {d:.3e}")
    require(bool(col.solver_converged.all()) and d < 1e-6,
            "collocation NMPC within 1e-6 of the RK4 NMPC over 30 steps")
    log(f"  phase 30 took {time.time() - t_phase:.1f} s")
    if args.stop_after < 31:
        return

    t_phase = time.time()
    B = NMPC_BATCH
    cfg = lt.make_preset("NMPC_N50", iterations=NMPC_BATCH_STEPS)
    steps = cfg.iterations
    log(f"phase 31: NMPC_N50 run_batch at B={B} (lane 0 at dx_init, the others seeded "
        f"perturbations of it), {steps} steps")
    rng = np.random.default_rng(11)
    dxs = np.asarray(cfg.dx_init) + np.array([0.02, 0.02, 0.05, 0.5]) * rng.standard_normal((B, 4))
    dxs[0] = cfg.dx_init
    res, ms = nmpc_episodes(dev, tag, [(f"NMPC_N50 batch B={B}", cfg, dxs)])[
        f"NMPC_N50 batch B={B}"][1:]
    conv = res.solver_converged.float().mean(dim=0).cpu().numpy()
    # lane 0's single-lane run: phase 30's NMPC_N50 episode, from dx_init
    one = eps["NMPC_N50"][1]
    by_step = (res.sys_history[0] - one.sys_history[: steps + 1]).abs().amax(dim=1).cpu().numpy()
    d0 = float(by_step.max())
    parted = np.nonzero(by_step)[0]
    log(f"  NMPC_N50 batch: {ms:.3f} ms/step for {B} lanes ({ms / B * 1e3:.3f} us a lane-step), "
        f"conv by step min {conv.min():.6f} mean {conv.mean():.6f}; lane 0 against its "
        f"single-lane run (phase 30's NMPC_N50): max |d sysH| {d0:.3e}, by step "
        f"{np.array2string(by_step, precision=2)}, first step apart "
        f"{int(parted[0]) if parted.size else None} {tag}")
    require(tuple(res.sys_history.shape) == (B, steps + 1, 5)
            and bool(res.sys_history.isfinite().all()), "NMPC batch: (B, steps+1, 5), finite")
    require(d0 <= 1e-9, "NMPC batch: lane 0 within 1e-9 of its single-lane run")
    log(f"  phase 31 took {time.time() - t_phase:.1f} s")


def shipping_phase(dev, tag: str) -> None:
    """Phase 32: the reference's shipping-backend golden test as it is
    configured (tests/test_parity.py:229-291): the float32 pallas_full hybrid
    with the fused repair, repair_frac 1/8, 8 identical lanes, ipm (16, 8),
    LBMPC_N50 (K1w + K2w at nz=51), 300 steps."""
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    t_phase = time.time()
    held = GOLDEN_F32_HELD
    cfg = lt.make_preset("LBMPC_N50", iterations=SHIPPING_STEPS)
    steps = cfg.iterations
    log(f"phase 32: the reference's shipping-backend golden configuration: float32 pallas_full "
        f"hybrid, fused repair, repair_frac 1/{GOLDEN_B}, {GOLDEN_B} identical lanes, ipm "
        f"{XLA_SCHED}, LBMPC_N50, {steps} steps")
    _, run = build_fleet_episode(cfg, backend="hybrid", qp_kernel="pallas_full",
                                 ipm_iters=XLA_SCHED, sqp_iters=2, repair_frac=1.0 / GOLDEN_B,
                                 device=dev)
    zero_counts()
    t0 = time.time()
    res = run(np.broadcast_to(np.asarray(cfg.dx_init), (GOLDEN_B, 4)).copy())
    torch.cuda.synchronize()
    per = route_counts()
    g = np.load(ROOT / "tests" / "golden" / "LBMPC_N50.npz")
    conv = res.solver_converged[0].cpu().numpy()
    err = np.abs(res.sys_history[0].cpu().numpy().T - g["sysH"][:, : steps + 1])
    out = np.nonzero((err.max(axis=0) > 2e-2) | (err[:2].max(axis=0) > 2e-3))[0]
    parted = (res.sys_history != res.sys_history[:1]).any(dim=2).any(dim=0).nonzero()
    log(f"  f32 pallas_full hybrid (fused repair): {(time.time() - t0) * 1e3 / steps:.3f} ms/step; "
        f"over {held} steps: |sysH - golden| max {err[:, :held + 1].max():.3e}, first two states "
        f"{err[:2, :held + 1].max():.3e}, conv {conv[:held].mean():.6f}; over {steps}: first "
        f"step out of the envelope {int(out[0]) if out.size else None}, max {err.max():.3e}, "
        f"first two states {err[:2].max():.3e}, conv {conv.mean():.6f}, unconverged steps "
        f"{np.nonzero(~conv)[0].tolist()[:12]} ({int((~conv).sum())}); lanes identical "
        f"{not parted.numel()} (first step where they part: "
        f"{int(parted[0]) if parted.numel() else None}); launches {per} {tag}")
    # the reference's test claims conv and the envelope over all 300 steps;
    # off its TPU this configuration misses both before step 40, and the
    # miss is not the port's (ROADMAP §3: the flagged steps' QPs end above
    # the flag's mu in the reference's own K2w and in float64 too), so they
    # are reported here against the claim and not gated
    held_ok = (bool(conv[:held].all()) and err[:, :held + 1].max() < 2e-2
               and err[:2, :held + 1].max() < 2e-3)
    log(f"  {'ok  ' if held_ok else 'MISS'} shipping backend: conv on each of the first {held} "
        f"steps and the reference's envelope over them (max < 2e-2, first two states < 2e-3): "
        f"{'held' if held_ok else 'missed'} (ROADMAP §3)")
    require(bool(res.sys_history.isfinite().all()), "shipping backend: finite")
    require(not parted.numel(), f"shipping backend: the {GOLDEN_B} identical lanes stay "
            f"identical, bit for bit, over all {steps} steps")
    require(per["gn_wide"] >= 2 * steps and per["mehrotra_h_wide"] >= 2 * steps,
            f"shipping backend: at least {2 * steps} K1w and K2w launches")
    log(f"  phase 32 took {time.time() - t_phase:.1f} s")


def sparse_states(cfg, B: int, seed: int):
    """B seeded states around a casadi preset's start (x_init_abs - x_wp),
    lane 0 at it, float64 on the host."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp)
    dx = x0 + np.array([0.01, 0.01, 0.01, 0.1]) * rng.standard_normal((B, 4))
    dx[0] = x0
    return dx


def no_kernel_launched(what: str, why: str = "the stage-wise path has none") -> None:
    counts = {**route_counts(), **chol_counts()}
    require(not any(counts.values()), f"{what}: no kernel launched ({why}; {counts})")


def sparse_phases(dev, tag: str, args) -> None:
    """Phases 34-36: the stage-wise Riccati backends (ops/riccati,
    ops/sparse_ipm, ops/sparse_gn; plain torch, no kernel): the sparse LMPC
    at DMS_LMPC's N=50 and batch 1024 on both backends in both precisions,
    the sparse LBMPC at the DMS flagship's full width (N=100, q=100) at batch
    1024 with the reference's "sparse_s2i16" settings, and short closed
    loops on each sparse backend against the condensed one."""
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.lmpc import make_lmpc_solver
    from lbmpc_tpu_torch.controllers.lbmpc import make_lbmpc_solver
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.ops.sparse_ipm import peak_bytes
    from lbmpc_tpu_torch.runtime.scenario import build_scenario, sparse_parallel_limit

    f64, f32 = torch.float64, torch.float32
    with_solver = lambda cfg, **kw: dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, **kw))

    # ---- phase 34: the sparse LMPC at N=50, B=1024 ----------------------------
    t_phase = time.time()
    base = lt.make_preset("DMS_LMPC")
    N_, B = base.ocp.N, SPARSE_BATCH
    log(f"phase 34: sparse LMPC, DMS_LMPC N={N_}, batch {B}, ipm {base.solver.ipm_iters}: "
        "sparse and sparse_parallel in float64 and float32")
    dxh = sparse_states(base, B, 21)
    scs = {(b, d): build_scenario(with_solver(base, qp_backend=b, dtype=d), device=dev)
           for b in ("sparse", "sparse_parallel") for d in ("float64", "float32")}
    out, ms = {}, {}
    torch.cuda.synchronize()
    zero_counts()
    for key, sc in scs.items():
        dx = torch.as_tensor(dxh, dtype=f64 if key[1] == "float64" else f32, device=dev)
        out[key] = sc.solve(dx, None, None)
    torch.cuda.synchronize()
    no_kernel_launched("sparse LMPC")
    eager_ms = {}
    for key, sc in scs.items():
        dx = torch.as_tensor(dxh, dtype=f64 if key[1] == "float64" else f32, device=dev)
        ms[key] = cuda_ms(lambda: sc.solve(dx, None, None), reps=3, warmup=0)
        # the graphed solve against its eager path on the same device
        eager = getattr(sc.solve, "eager", sc.solve)
        (ze, ce), eager_ms[key] = cuda_call(lambda: eager(dx, None, None))
        require(torch.equal(ze, out[key][0]) and torch.equal(ce, out[key][1]),
                f"sparse LMPC {key[0]} {key[1]}: the graph replays the eager solve bit for bit")
    nz = scs[("sparse", "float64")].nz
    for (b, d), (z, conv) in out.items():
        share = conv.double().mean().item()
        log(f"  {b} {d}: solve {ms[(b, d)]:.3f} ms (graph replay; eager {eager_ms[(b, d)]:.3f} "
            "ms; CUDA events, host included), "
            f"converged share {share:.6f}, finite {bool(torch.isfinite(z).all())} {tag}")
        require(tuple(z.shape) == (B, nz) and bool(torch.isfinite(z).all()),
                f"sparse LMPC {b} {d}: (B, nz), every lane finite")
        require(share >= (0.99 if d == "float64" else 0.9),
                f"sparse LMPC {b} {d}: converged share >= {0.99 if d == 'float64' else 0.9}")
    zs, zp = out[("sparse", "float64")][0], out[("sparse_parallel", "float64")][0]
    dpar = (zs - zp).abs().amax(dim=1)
    apart = torch.nonzero(dpar > 1e-9)[:, 0].tolist()
    log(f"  float64 parallel vs sequential: max |dz| {dpar.max().item():.3e}, lane 0 "
        f"{dpar[0].item():.3e}, lanes beyond 1e-9: {len(apart)} {apart[:8]} (ROADMAP §3: on "
        "lanes whose barrier weights reach the cap the scan's answer turns on roundoff, in the "
        "reference too)")
    require(dpar[0].item() <= 1e-9 and len(apart) <= B // 100,
            "sparse_parallel within 1e-9 of sparse (float64) at the preset's state and on all "
            "but 1 % of the lanes")
    # 8 lanes against the port's condensed per-problem solve (ops/ipm, float64)
    cond = make_lmpc_solver(scs[("sparse", "float64")].qp, ipm_iters=40, dtype=f64, device=dev)
    zc, sol = cond(torch.as_tensor(dxh[:8], dtype=f64, device=dev))
    cc = sol.converged
    dc = (zs[:8] - zc).abs().max().item()
    log(f"  8 lanes against the condensed float64 solve (40 IPM iterations): max |dz| "
        f"{dc:.3e}, condensed converged {bool(cc.all())}")
    require(bool(cc.all()) and dc <= 1e-5, "sparse LMPC within 1e-5 of the condensed solve "
            "on 8 lanes (the reference's bound at long N)")
    for b in ("sparse", "sparse_parallel"):
        (z32, c32), (z64, c64) = out[(b, "float32")], out[(b, "float64")]
        both = c32 & c64
        du = (z32[:, 0].double() - z64[:, 0]).abs()
        far = du[both] > 2e-4
        log(f"  {b} float32 U[0] against float64 on {int(both.sum())} lanes converged in "
            f"both: max {du[both].max().item():.3e}, median {du[both].median().item():.3e}, "
            f"lanes beyond 2e-4: {int(far.sum())}")
        require(bool(both[0]) and du[0].item() <= 2e-4,
                f"{b}: float32 U[0] within 2e-4 of float64 at the preset's state (lane 0; "
                "tests/test_sparse_ipm.py:88-107)")
    # the sparse_parallel memory guard's model against the allocator's peak,
    # on the eager solve (a graph's capture holds the same in its pool)
    sc = scs[("sparse_parallel", "float64")]
    eager = getattr(sc.solve, "eager", sc.solve)
    rows = (len(sc.cs.h_x), len(sc.cs.h_u), len(sc.cs.h_w_N))
    for Bm in (256, B):
        dx = torch.as_tensor(dxh[:Bm], dtype=f64, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        eager(dx, None, None)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - before
        model = peak_bytes(Bm, N_, 4, 1, 1, rows, 8, parallel=True)
        log(f"  sparse_parallel float64 B={Bm}: peak {peak} B above the inputs, model {model} B "
            f"({peak / model:.3f} of it; {peak / (Bm * N_):.1f} B a lane-stage) {tag}")
        require(model / 4 <= peak <= model, f"sparse_parallel peak at B={Bm} within "
                "[model / 4, model]")
    total = torch.cuda.get_device_properties(dev).total_memory
    for d, dt in (("float64", f64), ("float32", f32)):
        lim = sparse_parallel_limit(scs[("sparse_parallel", d)], dev, dt)
        log(f"  sparse_parallel guard, {d}: {lim} lane-stages ({lim // N_} lanes at N={N_}) "
            f"of {total} B of device memory {tag}")
    log(f"  phase 34 took {time.time() - t_phase:.1f} s")
    if args.stop_after < 35:
        return

    # ---- phase 35: the sparse LBMPC at the DMS flagship's full width ----------
    t_phase = time.time()
    dcfg = with_solver(lt.make_preset("DMS_LBMPC_q100"), qp_backend="sparse", dtype="float32",
                       sqp_iters=2, ipm_iters=16)
    log(f"phase 35: sparse LBMPC, DMS_LBMPC_q100 (N={dcfg.ocp.N}, q={dcfg.oracle.q}, "
        f"terminal at x_1, tightened first step), batch {DMS_BATCH}, float32, sqp 2, ipm 16")
    ds = build_scenario(dcfg, device=dev)
    rng = np.random.default_rng(3)
    _, dwin, _ = bench_inputs(rng, DMS_BATCH, ds.nz, dev)
    x0 = np.asarray(dcfg.x_init_abs) - np.asarray(dcfg.plant.x_wp)
    ddx = torch.as_tensor(x0 + 0.01 * rng.standard_normal((DMS_BATCH, 4)), dtype=f32,
                          device=dev)
    dz0 = torch.zeros(DMS_BATCH, ds.nz, dtype=f32, device=dev)
    torch.cuda.synchronize()
    zero_counts()
    zsp, csp = ds.solve(ddx, dwin, dz0)
    torch.cuda.synchronize()
    no_kernel_launched("sparse LBMPC")
    t_sp = cuda_ms(lambda: ds.solve(ddx, dwin, dz0), reps=3, warmup=0)
    (ze, ce), t_eager = cuda_call(lambda: getattr(ds.solve, "eager", ds.solve)(ddx, dwin, dz0))
    require(torch.equal(ze, zsp) and torch.equal(ce, csp),
            "sparse LBMPC: the graph replays the eager solve bit for bit")
    xla = make_lbmpc_solver_fused(ds.qp, ds.A, ds.B, ds.ocp.Ks, ds.w, family="casadi",
                                  delta=dcfg.plant.ts, bandwidth=dcfg.oracle.bandwidth,
                                  ridge=dcfg.oracle.ridge, dx_ref=np.asarray(dcfg.dx_ref),
                                  sqp_iters=2, ipm_iters=XLA_SCHED, alphas=LADDER, device=dev)
    zx, cx = xla(ddx, dwin, dz0)
    share, xshare = csp.double().mean().item(), cx.double().mean().item()
    log(f"  sparse solve {t_sp:.3f} ms (graph replay; eager {t_eager:.3f} ms; CUDA events, "
        f"host included), converged share "
        f"{share:.6f}; the condensed xla route (ipm {XLA_SCHED}) on the same states "
        f"{xshare:.6f}; |z_sparse - z_xla| median {(zsp - zx).abs().median().item():.3e} {tag}")
    require(tuple(zsp.shape) == (DMS_BATCH, ds.nz) and bool(torch.isfinite(zsp).all()),
            "sparse LBMPC: (B, nz), every lane finite")
    # 8 lanes in float64 against the port's condensed float64 solver
    d64 = with_solver(dcfg, dtype="float64", ipm_iters=30)
    s64 = build_scenario(d64, device=dev)
    win8 = type(dwin)(*(a[:8] for a in dwin))
    z64s, c64s = getattr(s64.solve, "eager", s64.solve)(ddx[:8].double(), win8,
                                                        dz0[:8].double())
    cond = make_lbmpc_solver(s64.qp, s64.A, s64.B, s64.ocp.Ks, s64.w, family="casadi",
                             delta=d64.plant.ts, bandwidth=d64.oracle.bandwidth,
                             ridge=d64.oracle.ridge, dx_ref=np.asarray(d64.dx_ref), sqp_iters=2,
                             ipm_iters=30, dtype=f64, device=dev)
    z64c, c64c = cond(ddx[:8].double(), win8, dz0[:8].double())
    d8 = (z64s - z64c).abs().max().item()
    log(f"  8 lanes float64 (sqp 2, ipm 30) against the condensed float64 solver: max |dz| "
        f"{d8:.3e}; converged sparse {c64s.tolist()} condensed {c64c.tolist()}")
    require(bool(c64s.all()) and bool(c64c.all()) and d8 <= 1e-4,
            "sparse LBMPC within 1e-4 of the condensed float64 solver on 8 lanes")
    log(f"  phase 35 took {time.time() - t_phase:.1f} s")
    if args.stop_after < 36:
        return

    # ---- phase 36: short closed loops on each sparse backend ------------------
    t_phase = time.time()
    B, steps = SPARSE_LOOP_LANES, SPARSE_LOOP_STEPS
    log(f"phase 36: run_batch on {B} lanes, {steps} steps, float64: DMS_LMPC (N={N_}) on "
        "sparse and sparse_parallel, LBMPC_N20 on sparse, each against the condensed backend")
    lm = dataclasses.replace(base, iterations=steps)
    lb = lt.make_preset("LBMPC_N20", iterations=steps)
    dxl = sparse_states(lm, B, 23)
    rng = np.random.default_rng(24)
    dxb = np.asarray(lb.dx_init) + np.array([0.01, 0.01, 0.01, 0.1]) * rng.standard_normal((B, 4))
    # DMS_LMPC at 1e-4: from these states the reference's own two backends part by
    # 1.8e-5 in 5 steps (lane 43 of 64 from seed 23; the port's sparse episode equals the reference's
    # to 1e-13 there, PERF.md §6), where its test at N=30 from dx_init holds 1e-6
    for name, cfg, backend, dx, tol in (("DMS_LMPC", lm, "sparse", dxl, 1e-4),
                                        ("DMS_LMPC", lm, "sparse_parallel", dxl, 1e-4),
                                        ("LBMPC_N20", lb, "sparse", dxb, 1e-6)):
        zero_counts()
        t0 = time.time()
        rs = build_scenario(with_solver(cfg, qp_backend=backend), device=dev).run_batch(dx)
        torch.cuda.synchronize()
        wall = time.time() - t0
        no_kernel_launched(f"{name} {backend} closed loop")
        rc = build_scenario(cfg, device=dev).run_batch(dx)
        d = (rs.sys_history - rc.sys_history).abs().max().item()
        conv = rs.solver_converged.double().mean().item()
        log(f"  {name} {backend}: {wall / steps * 1e3:.1f} ms/step (host clock), conv "
            f"{conv:.6f}, max |sysH - condensed| {d:.3e} {tag}")
        require(bool(torch.isfinite(rs.sys_history).all()) and d <= tol,
                f"{name} {backend} closed loop within {tol:g} of the condensed backend")
    log(f"  phase 36 took {time.time() - t_phase:.1f} s")


KERNEL_PATTERNS = {          # the kernels' names in a device trace
    "gn_phase": r"gn_phase_kernel",
    "mehrotra_h": r"mehrotra_h_kernel",
    "chol_factor_solve": r"chol_(warp|block)_kernel<(\d+, )?true, true>",
    "chol_resolve": r"chol_(warp|block)_kernel<(\d+, )?false, false>",
}


def trace_dir(name: str) -> pathlib.Path:
    """Where a device trace is written: build/traces/ of the checkout (ignored
    by git)."""
    return ROOT / "build" / "traces" / name


def device_rows(prof) -> list:
    """(name, device ms, count) of the device-side events of a trace, most
    time first: an op's row (aten::sum) repeats the time of the kernels it
    launched, so only device events count."""
    import torch

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r[1])


def tooling_phase(dev, tag: str, cfg, sc) -> None:
    """Phase 37: the port's tooling on the main path. The fused solve at the
    bench configuration on pallas_full (K1 + K2) and on xla (K5a + K5c):
    analysis/solve_stats' protocol (runtime/profiling.solve_time_protocol)
    against the 10 ms budget, a device trace of three calls
    (runtime/profiling.device_trace) holding the kernels' names to their
    launch counters, and the H100 Roofline of the analytic count
    (analysis/roofline, as bench.py:222-240 counts)."""
    import re

    import torch

    from lbmpc_tpu_torch.analysis.roofline import (Roofline, assembly_mac_ratio,
                                                   fused_sqp_flops_per_solve,
                                                   fused_sqp_op_split, program_costs)
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.runtime.profiling import device_trace, solve_time_protocol

    t_phase = time.time()
    log(f"phase 37: the tooling on the main path: the fused solve at the bench configuration "
        f"(batch {BATCH}, sqp 2, ipm {IPM_SCHED}, ladders {LADDER}, qp_warm) on pallas_full and "
        f"xla: SolveStats ({PROTOCOL_RUNS} x {PROTOCOL_ITERS}), a device trace of 3 calls, the "
        "H100 Roofline")
    dx, win, _ = bench_inputs(np.random.default_rng(37), BATCH, sc.nz, dev)
    z0 = torch.zeros(BATCH, sc.nz, dtype=torch.float32, device=dev)
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2,
              ipm_iters=IPM_SCHED, alphas=LADDER, qp_warm=True, device=dev)
    mI = sc.qp.G.shape[0]
    ratio = assembly_mac_ratio(sc.qp.G)
    # ipm_iters=5 and n_merit=2: the per-GN averages of the (8, 2) schedule and
    # the ladders (1,), (1, .5, .25), whose totals the model's linearity keeps
    count_kw = dict(sqp_iters=2, ipm_iters=sum(IPM_SCHED) / len(IPM_SCHED), n_merit=2, N=N,
                    n=4, m=1, q=Q, mc=mI, ne=(N - 2) * 5 + 8, nz=sc.nz, kkt_mac_ratio=ratio)
    flops = fused_sqp_flops_per_solve(**count_kw)
    split = fused_sqp_op_split(**count_kw)
    log(f"  analytic count (fused_sqp_flops_per_solve, kkt_mac_ratio {ratio:.6f}): "
        f"{flops['total']:.6g} flop a solve, matmul {split['matmul']:.6g}, elementwise "
        f"{split['elementwise']:.6g}")
    routes = {"pallas_full": ("gn_phase", "mehrotra_h"),
              "xla": ("chol_factor_solve", "chol_resolve")}
    # the profiler's first start (CUPTI's set-up) outside the traced calls
    with device_trace(trace_dir("warm_up")):
        torch.ones(1, device=dev).add_(1)
    for route, names in routes.items():
        solver = make_lbmpc_solver_fused(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, qp_kernel=route,
                                         **kw)
        args = (dx, win, z0)
        stats, samples = solve_time_protocol(solver, args, runs=PROTOCOL_RUNS,
                                             iters=PROTOCOL_ITERS)
        log(f"  {route}: SolveStats over {stats.n} calls of {BATCH} solves (host clock, each "
            f"call synchronized): median {stats.median_ms:.4f} ms, mean {stats.mean_ms:.4f}, "
            f"CI95 [{stats.ci95_ms[0]:.4f}, {stats.ci95_ms[1]:.4f}], p99 {stats.p99_ms:.4f}, "
            f"max {stats.max_ms:.4f}; 10 ms budget "
            f"{'violated' if stats.violates_budget(10.0) else 'held'} (p99); "
            f"{BATCH / (stats.median_ms * 1e-3):.6g} solves/s {tag}")
        require(samples.shape == (PROTOCOL_RUNS, PROTOCOL_ITERS) and bool(np.isfinite(samples).all()),
                f"{route}: the protocol's samples are ({PROTOCOL_RUNS}, {PROTOCOL_ITERS}), finite")
        sync(dev)
        zero_counts()
        t0 = time.time()
        with device_trace(trace_dir(route)) as prof:
            for _ in range(3):
                z, conv = solver(*args)
        wall_ms = (time.time() - t0) * 1e3
        launches = {**route_counts(), **chol_counts()}
        rows = device_rows(prof)
        busy = sum(r[1] for r in rows)
        log(f"  {route} trace: 3 calls, wall {wall_ms:.3f} ms (profiler on), device busy "
            f"{busy:.3f} ms ({100 * busy / wall_ms:.2f}% of the traced wall; a call's "
            f"{busy / 3:.3f} ms is {100 * busy / 3 / stats.median_ms:.2f}% of the protocol's "
            f"median call), {sum(r[2] for r in rows)} device ops, trace "
            f"{(trace_dir(route) / 'trace.json').stat().st_size} B {tag}")
        for key, ms, cnt in rows[:8]:
            log(f"    {ms:9.3f} ms  {cnt:6d}x  {key[:100]}")
        for name in names:
            hit = [r for r in rows if re.search(KERNEL_PATTERNS[name], r[0])]
            ms, cnt = sum(r[1] for r in hit), sum(r[2] for r in hit)
            log(f"  {route} {name}: traced {cnt} launches, {ms:.4f} ms of device time; "
                f"launch counter {launches[name]}")
            require(cnt > 0 and ms > 0 and cnt == launches[name],
                    f"{route}: the trace shows {name}'s device time, its launches equal to "
                    "the launch counter's")
        others = {k: v for k, v in launches.items() if k not in names and v}
        require(not others, f"{route}: no other kernel launched ({others})")
        require(bool(torch.isfinite(z).all()) and conv.float().mean().item() >= 0.99,
                f"{route}: the traced solve finite, conv >= 0.99")
        torch_flops, byts = program_costs(solver, *args)
        rl = Roofline(flops_per_call=flops["total"] * BATCH, bytes_per_call=byts,
                      call_s=stats.median_ms * 1e-3, solves_per_call=BATCH,
                      matmul_flops_per_call=split["matmul"] * BATCH,
                      elementwise_flops_per_call=split["elementwise"] * BATCH)
        log(f"  {route} Roofline (analytic flops at the median call, bytes of the call's "
            f"inputs and outputs): {json.dumps(rl.as_dict())}; torch's own products in a "
            f"call (FlopCounterMode, the kernels unseen): {torch_flops:.6g} flop {tag}")
    log(f"  phase 37 took {time.time() - t_phase:.1f} s")


def checkpoint_phase(dev, tag: str):
    """Phase 38: checkpoint and resume on the card. LBMPC_N40 at full width
    (N=40, q=100, float64, the preset's solver), CK_BATCH seeded states
    around dx_init: CK_STEPS steps uninterrupted against half of them, a
    save / load through a file, and resume for the rest; then one lane
    through the single-lane path; then lane_bits_sweep. Returns the batch's
    (cfg, uninterrupted result, checkpointed state, initial states)."""
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.checkpoint import capture, load, resume, save
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    t_phase = time.time()
    cfg = lt.make_preset("LBMPC_N40", iterations=CK_STEPS)
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, dtype="float64"))
    half = CK_STEPS // 2
    log(f"phase 38: checkpoint and resume, LBMPC_N40 (N={cfg.ocp.N}, q={cfg.oracle.q}, "
        f"float64, sqp {cfg.solver.sqp_iters}, ipm {cfg.solver.ipm_iters}), batch {CK_BATCH}: "
        f"{CK_STEPS} steps against {half} + save / load + resume {CK_STEPS - half}; then one lane")
    sc = build_scenario(cfg, device=dev)
    sc_half = build_scenario(dataclasses.replace(cfg, iterations=half), device=dev)
    dx = (np.asarray(cfg.dx_init)
          + 0.005 * np.random.default_rng(38).standard_normal((CK_BATCH, 4)))
    path = ROOT / "build" / "checkpoints" / "phase38.npz"
    out = {}
    for name, runner, lanes in (("batch", "run_batch", dx), ("one lane", "run", dx[0])):
        zero_counts()
        t0 = time.time()
        full = getattr(sc, runner)(lanes)
        sync(dev)
        t_full = time.time() - t0
        t0 = time.time()
        part1 = getattr(sc_half, runner)(lanes)
        save(path, capture(part1, step=half), meta={"preset": cfg.name})
        state, meta = load(path)
        part2 = resume(sc, state, steps=CK_STEPS - half)
        sync(dev)
        t_parts = time.time() - t0
        no_kernel_launched(f"checkpoint {name}", "the float64 per-problem SQP has none")
        joined = torch.cat([part1.sys_history, part2.sys_history[..., 1:, :]], dim=-2)
        pairs = {"sys_history": (joined, full.sys_history),
                 "final_x": (part2.final_x, full.final_x),
                 "final_window.Y": (part2.final_window.Y, full.final_window.Y)}
        d = {k: (a - b).abs().max().item() for k, (a, b) in pairs.items()}
        bits = all(torch.equal(a, b) for a, b in pairs.values())
        conv = full.solver_converged.double().mean().item()
        log(f"  {name}: uninterrupted {t_full:.2f} s ({t_full / CK_STEPS * 1e3:.1f} ms/step), "
            f"interrupted + resumed {t_parts:.2f} s; max |d| "
            + ", ".join(f"{k} {v:.3e}" for k, v in d.items())
            + f"; bit for bit {bits}; conv {conv:.6f}; window count "
            f"{int(part2.final_window.count.reshape(-1)[0])} {tag}")
        require(state.step == half and meta["preset"] == cfg.name
                and state.x_abs.shape == tuple(np.shape(lanes)),
                f"checkpoint {name}: the state's step, meta and shape round-trip")
        require(bool(torch.isfinite(full.sys_history).all()) and max(d.values()) <= 1e-12,
                f"checkpoint {name}: resumed equals uninterrupted within 1e-12")
        require(torch.equal(part2.final_window.count, full.final_window.count)
                and torch.equal(part2.final_window.valid, full.final_window.valid),
                f"checkpoint {name}: the window's count and valid carry across")
        out[name] = (cfg, full, state, lanes)
    lane_bits_sweep(dev, tag, cfg)
    log(f"  phase 38 took {time.time() - t_phase:.1f} s")
    return out["batch"]


def lane_bits_sweep(dev, tag: str, cfg) -> None:
    """Phase 38's second part: the per-problem stack's lane bits. The
    LBMPC_N40 solve at full width (N=40, q=100; sqp 2, ipm 10: the depth
    cut) in float64 and in float32 on seeded lanes: every lane of a batch
    of B (LANE_BITS_B) equals the same lane of the largest batch, and lanes
    0 and B-1 their solves alone, bit for bit (ops/lanes' forms, one set
    for both dtypes)."""
    import torch

    from lbmpc_tpu_torch.oracle import DataWindow
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    t0 = time.time()
    bmax, q = max(LANE_BITS_B), cfg.oracle.q
    rng = np.random.default_rng(16)
    for dt in ("float64", "float32"):
        c = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, dtype=dt,
                                                                sqp_iters=2, ipm_iters=10))
        sc = build_scenario(c, device=dev)
        f = getattr(torch, dt)
        T = lambda a: torch.as_tensor(a, dtype=f, device=dev)
        dx = T(np.asarray(c.dx_init) + 0.01 * rng.standard_normal((bmax, 4)))
        win = DataWindow(T(0.1 * rng.standard_normal((bmax, q, 3))),
                         T(0.001 * rng.standard_normal((bmax, q, 4))), T(np.ones((bmax, q))),
                         torch.full((bmax,), q, dtype=torch.int32, device=dev))
        z = T(0.01 * rng.standard_normal((bmax, sc.nz)))
        part = lambda i, j: (dx[i:j], DataWindow(*(a[i:j] for a in win)), z[i:j])
        z_all, c_all = sc.solve(*part(0, bmax))
        parted, solo_parted = [], []
        for B in LANE_BITS_B:
            zb, cb = sc.solve(*part(0, B))
            if not (torch_equal(zb, z_all[:B]) and torch.equal(cb, c_all[:B])):
                parted.append(B)
            for i in sorted({0, B - 1}):
                zs, cs_ = sc.solve(*part(i, i + 1))
                if not (torch_equal(zs[0], z_all[i]) and bool(cs_[0] == c_all[i])):
                    solo_parted.append((B, i))
        sync(dev)
        log(f"  lane bits, {dt} (N={c.ocp.N}, q={q}, sqp 2, ipm 10): batches whose lanes part "
            f"from the same lanes of {bmax}: {parted}; lanes whose solve alone parts: "
            f"{solo_parted}; conv {c_all.float().mean().item():.4f} {tag}")
        require(not parted and not solo_parted and bool(torch.isfinite(z_all).all()),
                f"per-problem {dt} solve: a lane's bits at B = {LANE_BITS_B[0]}..{bmax} are "
                "its solve alone's")
    log(f"  lane bits sweep {time.time() - t0:.1f} s")


def sandbox_phase(dev, tag: str, ck) -> None:
    """Phase 39: the tracking sandbox (controllers/tracking_sandbox) on the
    card against the same episode on the CPU, nominal and robust; then
    analysis/metrics.response_info on phase 38's histories on the card
    against the same call on their CPU copy."""
    import torch

    from lbmpc_tpu_torch.analysis.metrics import response_info
    from lbmpc_tpu_torch.controllers.tracking_sandbox import (build_tracking_setup,
                                                              run_tracking_episode)

    t_phase = time.time()
    log("phase 39: the tracking sandbox on the card against the CPU (nominal; robust, "
        "robust_w = w_max = 0.1, seed 7; 100 steps, float64), then response_info on phase 38's "
        "histories")
    cpu = torch.device("cpu")
    for name, setup_kw, kw in (("nominal", {}, {}),
                               ("robust", dict(robust_w=0.1),
                                dict(w_max=0.1, disturbance_seed=7))):
        setup = build_tracking_setup(**setup_kw)
        zero_counts()
        t0 = time.time()
        res = run_tracking_episode(setup, [0.0, -2.0], iterations=100, device=dev, **kw)
        sync(dev)
        wall = time.time() - t0
        no_kernel_launched(f"tracking sandbox {name}", "ops/ipm has none")
        ref = run_tracking_episode(setup, [0.0, -2.0], iterations=100, device=cpu, **kw)
        d = (res.sys_history.to(cpu) - ref.sys_history).abs().amax(dim=1)
        conv, conv_c = res.converged.to(cpu), ref.converged
        first = first_beyond((conv != conv_c).int(), 0)
        first = 100 if first is None else first
        log(f"  {name}: {wall * 10:.2f} ms/step (host clock); conv card {conv.double().mean():.2f} "
            f"cpu {conv_c.double().mean():.2f}, first step converged in one only: {first}; max "
            f"|sysH card - cpu| {d[:first + 1].max().item():.3e} to it, {d.max().item():.3e} "
            f"over all; first row beyond 1e-9: {first_beyond(d, 1e-9)}, beyond 1e-5: "
            f"{first_beyond(d, 1e-5)} {tag}")
        # the QP's H is singular and where a float64 IPM lands on its optimal
        # face turns on roundoff (tests/test_torch_tracking_sandbox.py): 1e-5,
        # up to the first step one computation leaves unconverged and the
        # other not, past which the two trajectories part
        require(bool(torch.isfinite(res.sys_history).all()) and d[:first + 1].max().item() <= 1e-5,
                f"tracking sandbox {name}: card within 1e-5 of the CPU up to the first step "
                "converged in one only")
        sysH = res.sys_history.to(cpu).numpy()
        if name == "nominal":
            ok = (conv.double().mean() >= 0.98 and abs(sysH[30, 0] - 4.95) < 0.3
                  and abs(sysH[60, 0] + 5.5) < 0.6 and abs(sysH[90, 0] - 2.0) < 0.3
                  and abs(sysH[100, 0]) < 0.3 and np.abs(sysH[1:, 2:]).max() <= 0.3 + 1e-6)
        else:
            ok = conv.double().mean() > 0.9 and np.abs(sysH[:, :2]).max() <= 5.0 + 0.15
        require(bool(ok), f"tracking sandbox {name}: the reference test's claims hold on the card "
                "(tests/test_tracking_sandbox.py)")
    cfg, full = ck[:2]
    h = full.sys_history
    for ch in (0, 1):
        x, u = h[..., ch], h[..., -1]
        ref = torch.full_like(x, float(cfg.dx_ref[ch]))
        got = response_info(x, u, ref, cfg.plant.ts)
        want = response_info(x.to(cpu), u.to(cpu), ref.to(cpu), cfg.plant.ts)
        d = max((a.to(cpu) - b).abs().max().item() for a, b in zip(got, want))
        med = {k: v.median().item() for k, v in got._asdict().items()}
        log(f"  response_info x{ch + 1} on {tuple(x.shape)} (card): medians "
            + ", ".join(f"{k} {v:.6g}" for k, v in med.items())
            + f"; max |card - cpu| {d:.3e} {tag}")
        require(all(a.device == x.device and a.dtype == x.dtype for a in got) and d <= 1e-12,
                f"response_info x{ch + 1} on the card within 1e-12 of the CPU")
    log(f"  phase 39 took {time.time() - t_phase:.1f} s")


MESH_FLEET_CHUNK, MESH_FLEET_COHORTS, MESH_FLEET_STEPS = 2048, 4, 3   # phase 40's fleet
SPLIT_N, SPLIT_NW, SPLIT_K, SPLIT_SHARDS = 304, 8, 3, 4    # phase 42's stage split
GN_MESH_N, GN_MESH_SHARDS = 300, 8                          # phase 42's sparse GN gate

MESH_WORKER = r'''
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[4])
import torch.distributed as dist
from lbmpc_tpu_torch.ops.riccati_sharded import lqr_cross_sharded, stage_mesh
from lbmpc_tpu_torch.runtime.sharding import (global_solve_stats, initialize_multihost,
                                              scenario_mesh)
pid, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
initialize_multihost(f"localhost:{port}", num_processes=2, process_id=pid, backend="gloo")
mesh = scenario_mesh(devices=[dev])
conv = torch.tensor([True, False, True, pid == 0], device=dev)
stats = global_solve_stats(mesh, conv)
args = [torch.as_tensor(a, device=dev) for a in np.load(out + ".in.npz").values()]
W, C = lqr_cross_sharded(stage_mesh(devices=[dev]), *args)
np.savez(out + f".{pid}.npz", W=W.cpu().numpy(), C=C.cpu().numpy(), stats=np.array(stats),
         world=dist.get_world_size())
dist.destroy_process_group()
'''


def riccati_problem(N_: int, nw: int, m: int, K: int, seed: int):
    """tests/test_riccati_sharded.py's stage problem, float64 numpy."""
    rng = np.random.default_rng(seed)
    As = 0.95 * rng.standard_normal((N_, nw, nw)) / np.sqrt(nw)
    Bs = rng.standard_normal((N_, nw, m))
    Mq = rng.standard_normal((N_, nw, nw)) / np.sqrt(nw)
    Qs = Mq @ Mq.transpose(0, 2, 1) + 0.1 * np.eye(nw)
    Rs = (np.broadcast_to(np.eye(m), (N_, m, m)).copy()
          + 0.1 * np.abs(rng.standard_normal((N_, 1, 1))) * np.eye(m))
    Ss = 0.05 * rng.standard_normal((N_, nw, m))
    Mp = rng.standard_normal((nw, nw)) / np.sqrt(nw)
    return (As, Bs, Qs, Ss, Rs, rng.standard_normal((N_, nw, K)),
            rng.standard_normal((N_, m, K)), Mp @ Mp.T + 0.1 * np.eye(nw),
            rng.standard_normal((nw, K)))


def cross_reference(args):
    """_riccati_cross column by column: (W (N+1, nw, K), C (N, m, K))."""
    import torch

    from lbmpc_tpu_torch.ops.sparse_gn import _riccati_cross

    As, Bs, Qs, Ss, Rs, qs, rs, PN, pN = args
    cols = [_riccati_cross(*(a[None] for a in (As, Bs, Qs, Ss, Rs)), qs[None, ..., k],
                           rs[None, ..., k], PN[None], pN[None, ..., k])
            for k in range(qs.shape[-1])]
    return (torch.stack([c[0][0] for c in cols], -1), torch.stack([c[1][0] for c in cols], -1))


def run_example(main_fn, argv: list) -> dict:
    """An example's main(argv) in this process: its output logged, its last
    line's JSON returned."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main_fn(argv)
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"    {line}")
    return json.loads(lines[-1])


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_phases(dev, tag: str, args, cfg, sc, dx, win, ck) -> None:
    """Phases 40-44: the multi-device layer (runtime/sharding,
    ops/riccati_sharded, resume over a mesh) on the card, the port's entry
    and examples, and the fused solver's three options (refine=True,
    LBMPC_CHOL=xla, jac_mode="jacfwd")."""
    import os

    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch import entry as t_entry
    from lbmpc_tpu_torch.controllers.lbmpc import make_lbmpc_solver_sparse
    from lbmpc_tpu_torch.controllers.sqp_fused import (make_lbmpc_solver_fused,
                                                       make_lbmpc_solver_hybrid)
    from lbmpc_tpu_torch.examples import fleet_100k, scenario_sweep
    from lbmpc_tpu_torch.ops.ipm_fused import build_fused_qp_solver
    from lbmpc_tpu_torch.ops.lanes import exact_rows
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h_plain
    from lbmpc_tpu_torch.ops.riccati_sharded import lqr_cross_sharded, stage_mesh
    from lbmpc_tpu_torch.ops.sparse_gn import solve_sparse_gn
    from lbmpc_tpu_torch.oracle import DataWindow
    from lbmpc_tpu_torch.runtime.checkpoint import capture, load, resume, save
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario
    from lbmpc_tpu_torch.runtime.sharding import (fleet_runner, global_solve_stats,
                                                  initialize_multihost, scenario_mesh,
                                                  sharded_episode_runner, split_solver)
    import torch.distributed as dist

    f32 = torch.float32
    nz = sc.nz
    cards = torch.cuda.device_count()
    mesh = scenario_mesh(2) if cards == 1 else scenario_mesh()
    times = {}

    # ---- phase 40: the scenario mesh on the card -------------------------------
    t_phase = time.time()
    log(f"phase 40: the scenario mesh on the card: {mesh.size} shards "
        f"({', '.join(str(d) for d in mesh.devices)}); the bench fused solve (pallas_full) at "
        f"batch {BATCH}, the hybrid with the fused repair, fleet_runner cohorts, "
        "global_solve_stats; split against unsplit")
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2,
              ipm_iters=IPM_SCHED, alphas=LADDER, qp_warm=True, qp_kernel="pallas_full",
              device=dev)
    z0 = torch.zeros(BATCH, nz, dtype=f32, device=dev)
    # K1 and K2 give a lane the same bits at any B, and the solver's row
    # products take B-independent forms (ops/lanes.exact_rows)
    fused = make_lbmpc_solver_fused(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, **kw)
    zero_counts()
    z_un, c_un = fused(dx, win, z0)
    sync(dev)
    per = {k: route_counts()[k] for k in ("gn_phase", "mehrotra_h")}
    zero_counts()
    z_sh, c_sh = split_solver(mesh, fused)(dx, win, z0)
    sync(dev)
    split = {k: route_counts()[k] for k in ("gn_phase", "mehrotra_h")}
    log(f"  fused: unsplit launches {per}, split {split}; |dz| max "
        f"{(z_sh - z_un).abs().max().item():.3e}, bit for bit {torch_equal(z_sh, z_un)}, "
        f"conv {c_sh.float().mean().item():.6f} {tag}")
    require(all(split[k] == per[k] * mesh.size and per[k] > 0 for k in per),
            "split fused solve: K1 and K2 launches = the per-shard count x the shards")
    require(torch_equal(z_sh, z_un) and torch_equal(c_sh, c_un),
            "split fused solve equals the unsplit one bit for bit")
    hyb = make_lbmpc_solver_hybrid(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, **kw,
                                   repair_frac=REPAIR_K / BATCH, repair_sqp_iters=1,
                                   repair_ipm_iters=8, repair_warm="fused",
                                   repair_backend="fused")
    # a batch whose flagged lanes all sit in shard 0: lanes the fused solve
    # converges, tiled, then more lanes than the repair takes moved far from
    # the operating point at the head of the batch
    ok = hyb.fused(dx, win, z0)[1].nonzero().flatten()
    idx = ok[torch.arange(BATCH, device=dev) % ok.numel()]
    hard, hard_win = dx[idx].clone(), win.index(idx)
    hard[:REPAIR_K + 8] += torch.tensor([0.0, 0.0, 1.0, 10.0], device=dev)
    for name, dx_h, win_h in (("natural", dx, win), ("flagged lanes in shard 0", hard, hard_win)):
        flags = ~hyb.fused(dx_h, win_h, z0)[1]
        where = flags.nonzero().flatten()
        zu, cu = hyb(dx_h, win_h, z0)
        zero_counts()
        zs, cs = split_solver(mesh, hyb)(dx_h, win_h, z0)
        sync(dev)
        d = (zs - zu).abs().max().item()
        b = BATCH // mesh.size
        log(f"  hybrid, {name}: {int(flags.sum())} lanes flagged by the fused solve (shards "
            f"{sorted(set((where // b).tolist()))}); split vs unsplit |dz| max {d:.3e}, bit for "
            f"bit {torch_equal(zs, zu)}, flags equal {torch_equal(cs, cu)}, conv "
            f"{cs.float().mean().item():.6f}; launches {route_counts()} {tag}")
        require(bool(torch.isfinite(zs).all()) and d < 5e-3 and torch_equal(cs, cu),
                f"split hybrid ({name}) within 5e-3 of the unsplit one, the same flags")
        if name != "natural":
            require(int(flags[:b].sum()) > REPAIR_K and int(flags[b:].sum()) == 0,
                    "the hard lanes are flagged, all in shard 0, more than the repair's K")
    fcfg = dataclasses.replace(cfg, iterations=MESH_FLEET_STEPS)
    _, run = build_fleet_episode(fcfg, backend="fused", ipm_iters=IPM_SCHED, sqp_iters=2,
                                 qp_warm=True, warm_chain=True, qp_kernel="pallas_full",
                                 device=dev)
    F = MESH_FLEET_COHORTS * MESH_FLEET_CHUNK
    dx_all = torch.as_tensor(np.array([-0.35, -0.4, 0.0, 0.0])
                             + np.random.default_rng(40).uniform(-0.02, 0.02, (F, 4)),
                             dtype=f32, device=dev)
    zero_counts()
    t0 = time.time()
    res = fleet_runner(run, mesh, MESH_FLEET_CHUNK)(dx_all)
    sync(dev)
    t_split = time.time() - t0
    counts = route_counts()
    t0 = time.time()
    direct = [run(dx_all[i:i + MESH_FLEET_CHUNK]) for i in range(0, F, MESH_FLEET_CHUNK)]
    sync(dev)
    t_direct = time.time() - t0
    same = all(torch_equal(res.sys_history[i * MESH_FLEET_CHUNK:(i + 1) * MESH_FLEET_CHUNK],
                           r.sys_history) for i, r in enumerate(direct))
    conv = res.solver_converged.all(dim=-1)
    stats = global_solve_stats(mesh, conv)
    log(f"  fleet_runner: F={F}, chunk {MESH_FLEET_CHUNK}, {MESH_FLEET_STEPS} steps, "
        f"pallas_full warm chain: {t_split:.2f} s split, {t_direct:.2f} s cohort by cohort; "
        f"bit for bit {same}; launches {counts}; global_solve_stats {stats} {tag}")
    require(same, "fleet_runner equals the cohort-by-cohort run bit for bit")
    require(counts["gn_phase"] > 0 and counts["mehrotra_h"] > 0,
            "fleet_runner launched K1 and K2")
    require(stats == (int(conv.sum()), F), "global_solve_stats sums every shard")
    times[40] = time.time() - t_phase
    log(f"  phase 40 took {times[40]:.1f} s")

    # ---- phase 41: collectives on the card --------------------------------------
    t_phase = time.time()
    log("phase 41: collectives on the card: an NCCL group of world size 1 in this process "
        "(a localhost TCP store), then two processes sharing the card on gloo")
    args_np = riccati_problem(64, SPLIT_NW, 1, SPLIT_K, seed=41)
    t64 = [torch.as_tensor(a, device=dev) for a in args_np]
    W1, C1 = lqr_cross_sharded(stage_mesh(devices=[dev]), *t64)
    W2, C2 = lqr_cross_sharded(stage_mesh(devices=[dev] * 2), *t64)
    Wr, _ = cross_reference(t64)
    initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        gm = scenario_mesh()
        conv = torch.tensor([True, False, True, True], device=dev)
        st = global_solve_stats(gm, conv)
        Wn, Cn = lqr_cross_sharded(stage_mesh(), *t64)
        sync(dev)
        log(f"  NCCL: backend {dist.get_backend()}, world {dist.get_world_size()}, mesh "
            f"{gm.devices} distributed={gm.distributed}; global_solve_stats {st}; "
            f"lqr_cross_sharded equal to one in-process shard {torch_equal(Wn, W1)}, "
            f"{(Wn - Wr).abs().max().item():.3e} from _riccati_cross {tag}")
        require(gm.distributed and st == (3, 4), "NCCL: global_solve_stats through the group")
        require(torch_equal(Wn, W1) and torch_equal(Cn, C1),
                "NCCL: lqr_cross_sharded through the group equals the in-process sweep")
    finally:
        dist.destroy_process_group()
    out = ROOT / "build" / "mesh_worker" / "sweep"
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(out) + ".in.npz", *args_np)
    worker = out.parent / "worker.py"
    worker.write_text(MESH_WORKER)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(port), str(out),
                               str(ROOT)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for i in range(2)]
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            log(text[-3000:])
        require(p.returncode == 0, f"gloo rank {i} exited 0")
        got = np.load(str(out) + f".{i}.npz")
        same = (np.array_equal(got["W"], W2.cpu().numpy())
                and np.array_equal(got["C"], C2.cpu().numpy()))
        log(f"  gloo rank {i}: world {int(got['world'])}, global_solve_stats "
            f"{tuple(got['stats'])}, lqr_cross_sharded equal to the in-process 2-shard sweep "
            f"{same} {tag}")
        require(tuple(got["stats"]) == (5, 8), f"gloo rank {i}: global_solve_stats (5, 8)")
        require(same, f"gloo rank {i}: its sweep equals the in-process one bit for bit")
    times[41] = time.time() - t_phase
    log(f"  phase 41 took {times[41]:.1f} s")

    # ---- phase 42: the stage split and resume over a mesh ----------------------
    t_phase = time.time()
    log(f"phase 42: lqr_cross_sharded at N={SPLIT_N}, nw={SPLIT_NW}, m=1, K={SPLIT_K} over "
        f"{SPLIT_SHARDS} stage shards; solve_sparse_gn on DMS_LBMPC_q100 at N={GN_MESH_N} over "
        f"{GN_MESH_SHARDS} shards; resume over the scenario mesh (phase 38's batch)")
    args_np = riccati_problem(SPLIT_N, SPLIT_NW, 1, SPLIT_K, seed=42)
    t64 = [torch.as_tensor(a, device=dev) for a in args_np]
    smesh = stage_mesh(SPLIT_SHARDS)
    W, C = lqr_cross_sharded(smesh, *t64)
    Wr, Cr = cross_reference(t64)
    dW = (W - Wr).abs().max().item() / (Wr.abs().max().item() + 1.0)
    dC = (C - Cr).abs().max().item() / (Cr.abs().max().item() + 1.0)
    W32, _ = lqr_cross_sharded(smesh, *(a.float() for a in t64))
    d32 = (W32.double() - W).abs().max().item() / (W.abs().max().item() + 1.0)
    log(f"  float64: W {dW:.3e}, C {dC:.3e} (relative) from _riccati_cross; float32 "
        f"{d32:.3e} from float64 {tag}")
    require(dW < 1e-8 and dC < 1e-8, "stage split within 1e-8 (scaled) of _riccati_cross")
    require(d32 < 1e-3, "stage split in float32 within 1e-3 (scaled) of float64")
    gcfg = lt.make_preset("DMS_LBMPC_q100")
    gcfg = dataclasses.replace(gcfg, ocp=dataclasses.replace(gcfg.ocp, N=GN_MESH_N))
    gsc = build_scenario(gcfg)
    solve = make_lbmpc_solver_sparse(
        gsc.qp, gsc.A, gsc.B, gsc.ocp.Ks, gsc.w, gsc.cs, family="casadi",
        delta=gcfg.plant.ts, bandwidth=gcfg.oracle.bandwidth, ridge=gcfg.oracle.ridge,
        dx_ref=np.asarray(gcfg.dx_ref), terminal_at=gcfg.ocp.terminal_at,
        tighten_first_step=gcfg.ocp.tighten_first_step, dtype=torch.float64, device=dev)
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    gwin = DataWindow(t(0.1 * rng.standard_normal((1, 32, 3))),
                      t(0.001 * rng.standard_normal((1, 32, 4))),
                      t(np.ones((1, 32))), torch.full((1,), 32, dtype=torch.int32, device=dev))
    gdx = t((np.asarray(gcfg.x_init_abs) - np.asarray(gcfg.plant.x_wp))[None])
    gz = t(np.concatenate([0.005 * rng.standard_normal(GN_MESH_N),
                           0.01 * rng.standard_normal(1)])[None])
    lin = solve.linearize(gz, gdx, gwin)
    t0 = time.time()
    un = solve_sparse_gn(solve.stage_qp, *lin, iters=25)
    sync(dev)
    t_un = time.time() - t0
    t0 = time.time()
    shd = solve_sparse_gn(solve.stage_qp, *lin, iters=25, mesh=stage_mesh(GN_MESH_SHARDS))
    sync(dev)
    t_sh = time.time() - t0
    scale = un.dC.abs().max().item() + 1.0
    dd = (shd.dC - un.dC).abs().max().item()
    dth = (shd.dth - un.dth).abs().max().item()
    log(f"  sparse GN N={GN_MESH_N}: |d dC| {dd:.3e}, |d dtheta| {dth:.3e} (scale {scale:.4g}); "
        f"converged {bool(un.converged[0])} / {bool(shd.converged[0])}; {t_un:.2f} s unsplit, "
        f"{t_sh:.2f} s over {GN_MESH_SHARDS} shards (eager) {tag}")
    require(bool(un.converged.all() and shd.converged.all()) and dd < 1e-7 * scale
            and dth < 1e-7 * scale, "stage-sharded GN within 1e-7 * scale of mesh=None")
    # the reference's test_sharded_fleet_checkpoint_resume: interrupted over
    # the mesh, resumed over it, against the uninterrupted run over it; and
    # against phase 38's unsplit run, bit for bit: the per-problem stack's
    # products take ops/lanes' forms, so a shard's 128 lanes round as they
    # do among 256
    ck_cfg, full, _, dx_ck = ck
    half = CK_STEPS // 2
    ck_sc = build_scenario(ck_cfg, device=dev)
    sc_half = build_scenario(dataclasses.replace(ck_cfg, iterations=half), device=dev)
    zero_counts()
    t0 = time.time()
    full_s = sharded_episode_runner(ck_sc.run_batch, mesh)(dx_ck)
    part1 = sharded_episode_runner(sc_half.run_batch, mesh)(dx_ck)
    path = ROOT / "build" / "checkpoints" / "phase42.npz"
    save(path, capture(part1, step=half), meta={"preset": ck_cfg.name, "shards": mesh.size})
    state, _ = load(path)
    part2 = resume(ck_sc, state, steps=CK_STEPS - half, mesh=mesh)
    sync(dev)
    t_res = time.time() - t0
    no_kernel_launched("resume over a mesh", "the float64 per-problem SQP has none")

    def dist(a, b):
        pairs = {"sys_history": (a[0], b.sys_history[:, half + 1:]),
                 "final_x": (a[1], b.final_x), "final_window.Y": (a[2], b.final_window.Y)}
        return ({k: (x - y).abs().max().item() for k, (x, y) in pairs.items()},
                all(torch_equal(x, y) for x, y in pairs.values()))

    got = (part2.sys_history[:, 1:], part2.final_x, part2.final_window.Y)
    d_s, bits_s = dist(got, full_s)
    d_u, bits_u = dist(got, full)
    log(f"  resume over {mesh.size} shards, {tuple(state.x_abs.shape)} lanes, {half} + "
        f"{CK_STEPS - half} steps (uninterrupted, interrupted and resumed, over the mesh): "
        f"{t_res:.2f} s; against the uninterrupted run over the mesh max |d| "
        + ", ".join(f"{k} {v:.3e}" for k, v in d_s.items()) + f", bit for bit {bits_s}; "
        "against phase 38's unsplit run " + ", ".join(f"{k} {v:.3e}" for k, v in d_u.items())
        + f", bit for bit {bits_u} {tag}")
    require(max(d_s.values()) <= 1e-12,
            "resume over a mesh equals the uninterrupted run over it within 1e-12")
    require(bits_u, "resume over a mesh equals phase 38's unsplit run bit for bit")
    times[42] = time.time() - t_phase
    log(f"  phase 42 took {times[42]:.1f} s")

    # ---- phase 43: the entry and the examples ----------------------------------
    t_phase = time.time()
    log("phase 43: the port's entry (entry(), dryrun_multichip(2)) and the examples")
    fn, (dx8,) = t_entry.entry()
    ze, ce = fn(dx8)
    sync(dev)
    log(f"  entry: z {tuple(ze.shape)} on {ze.device}, conv {ce.float().mean().item():.3f}")
    require(ze.device.type == "cuda" and bool(torch.isfinite(ze).all()) and bool(ce.all()),
            "entry(): the flagship batch solved on the card, finite, converged")
    zero_counts()
    dr = t_entry.dryrun_multichip(2)
    log(f"  dryrun_multichip(2): {json.dumps(dr)}; launches {route_counts()} {tag}")
    require(dr["stage2"]["max_diff"] < 5e-3 and dr["stage4"]["rel_diff"] < 1e-9,
            "dryrun_multichip(2): every stage's gate")
    for argv in (["--instances", "16384", "--chunk", "8192", "--steps", "3", "--fused",
                  "--qp-kernel", "pallas_full", "--warm-chain"],
                 ["--instances", "4096", "--chunk", "2048", "--steps", "2"]):
        zero_counts()
        line = run_example(fleet_100k.main, argv)
        log(f"  fleet_100k {' '.join(argv)}: {line['value']} solves/s, converged "
            f"{line['converged_frac']}; launches {route_counts()} {tag}")
        require(line["metric"] == "fleet_closed_loop_solves_per_s" and line["value"] > 0
                and line["device"] == torch.cuda.get_device_name(0),
                "fleet_100k prints its JSON line with the card's name")
        if "--fused" in argv:
            require(route_counts()["gn_phase"] > 0 and route_counts()["mehrotra_h"] > 0,
                    "fleet_100k --fused --qp-kernel pallas_full launched K1 and K2")
    line = run_example(scenario_sweep.main, ["--scenarios", "1024", "--steps", "5"])
    require(line["total"] == 1024 and line["value"] > 0, "scenario_sweep ran 1024 scenarios")
    times[43] = time.time() - t_phase
    log(f"  phase 43 took {times[43]:.1f} s")

    # ---- phase 44: the fused solver's three options ----------------------------
    t_phase = time.time()
    log(f"phase 44: refine=True on the DMS QP (nz=101, batch {DMS_BATCH}); LBMPC_CHOL=xla "
        f"and jac_mode='jacfwd' on the bench xla solve (batch {BATCH})")
    dcfg = lt.make_preset("DMS_LBMPC_q100")
    dcfg = dataclasses.replace(dcfg, solver=dataclasses.replace(dcfg.solver, dtype="float32"))
    ds = build_scenario(dcfg)
    dkw = dict(family="casadi", delta=dcfg.plant.ts, bandwidth=dcfg.oracle.bandwidth,
               ridge=dcfg.oracle.ridge, dx_ref=np.asarray(dcfg.dx_ref), device=dev)
    dsolver = make_lbmpc_solver_fused(ds.qp, ds.A, ds.B, ds.ocp.Ks, ds.w, **dkw)
    rng = np.random.default_rng(44)
    _, dwin, _ = bench_inputs(rng, DMS_BATCH, ds.nz, dev)
    x0 = np.asarray(dcfg.x_init_abs) - np.asarray(dcfg.plant.x_wp)
    ddx = torch.as_tensor(x0 + 0.01 * rng.standard_normal((DMS_BATCH, 4)), dtype=f32,
                          device=dev)
    dz0 = torch.zeros(DMS_BATCH, ds.nz, dtype=f32, device=dev)
    _, H, g = dsolver.gn.plain(dz0, ddx, dwin)
    h = dsolver.h0[None] + ddx @ dsolver.Hp.T - dz0 @ dsolver.G.T
    it = XLA_SCHED[0]
    sols, k5c = {}, {}
    for refine in (False, True):
        qps = build_fused_qp_solver(None, ds.qp.G, iters=it, refine=refine, device=dev)
        zero_counts()
        sols[refine] = qps.raw_with_H(H, g, h)
        sync(dev)
        k5c[refine] = chol_counts()["chol_resolve"]
    d64 = mehrotra_h_plain(dsolver.G.double(), H.double(), g.double(), h.double(), 60)[0]
    on, off = sols[True], sols[False]
    log(f"  refine: K5c launches {k5c[False]} -> {k5c[True]} ({it} IPM iterations); conv "
        f"{off.converged.float().mean().item():.4f} -> {on.converged.float().mean().item():.4f}"
        f"; |x_refine - x| max {(on.x - off.x).abs().max().item():.3e} {tag}")
    require(k5c[True] - k5c[False] == it, "refine=True: one more K5c launch an IPM iteration")
    require(bool(torch.isfinite(on.x).all()), "refine=True: finite")
    f64_gates("refine=True vs refine=False (DMS QP, float64 solve at 60 iterations)", on.x,
              on.mu, off.x, off.mu, d64)
    require(on.converged.float().mean().item() >= off.converged.float().mean().item() - 0.005,
            "refine=True: conv within 0.5 pp of refine=False or above")
    bkw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
               ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2,
               ipm_iters=XLA_SCHED, alphas=LADDER, device=dev)
    bench = lambda **extra: make_lbmpc_solver_fused(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w,
                                                    **bkw, **extra)
    k5 = bench()
    zero_counts()
    zk, ckv = k5(dx, win, z0)
    sync(dev)
    require(chol_counts()["chol_factor_solve"] > 0, "the K5 route launched K5a")
    os.environ["LBMPC_CHOL"] = "xla"
    try:
        lib = bench()
    finally:
        del os.environ["LBMPC_CHOL"]
    zero_counts()
    zl, cl = lib(dx, win, z0)
    sync(dev)
    log(f"  LBMPC_CHOL=xla: launches {chol_counts()} {tag}")
    require(chol_counts() == chol_none(), "LBMPC_CHOL=xla launches no K5 or K6")
    route_gates("LBMPC_CHOL=xla vs the K5 route (bench xla solve)", zl, cl, zk, ckv)
    fwd = bench(jac_mode="jacfwd")
    z1 = 0.01 * torch.randn(BATCH, nz, generator=torch.Generator().manual_seed(44)).to(dev)
    J_fwd = fwd.gn.jacfwd(z1, dx, win)
    J_man = fwd.gn.res_jac(z1, dx, win)[1]
    dJ = (J_fwd - J_man).abs().max().item() / J_man.abs().max().item()
    t0 = time.time()
    zf, cf = fwd(dx, win, z0)
    sync(dev)
    t_fwd = time.time() - t0
    log(f"  jac_mode='jacfwd': J {tuple(J_fwd.shape)} {dJ:.3e} (relative) from the "
        f"hand-derived J; {t_fwd * 1e3:.1f} ms a solve (host clock, first call) {tag}")
    require(dJ < 1e-5, "jacfwd's J within float32 roundoff (1e-5 of max|J|) of the manual J")
    # two float32 computations of J that agree to roundoff may part where
    # the first QP (16 IPM iterations) stalls on either side: there a
    # roundoff-level change moves the stalled iterate far, as
    # qp_step_gates allows for a QP step. jacfwd is held to the manual J's
    # solve by solve_gates on every lane where neither first QP stalled;
    # every lane beyond 5e-2 must have stalled on a side, the stalled shares
    # within 2 pp. The library Cholesky's lanes are logged beside.
    qp1 = build_fused_qp_solver(None, sc.qp.G, iters=XLA_SCHED[0], device=dev)
    hb = k5.h0[None] + exact_rows(dx, k5.Hp)
    first_mu = lambda s, mode: qp1.raw_with_H(*s.gn.plain(z0, dx, win, mode)[1:], hb).mu
    mu_man, mu_fwd = first_mu(k5, "manual"), first_mu(fwd, "jacfwd")
    stalled = ~((mu_man < 1e-6) & (mu_fwd < 1e-6))
    far = lambda z_: ~((z_ - zk).abs().amax(dim=1) <= 5e-2)
    lanes = lambda m: m.nonzero().flatten().tolist()
    share = lambda m: (~(m < 1e-6)).float().mean().item()
    log(f"  lanes beyond 5e-2 of the K5 route: LBMPC_CHOL=xla {lanes(far(zl))}, jacfwd "
        f"{lanes(far(zf))}; first QP stalled (mu >= 1e-6) on a side of jacfwd's "
        f"{lanes(far(zf) & stalled)}; stalled shares manual {share(mu_man):.4f}, jacfwd "
        f"{share(mu_fwd):.4f} {tag}")
    require(not bool((far(zf) & ~stalled).any()) and abs(share(mu_man) - share(mu_fwd)) <= 0.02,
            "jacfwd parts beyond 5e-2 from the manual J's solve only on lanes whose first QP "
            "stalled on a side, stalled shares within 2 pp")
    solve_gates("jac_mode='jacfwd' vs 'manual' (bench xla solve, the lanes whose first QP "
                "stalled on neither side)", zf[~stalled], cf[~stalled], zk[~stalled],
                ckv[~stalled])
    route_gates("jac_mode='jacfwd' vs 'manual' (bench xla solve)", zf, cf, zk, ckv)
    times[44] = time.time() - t_phase
    log(f"  phase 44 took {times[44]:.1f} s; phases 40-44 {sum(times.values()):.1f} s")


SPLIT_FLEET_F, SPLIT_FLEET_CHUNK = 64, 16   # phase 45: tests/test_runtime.py:211-249


def fleet_split_phase(dev, tag: str) -> None:
    """Phase 45: the reference's own contract for a split fleet
    (tests/test_runtime.py's test_fleet_runner_chunked_matches_direct) on
    the card: LBMPC_N40 cut to N=8, q=8, float32, sqp 1, ipm 10, 3 steps,
    F=64 seeded lanes; fleet_runner over 8 shards and over 4 of the card in
    cohorts of 16 against the direct call (run_batch on the 64 lanes),
    within the reference's 1e-6 and bit for bit; global_solve_stats over
    the mesh; F=50 raises. The per-problem stack launches no kernel."""
    import torch

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.runtime.scenario import build_scenario
    from lbmpc_tpu_torch.runtime.sharding import (fleet_runner, global_solve_stats,
                                                  scenario_mesh)

    t_phase = time.time()
    log(f"phase 45: the reference's float32 fleet split on the card (LBMPC_N40 cut to N=8, "
        f"q=8, sqp 1, ipm 10, 3 steps; F={SPLIT_FLEET_F} in cohorts of {SPLIT_FLEET_CHUNK} "
        "over 8 and 4 shards) against the direct call")
    cfg = lt.make_preset("LBMPC_N40", iterations=3)
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
        solver=dataclasses.replace(cfg.solver, dtype="float32", sqp_iters=1, ipm_iters=10),
        oracle=dataclasses.replace(cfg.oracle, q=8))
    sc = build_scenario(cfg, device=dev)
    dx0 = torch.as_tensor(np.array([-0.35, -0.4, 0.0, 0.0]) + np.random.default_rng(0)
                          .uniform(-0.02, 0.02, (SPLIT_FLEET_F, 4)), device=dev)
    zero_counts()
    direct = sc.run_batch(dx0)
    for shards in (8, 4):
        mesh = scenario_mesh(shards)
        res = fleet_runner(sc.run_batch, mesh, chunk=SPLIT_FLEET_CHUNK)(dx0)
        sync(dev)
        d = (res.sys_history - direct.sys_history).abs().max().item()
        bits = torch.equal(res.sys_history, direct.sys_history)
        stats = global_solve_stats(mesh, res.solver_converged.all(dim=-1))
        log(f"  {shards} shards ({SPLIT_FLEET_CHUNK // shards} lanes a shard a cohort): "
            f"sys_history {tuple(res.sys_history.shape)}, max |d| "
            f"{d:.3e} from the direct call, bit for bit {bits}; global_solve_stats {stats} {tag}")
        require(res.sys_history.shape[0] == SPLIT_FLEET_F
                and bool(torch.isfinite(res.sys_history).all()) and d <= 1e-6,
                f"fleet_runner over {shards} shards within 1e-6 of the direct call")
        require(bits, f"fleet_runner over {shards} shards equals the direct call bit for bit")
        require(stats[1] == SPLIT_FLEET_F and stats[0] > 0,
                f"global_solve_stats over {shards} shards counts every lane, some converged")
        try:
            fleet_runner(sc.run_batch, mesh, chunk=SPLIT_FLEET_CHUNK)(dx0[:50])
            raised = False
        except ValueError as e:
            raised = "not a multiple of chunk" in str(e)
        require(raised, f"fleet_runner over {shards} shards refuses F=50 (not a multiple of "
                f"{SPLIT_FLEET_CHUNK})")
    no_kernel_launched("the reference's fleet split", "the per-problem stack has none")
    log(f"  phase 45 took {time.time() - t_phase:.1f} s")


def first_beyond(d, tol: float):
    """The first index where d exceeds tol, None where it never does."""
    far = (d > tol).nonzero()
    return int(far[0, 0]) if far.numel() else None


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile_fleet(cfg, fleet_kw: dict, dx_init, tag: str) -> None:
    """A device trace (runtime/profiling.device_trace) of a 3-step fleet
    episode at the cohort: device time by kernel name and the device's busy
    share of the host wall time."""
    import torch

    from lbmpc_tpu_torch.runtime.profiling import device_trace
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    _, run = build_fleet_episode(cfg, **fleet_kw)
    run(dx_init)
    torch.cuda.synchronize()
    with device_trace(trace_dir(f"fleet_{fleet_kw.get('qp_kernel', 'xla')}")) as prof:
        t0 = time.time()
        run(dx_init)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    rows = device_rows(prof)
    busy = sum(r[1] for r in rows)
    n_launch = sum(r[2] for r in rows)
    log(f"  profile: {cfg.iterations} steps, wall {wall_ms:.3f} ms, device busy "
        f"{busy:.3f} ms ({100 * busy / wall_ms:.2f}%), {n_launch} device ops {tag}")
    for key, ms, cnt in rows[:12]:
        log(f"    {ms:9.3f} ms  {cnt:6d}x  {key[:90]}")


def finish(card: str, kind: str, kernels: dict, args) -> int:
    import torch

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "lbmpc_tpu"
                    or m.startswith("lbmpc_tpu."))
    require(not leaked, f"no jax / lbmpc_tpu module imported ({leaked[:3]})")
    if args.stop_after >= KERNELS_PHASE:
        log(f"phase {KERNELS_PHASE}: kernels")
        keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms")
        extra = ("ms_host", "max_abs_err_held", "nan_lanes", "far_from_float64", "ms_8_iters",
                 "plain_ms_8_iters", "bound_ms_8_iters", "bound_ms_dense", "ms_2_iters",
                 "ms_by_batch", "ms_host_by_batch", "k5_ms_by_batch", "bound_ms_by_batch",
                 "warps_a_lane", "lanes_a_block", "lanes_an_sm", "ptxas")
        rows = [{**{k: v.get(k) for k in keys}, **{k: v[k] for k in extra if k in v}}
                for v in kernels.values()]
        require(all(r[k] is not None for r in rows for k in keys if k != "library_ms"),
                "every kernel row complete")
        log(card)
        log(json.dumps({"kernels": rows}))
    else:
        log(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
