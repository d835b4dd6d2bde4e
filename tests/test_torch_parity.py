"""PyTorch port against the reference's golden trajectories (tests/golden,
extracted from the reference MATLAB runs), with the bounds of
tests/test_parity.py:
- LMPC_N50 pointwise: golden states through build_scenario(...).solve in
  one batch (float64, controllers/lmpc on ops/ipm); every 10th golden state
  here, all 1000 behind RUN_SLOW;
- LBMPC_N50 float64 closed loop (build_scenario(...).run(): the per-problem
  SQP, the plant, the learning window): 30 steps here, 300 behind RUN_SLOW;
- the casadi family's float64 episodes (the rk4 plant; the DMS warm start):
  DMS_LMPC (150 steps here, 500 behind RUN_SLOW) and DMS_LBMPC_q100 at
  N=50 (30 / 500 steps), absolute states against the reference's DMS
  goldens;
- the float32 pallas_mono hybrid fleet at LBMPC_N50 (nz=51: K3w's plain
  version on the CPU, the vmapped repair) with the envelope of the
  reference's shipping-backend parity test (tests/test_parity.py:229-300)
  over its first 40 steps; 300 steps behind RUN_SLOW;
- that test's own configuration (float32 pallas_full, the fused repair):
  the steps its fused solve flags before step 40, and that the flag is the
  last QP's (8 cold iterations end above mu 1e-2 in float64 too)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode, build_scenario

RUN_SLOW = bool(os.environ.get("RUN_SLOW"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_lmpc_pointwise_control_parity(golden):
    """Golden states into the LMPC QP: du = Ks dx + c_0 against the golden
    input within fmincon's envelope (median < 2e-6, max < 5e-4, fewer than
    10 steps above 1e-4), and the artificial reference Lambda theta against
    art_refH (median < 1e-7, max < 5e-4)."""
    sc = build_scenario("LMPC_N50", device="cpu")
    gold = golden("LMPC_N50")
    g = gold["sysH"]                               # (5, 1001): [dx_k; du_{k-1}]
    idx = np.arange(g.shape[1] - 1) if RUN_SLOW else np.arange(0, g.shape[1] - 1, 10)
    dxs = torch.tensor(g[:4, idx].T)
    z, conv = sc.solve(dxs, None, None)
    assert z.dtype == torch.float64 and bool(conv.all())
    Ks = torch.tensor(np.atleast_2d(sc.ocp.Ks))
    du = ((dxs @ Ks.T)[:, 0] + z[:, 0]).numpy()
    err = np.abs(du - g[4, idx + 1])
    assert np.median(err) < 2e-6, np.median(err)
    assert err.max() < 5e-4, err.max()
    assert (err > 1e-4).sum() < 10
    nth = np.asarray(sc.ocp.LAMBDA).shape[1]
    art = z[:, -nth:].numpy() @ np.asarray(sc.ocp.LAMBDA)[:1].T
    aerr = np.abs(art[:, 0] - gold["art_refH"][idx + 1])
    assert np.median(aerr) < 1e-7 and aerr.max() < 5e-4, (np.median(aerr), aerr.max())


def test_lbmpc_closed_loop_parity(golden):
    """LBMPC fmincon family at float64, learning on: the closed loop against
    the golden within max 5e-4, the theta channel within 2e-4."""
    steps = 300 if RUN_SLOW else 30
    sc = build_scenario(lt.make_preset("LBMPC_N50", iterations=steps), device="cpu")
    res = sc.run()
    assert bool(res.solver_converged.all())
    assert res.sys_history.shape == (steps + 1, 5) and res.sys_history.dtype == torch.float64
    sysH = res.sys_history.numpy().T
    g = golden("LBMPC_N50")
    err = np.abs(sysH - g["sysH"][:, : steps + 1])
    assert err.max() < 5e-4, err.max()
    aerr = np.abs(res.art_history.numpy()[:, 0] - g["art_refH"][1: steps + 1])
    assert aerr.max() < 2e-4, aerr.max()
    assert int(res.final_window.count) == 1 + steps


def test_dms_lmpc_casadi_closed_loop_parity(golden):
    """CasADi-family LMPC (DMS, N=50): the pre-step absolute states against
    DMS_N50_tLMPC with the reference's bounds (x1 1e-5, x2 1e-4, x3 5e-3;
    over 500 steps also x4 1e-3 after step 200 and every state 1e-3 after
    step 400)."""
    steps = 500 if RUN_SLOW else 150
    sc = build_scenario(lt.make_preset("DMS_LMPC", iterations=steps), device="cpu")
    res = sc.run()
    assert bool(res.solver_converged.all())
    ours = res.sys_history.numpy()[:-1, :4] + np.asarray(sc.cfg.plant.x_wp)
    err = np.abs(ours.T - golden("DMS_N50_tLMPC")[:, :steps])
    assert err[0].max() < 1e-5 and err[1].max() < 1e-4 and err[2].max() < 5e-3, err.max(axis=1)
    if steps == 500:
        assert err[3, 200:].max() < 1e-3 and err[:, 400:].max() < 1e-3


def test_dms_lbmpc_casadi_closed_loop_parity(golden):
    """The casadi-family LBMPC (DMS_LBMPC_q100 at N=50, q=100; the
    shift-and-append warm start) against DMS_N50_tLBMPC_q100 with the
    reference's bounds: x1 1e-4, x2 2e-4, x3 1e-3, x4 5e-2."""
    steps = 500 if RUN_SLOW else 30
    cfg = lt.make_preset("DMS_LBMPC_q100", iterations=steps)
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=50))
    sc = build_scenario(cfg, device="cpu")
    res = sc.run()
    assert bool(res.solver_converged.all())
    ours = res.sys_history.numpy()[1:steps + 1, :4] + np.asarray(cfg.plant.x_wp)
    err = np.abs(ours.T - golden("DMS_N50_tLBMPC_q100")[:, :steps]).max(axis=1)
    assert err[0] < 1e-4 and err[1] < 2e-4 and err[2] < 1e-3 and err[3] < 5e-2, err


def test_pallas_mono_hybrid_closed_loop_golden_parity(golden):
    """The float32 pallas_mono hybrid fleet (sqp 2, ipm (16, 8), ladders
    ((1,), (1, .5, .25)), the vmapped repair of 1 GN x 8 IPM from the fused
    iterate, K=1) on one lane at LBMPC_N50 against the golden: conv on every
    step, max < 2e-2, the first two states < 2e-3 (the reference's envelope
    for its float32 shipping backend), over the first 40 steps. Further on
    this float32 configuration leaves the envelope — the reference's own
    (its xla route, the same repair) from step 36 on
    (tools/n50_float32_reference.py) — so RUN_SLOW runs 300 steps and holds
    the same 40, and the rest finite."""
    held = 40
    steps = 300 if RUN_SLOW else held
    cfg = lt.make_preset("LBMPC_N50", iterations=steps)
    _, run = build_fleet_episode(cfg, backend="hybrid", qp_kernel="pallas_mono",
                                 ipm_iters=(16, 8), sqp_iters=2, device="cpu")
    s = run.solver
    assert (s.fused.qp_kernel, s.repair_backend, s.repair_warm) == ("pallas_mono", "vmapped",
                                                                   "fused")
    res = run(np.asarray(cfg.dx_init)[None])
    assert bool(res.sys_history.isfinite().all())
    assert bool(res.solver_converged[:, :held].all())
    err = np.abs(res.sys_history.numpy()[0].T[:, : held + 1]
                 - golden("LBMPC_N50")["sysH"][:, : held + 1])
    assert err.max() < 2e-2, err.max()
    assert err[:2].max() < 2e-3, err[:2].max()


def test_pallas_full_shipping_configuration_flags_are_its_qps(golden):
    """The reference's shipping-backend configuration as tests/test_parity.py:
    229-291 builds it (the float32 pallas_full hybrid, sqp 2, ipm (16, 8),
    the fused repair of 1 of 8 identical lanes, learning on) on the CPU
    (K1w's and K2w's plain versions), 40 steps. The reference's test claims
    every step converged; here, as on the card (chip_smoke.py phase 32),
    the fused solve flags a step before step 40 (ROADMAP §3). This pins the
    flag and what it rests on: at the first flagged step the fused solve's
    last QP (8 cold Mehrotra iterations) ends with mu above the flag's
    1e-2, in float64 too, so the flag is the QP's iteration budget and not
    float32 rounding (the reference's own K2w ends there above 1e-2 as well,
    tools/shipping_witness.py). The 8 lanes stay identical and finite."""
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra_h_plain

    steps, B = 40, 8
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
    assert bool(res.sys_history.isfinite().all())
    assert bool((res.sys_history == res.sys_history[:1]).all())
    flagged = np.nonzero(~res.solver_converged[0].numpy())[0]
    assert flagged.size and 30 <= flagged[0] < steps, flagged
    # the fused solve again on the first flagged step's inputs, its QPs kept
    fused, qps = solver.fused, []

    def keeping(qp):
        solve = qp.raw_packed

        def kept(H, g, h, warm=None):
            qps.append((qp, H, g, h))
            return solve(H, g, h, warm)
        return kept

    for qp in fused._qps.values():
        qp.raw_packed = keeping(qp)
    _, conv = fused.raw(*calls[flagged[0]])
    assert not bool(conv.any())
    qp, H, g, h = qps[-1]
    assert qp.iters == 8
    d = lambda a: a.double()
    _, mu32, _ = mehrotra_h_plain(fused.G, H, g, h, qp.iters, qp.tau, qp.d_cap)
    _, mu64, _ = mehrotra_h_plain(d(fused.G), d(H), d(g), d(h), qp.iters, qp.tau, qp.d_cap)
    assert bool((mu32 >= 1e-2).all()) and bool((mu64 >= 1e-2).all()), (mu32[0], mu64[0])
