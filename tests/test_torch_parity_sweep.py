"""PyTorch port against the rest of the reference's golden trajectories
(tests/golden) on paths ported before the NMPC: the goldens of the
reference's tests/test_parity.py, tests/test_parity_sweep.py and
tests/test_runtime.py:95 that tests/test_torch_parity.py does not hold,
each with the reference test's own bounds. Tier-1 runs a prefix of each
closed loop (every bound whose window the prefix reaches); RUN_SLOW runs
the reference's lengths:
- LMPC pointwise: LMPC_N20 and LMPC_N40 (every 10th golden state here, all
  1000 behind RUN_SLOW); the LMPC_N50 closed-loop envelope;
- the LBMPC horizon sweep N40/60/80;
- the casadi family: DMS_LBMPC_q10 at N=50, the DSS LMPC at N=100 (against
  DSS_tLMPC and tLMPC), the DMS flagship at N=100 with q = 100, 50, 10, the
  large windows q = 200, 500 (their filling identity with q=100), the q=500
  window pre-trained from train_data, and the casadi_k split (its golden,
  and its equality with the direct parametrization);
- LBMPC with a fixed pre-trained oracle;
- the noise floor's transient contraction (tests/test_parity_sweep.py:354),
  behind RUN_SLOW."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.oracle import window_from_arrays
from lbmpc_tpu_torch.runtime.scenario import build_scenario

RUN_SLOW = bool(os.environ.get("RUN_SLOW"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sc(cfg):
    return build_scenario(cfg, device="cpu")


def _n(cfg, N):
    return dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N))


def _pointwise(golden, name):
    sc = _sc(lt.make_preset(name))
    g = golden(name)["sysH"]                       # (5, 1001): [dx_k; du_{k-1}]
    idx = np.arange(g.shape[1] - 1) if RUN_SLOW else np.arange(0, g.shape[1] - 1, 10)
    dxs = torch.tensor(g[:4, idx].T)
    z, conv = sc.solve(dxs, None, None)
    Ks = torch.tensor(np.atleast_2d(sc.ocp.Ks))
    du = ((dxs @ Ks.T)[:, 0] + z[:, 0]).numpy()
    return np.abs(du - g[4, idx + 1]), conv


def test_lmpc_n20_pointwise_parity(golden):
    """tests/test_parity.py:59: median < 1e-6, at most 2 states above 1e-4
    (a lone fmincon-noise outlier), max < 2e-3."""
    err, conv = _pointwise(golden, "LMPC_N20")
    assert bool(conv.all())
    assert np.median(err) < 1e-6, np.median(err)
    assert (err > 1e-4).sum() <= 2
    assert err.max() < 2e-3, err.max()


def test_lmpc_n40_pointwise_control_parity(golden):
    """tests/test_parity_sweep.py:77: median < 2e-6, max < 5e-4, fewer than
    10 states above 1e-4."""
    err, conv = _pointwise(golden, "LMPC_N40")
    assert bool(conv.all())
    assert np.median(err) < 2e-6, np.median(err)
    assert err.max() < 5e-4, err.max()
    assert (err > 1e-4).sum() < 10


def test_lmpc_closed_loop_envelope(golden):
    """tests/test_parity.py:212: tight before the active-set transient
    (< 3e-3 over 80 steps), mass flow and pressure rise within 2e-2."""
    steps = 1000 if RUN_SLOW else 100
    res = _sc(lt.make_preset("LMPC_N50", iterations=steps)).run()
    assert bool(res.solver_converged.all())
    err = np.abs(res.sys_history.numpy().T - golden("LMPC_N50")["sysH"][:, : steps + 1])
    assert err[:, :80].max() < 3e-3, err[:, :80].max()
    assert err[0].max() < 2e-2 and err[1].max() < 2e-2, err[:2].max(axis=1)


@pytest.mark.parametrize("N", [40, 60, 80])
def test_lbmpc_horizon_sweep_closed_loop_parity(golden, N):
    """tests/test_parity_sweep.py:34, float64, learning on: slow states
    < 5e-4, x3 < 1e-2, x4 < 2.5, input < 0.5, everything < 2e-2 before step
    55 and < 1e-3 after 150; theta < 2e-5 before 55, < 5e-3 overall, < 2e-4
    after 150."""
    steps = 1000 if RUN_SLOW else 8
    res = _sc(lt.make_preset(f"LBMPC_N{N}", iterations=steps)).run()
    assert bool(res.solver_converged.all())
    gold = golden(f"LBMPC_N{N}")
    err = np.abs(res.sys_history.numpy().T - gold["sysH"][:, : steps + 1])
    assert err[:2].max() < 5e-4 and err[2].max() < 1e-2, err.max(axis=1)
    assert err[3].max() < 2.5 and err[4].max() < 0.5, err.max(axis=1)
    assert err[:, :55].max() < 2e-2
    aerr = np.abs(res.art_history.numpy()[:, 0] - gold["art_refH"][1: steps + 1])
    assert aerr[:55].max() < 2e-5 and aerr.max() < 5e-3, aerr.max()
    if steps > 150:
        assert err[:, 150:].max() < 1e-3 and aerr[150:].max() < 2e-4


def _abs_states(res, cfg, lo, hi):
    return res.sys_history.numpy()[lo:hi, :4] + np.asarray(cfg.plant.x_wp)


def test_dms_lbmpc_q10_window_sweep_parity(golden):
    """tests/test_parity.py:154: DMS_LBMPC_q10 at N=50, per state 1e-4, 2e-4
    and x4 5e-2 (400 steps there)."""
    steps = 400 if RUN_SLOW else 10
    cfg = _n(lt.make_preset("DMS_LBMPC_q10", iterations=steps), 50)
    res = _sc(cfg).run()
    assert bool(res.solver_converged.all())
    err = np.abs(_abs_states(res, cfg, 1, steps + 1).T
                 - golden("DMS_N50_tLBMPC_q10")[:, 1: steps + 1])
    assert err[0].max() < 1e-4 and err[1].max() < 2e-4 and err[3].max() < 5e-2, err.max(axis=1)


@functools.lru_cache(maxsize=None)
def _dss_lmpc(steps):
    cfg = _n(lt.make_preset("DMS_LMPC", iterations=steps), 100)
    return _sc(cfg).run(), cfg


@pytest.mark.parametrize("gold,length", [("DSS_tLMPC", 200), ("tLMPC", 600)])
def test_dss_lmpc_n100_closed_loop_parity(golden, gold, length):
    """tests/test_parity.py:193 (200 steps against DSS_tLMPC) and
    tests/test_parity_sweep.py:235 (600 against tLMPC): per state 1e-4,
    2e-4, 1e-2; tLMPC also 1e-3 after step 250. One episode for both."""
    res, cfg = _dss_lmpc(600 if RUN_SLOW else 40)
    steps = min(cfg.iterations, length)
    assert bool(res.solver_converged[:steps].all())
    err = np.abs(_abs_states(res, cfg, 0, steps).T - golden(gold)[:, :steps])
    assert err[0].max() < 1e-4 and err[1].max() < 2e-4 and err[2].max() < 1e-2, err.max(axis=1)
    if gold == "tLMPC" and steps > 250:
        assert err[:, 250:].max() < 1e-3


@functools.lru_cache(maxsize=None)
def _flagship(q, steps):
    cfg = lt.make_preset(f"DMS_LBMPC_q{q}", iterations=steps)
    assert cfg.ocp.N == 100      # the preset's own horizon
    return _sc(cfg).run(), cfg


FLAG_STEPS = 500 if RUN_SLOW else 6


@pytest.mark.parametrize("q,gold,bounds", [
    (100, "DMS_tLBMPC_q100", (1e-4, 2e-4, 1e-3, 5e-2)),
    (50, "DMS_tLBMPC_q50", (1e-4, 2e-4, 1e-2, 5e-2)),
    (10, "DMS_tLBMPC_q10", (1e-4, 2e-4, 1e-3, 5e-2))])
def test_dms_lbmpc_n100_closed_loop_parity(golden, q, gold, bounds):
    """The DMS flagship at its N=100 (tests/test_parity_sweep.py:112, 500
    steps against DMS_tLBMPC_q100) and its window sweep q=50 and q=10
    (:144, :167; 150 steps there, 500 behind RUN_SLOW; those goldens
    duplicate the initial column)."""
    res, cfg = _flagship(q, FLAG_STEPS)
    assert bool(res.solver_converged.all())
    g = golden(gold)
    off = 1 if g.shape[1] == 501 else 0
    steps = FLAG_STEPS
    err = np.abs(_abs_states(res, cfg, 1, steps + 1).T - g[:, off: off + steps]).max(axis=1)
    assert all(e < b for e, b in zip(err, bounds)), err


@pytest.mark.parametrize("q", [200, 500])
def test_dms_lbmpc_q_large_window_filling_identity(golden, q):
    """tests/test_parity_sweep.py:196: while the window is still filling
    (the first 100 steps) a q=200/500 run equals the q=100 run (< 1e-5), and
    from step 80 on it sits in the golden's ~1e-2 class (< 3e-2)."""
    steps = 150 if RUN_SLOW else FLAG_STEPS
    res, cfg = _flagship(q, steps)
    assert bool(res.solver_converged.all())
    ours = _abs_states(res, cfg, 1, steps + 1)
    fill = min(steps, 100)
    res100, _ = _flagship(100, fill if RUN_SLOW else FLAG_STEPS)
    ours100 = _abs_states(res100, cfg, 1, fill + 1)
    assert np.abs(ours[:fill] - ours100).max() < 1e-5
    g = golden(f"DMS_tLBMPC_q{q}")
    off = 1 if g.shape[1] == 501 else 0
    if steps > 80:
        err = np.abs(ours.T - g[:, off: off + steps])
        assert err[:, 80:].max() < 3e-2


def test_dms_lbmpc_q500_pretrained_closed_loop_parity(golden):
    """tests/test_parity_sweep.py:279: the q=500 window pre-loaded from
    train_data (7 x 500) by window_from_arrays, online updates continuing:
    over the first 150 steps per state 1e-4, 1e-4, 1e-3; x4 < 1e-1 and the
    slow states < 5e-3 over the run."""
    steps = 500 if RUN_SLOW else 6
    cfg = lt.make_preset("DMS_LBMPC_q500", iterations=steps)
    td = golden("train_data")
    w0 = window_from_arrays(td[:3], td[3:7], q=500, device="cpu")
    dx0 = np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp)
    res = _sc(cfg).episode_with_window(dx0, w0)
    assert bool(res.solver_converged.all())
    assert int(res.final_window.count) == 500 + steps
    err = np.abs(_abs_states(res, cfg, 1, steps + 1).T
                 - golden("DMS_tLBMPC_q500_pretrained")[:, 1: 1 + steps])
    assert err[0, :150].max() < 1e-4 and err[1, :150].max() < 1e-4, err.max(axis=1)
    assert err[2, :150].max() < 1e-3 and err[3].max() < 1e-1 and err[:3].max() < 5e-3


def test_dms_lmpc_k_explicit_split_closed_loop_parity(golden):
    """tests/test_parity_sweep.py:313: DMS_LMPC_K against DMS_tLMPC_K, per
    state 1e-4, 2e-4, 5e-3, the x4 transient < 2.0, and < 5e-3 after step
    150 (200 steps there)."""
    steps = 500 if RUN_SLOW else 40
    cfg = lt.make_preset("DMS_LMPC_K", iterations=steps)
    res = _sc(cfg).run()
    assert bool(res.solver_converged.all())
    err = np.abs(_abs_states(res, cfg, 0, steps).T - golden("DMS_tLMPC_K")[:, :steps])
    assert err[0].max() < 1e-4 and err[1].max() < 2e-4 and err[2].max() < 5e-3, err.max(axis=1)
    assert err[3].max() < 2.0
    if steps > 150:
        assert err[:, 150:].max() < 5e-3


@pytest.mark.parametrize("dx", [(-0.35, -0.4, 0.0, 0.0), (0.1, -0.05, 0.02, 1.0)])
def test_dms_lmpc_k_split_equals_direct_parametrization(dx):
    """tests/test_parity_sweep.py:333: eliminating u = Ks x + c gives the
    same OCP as the direct du parametrization; the applied inputs agree
    within 1e-7."""
    sc_k = _sc(lt.make_preset("DMS_LMPC_K"))
    sc_d = _sc(_n(lt.make_preset("DMS_LMPC"), 100))
    dxt = torch.tensor([dx], dtype=torch.float64)
    z_k, conv_k = sc_k.solve(dxt, None, torch.zeros(1, sc_k.nz, dtype=torch.float64))
    z_d, conv_d = sc_d.solve(dxt, None, torch.zeros(1, sc_d.nz, dtype=torch.float64))
    assert bool(conv_k.all()) and bool(conv_d.all())
    Ks = torch.tensor(np.atleast_2d(sc_k.ocp.Ks))
    du_k = (dxt @ Ks.T)[0, 0] + z_k[0, 0]
    assert abs(float(du_k - z_d[0, 0])) < 1e-7


def test_fixed_oracle_no_online_updates(golden):
    """tests/test_runtime.py:95: LBMPC with a fixed pre-trained oracle (the
    window from train_data, q=64, learn_online off): the window stays as it
    was through the episode."""
    cfg = lt.make_preset("LBMPC_N40", iterations=3)
    cfg = dataclasses.replace(
        cfg, learn_online=False, ocp=dataclasses.replace(cfg.ocp, N=8),
        solver=dataclasses.replace(cfg.solver, sqp_iters=1, ipm_iters=10),
        oracle=dataclasses.replace(cfg.oracle, q=64))
    data = golden("train_data")
    w = window_from_arrays(data[:3], data[3:7], q=64, device="cpu")
    res = _sc(cfg).episode_with_window(np.asarray(cfg.dx_init), w)
    assert bool(res.solver_converged.all())
    assert int(res.final_window.count) == 64
    assert torch.equal(res.final_window.Y, w.Y) and torch.equal(res.final_window.X, w.X)


@pytest.mark.skipif(not RUN_SLOW, reason="two 200-step float64 LBMPC_N40 episodes: "
                    "~2 minutes on the CPU")
def test_noise_floor_transient_contraction():
    """The reference's test_noise_floor_transient_contraction
    (tests/test_parity_sweep.py:354-369; its docs/NOISE_FLOOR.md claim):
    LBMPC_N40 for 200 float64 steps at sqp_iters 4 and at 5. Both converge
    every step; the closed loops agree within 1e-6 before step 55 (the
    active-set transient) and within 1e-3 from step 150 on (the loop
    contracts back). CPU time: ~100 s for the two episodes."""
    runs = []
    for sqp_iters in (4, 5):
        cfg = lt.make_preset("LBMPC_N40", iterations=200)
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                   sqp_iters=sqp_iters))
        res = _sc(cfg).run()
        assert bool(res.solver_converged.all())
        runs.append(res.sys_history.numpy().T)
    spread = np.abs(runs[1] - runs[0])
    assert spread[:, :55].max() < 1e-6
    assert spread[:, 150:].max() < 1e-3
