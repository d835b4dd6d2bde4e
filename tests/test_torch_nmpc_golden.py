"""PyTorch port, the NMPC family against the reference MATLAB runs' golden
trajectories (tests/golden), with the bounds of the reference's tests:
- NMPC_N50 (tests/test_parity.py:96: slow states < 1e-4, throttle rate
  < 5e-3, input < 1e-3, theta < 5e-4) and NMPC_N40
  (tests/test_parity_sweep.py:98), the fmincon family on the rk23 plant:
  15 steps here, 200 behind RUN_SLOW (the reference's tier-1 length is 60);
- the casadi NMPC at N=100 against DSS_tNMPC (test_parity.py:172: 120
  steps, per state 1e-5, 1e-5, 1e-4, 1e-2) and against tNMPC
  (test_parity_sweep.py:256: 150 steps, 599 behind RUN_SLOW), one episode
  for both: 12 steps here, 599 behind RUN_SLOW."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.runtime.scenario import build_scenario

RUN_SLOW = bool(os.environ.get("RUN_SLOW"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("N", [50, 40])
def test_nmpc_fmincon_closed_loop_parity(golden, N):
    steps = 200 if RUN_SLOW else 15
    res = build_scenario(lt.make_preset(f"NMPC_N{N}", iterations=steps), device="cpu").run()
    assert bool(res.solver_converged.all())
    assert res.sys_history.dtype == torch.float64
    gold = golden(f"NMPC_N{N}")
    err = np.abs(res.sys_history.numpy().T - gold["sysH"][:, : steps + 1])
    assert err[:3].max() < 1e-4, err[:3].max()    # slow states
    assert err[3].max() < 5e-3, err[3].max()      # throttle rate
    assert err[4].max() < 1e-3, err[4].max()      # input
    if N == 50:
        aerr = np.abs(res.art_history.numpy()[:, 0] - gold["art_refH"][1: steps + 1])
        assert aerr.max() < 5e-4, aerr.max()


@functools.lru_cache(maxsize=None)
def _casadi_nmpc(steps):
    cfg = lt.make_preset("NMPC_N50", iterations=steps)
    cfg = dataclasses.replace(cfg, family="casadi", ocp=dataclasses.replace(cfg.ocp, N=100))
    res = build_scenario(cfg, device="cpu").run()
    return res, np.asarray(cfg.plant.x_wp)


CASADI_STEPS = 599 if RUN_SLOW else 12


@pytest.mark.parametrize("gold,length", [("DSS_tNMPC", 120), ("tNMPC", 599)])
def test_nmpc_casadi_n100_closed_loop_parity(golden, gold, length):
    """The casadi family (z = du, RK4 plant with one substep, the DMS warm
    start) at N=100; the reference's per-state bounds of both tests."""
    res, x_wp = _casadi_nmpc(CASADI_STEPS)
    steps = min(CASADI_STEPS, length)
    assert bool(res.solver_converged[:steps].all())
    ours = res.sys_history.numpy()[1: steps + 1, :4] + x_wp
    err = np.abs(ours.T - golden(gold)[:, 1: steps + 1]).max(axis=1)
    assert err[0] < 1e-5 and err[1] < 1e-5 and err[2] < 1e-4 and err[3] < 1e-2, err
