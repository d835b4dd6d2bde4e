"""PyTorch port, the regulation presets, the ellipsoidal terminal region and
the collocation transcription: the reference's behavioural tests
(tests/test_regulation.py) on the port, and short port-against-reference
episodes of REG_NMPC and REG_LMPC.
- REG_NMPC (150 steps) and REG_LMPC (250 steps) at the reference's lengths
  with its assertions behind RUN_SLOW; in tier-1 each preset cut to N=30
  over 5 steps against the reference's episode (<= 1e-7);
- the elastic ellipsoid row: enforced from near the equilibrium, finite
  and in the unconstrained optimum's terminal class from the far
  transient (N=30, as the reference's tests);
- collocation NMPC against RK4 NMPC at NMPC_N20 (< 1e-6): 10 steps here,
  the reference's 30 behind RUN_SLOW."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.config import REG_P
from lbmpc_tpu_torch.models.mgcm import rk4_step
from lbmpc_tpu_torch.runtime.scenario import build_scenario

from lbmpc_tpu.config import make_preset as j_preset
from lbmpc_tpu.runtime.scenario import build_scenario as j_build

RUN_SLOW = bool(os.environ.get("RUN_SLOW"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(cfg, N=None, alpha=None):
    ocp = cfg.ocp
    if N is not None:
        ocp = dataclasses.replace(ocp, N=N)
    if alpha is not None:
        ocp = dataclasses.replace(ocp, ellipsoid_alpha=alpha)
    return dataclasses.replace(cfg, ocp=ocp)


@pytest.mark.skipif(not RUN_SLOW, reason="150 N=100 NMPC steps: minutes on the CPU")
def test_reg_nmpc_episode_converges_to_equilibrium():
    """REG_NMPC (N=100, true-ODE prediction): the closed loop regulates the
    nonlinear plant toward x_eq with every SQP step converged."""
    res = build_scenario(lt.make_preset("REG_NMPC", iterations=150), device="cpu").run()
    assert bool(res.solver_converged.all())
    h = res.sys_history.numpy()
    assert np.abs(res.art_history.numpy()).max() < 1e-12      # theta pinned
    assert abs(h[-1, 0]) < 0.75 * abs(h[0, 0])                 # reference: 0.253 from 0.35
    assert h[:, 1].min() > -0.5 - 1e-6


@pytest.mark.skipif(not RUN_SLOW, reason="250 N=100 regulation-LMPC steps: a minute on the CPU")
def test_reg_lmpc_episode_converges_to_equilibrium():
    """REG_LMPC (nominal-DLTI prediction): regulation drives the plant toward
    the equilibrium."""
    res = build_scenario(lt.make_preset("REG_LMPC", iterations=250), device="cpu").run()
    assert bool(res.solver_converged.all())
    h = res.sys_history.numpy()
    assert abs(h[-1, 0]) < 0.25 * abs(h[0, 0])                 # reference: 0.194 at 250 steps
    assert np.abs(res.art_history.numpy()).max() < 1e-12


@pytest.mark.parametrize("name", ["REG_NMPC", "REG_LMPC"])
def test_regulation_episode_matches_reference(name):
    """The preset cut to N=30 over 5 steps from its own x_init (casadi
    family: the rk4 plant, the DMS warm start, theta pinned)."""
    steps = 5
    ref = j_build(_cut(j_preset(name, iterations=steps), N=30)).run()
    res = build_scenario(_cut(lt.make_preset(name, iterations=steps), N=30), device="cpu").run()
    assert bool(res.solver_converged.all()) and bool(np.asarray(ref.solver_converged).all())
    np.testing.assert_allclose(res.sys_history.numpy(), np.asarray(ref.sys_history), rtol=0,
                               atol=1e-7)
    assert np.abs(res.art_history.numpy()).max() < 1e-12
    np.testing.assert_array_equal(res.art_history.numpy(), np.asarray(ref.art_history))


def _terminal_v(cfg, dx0):
    """Roll the solution's inputs through the prediction model (RK4, 4
    substeps) to the terminal state: dx_N' P dx_N."""
    sc = build_scenario(cfg, device="cpu")
    z, conv = sc.solve(torch.tensor([dx0], dtype=torch.float64), None,
                       torch.zeros(1, sc.nz, dtype=torch.float64))
    assert bool(torch.isfinite(z).all())
    x_wp = torch.tensor(cfg.plant.x_wp, dtype=torch.float64)
    x = (x_wp + torch.tensor(dx0, dtype=torch.float64))[None]
    for c in z[0, : cfg.ocp.N]:
        x = rk4_step(x, c + cfg.plant.u_wp, cfg.plant.ts, substeps=4)
    d = (x[0] - x_wp).numpy()
    return float(d @ np.asarray(REG_P) @ d), bool(conv[0])


def test_ellipsoid_terminal_region_enforced_when_reachable():
    """Starting near the equilibrium, the elastic ellipsoid row is feasible
    and the predicted terminal state satisfies x'Px <= alpha (ref:
    terminalconstraints, regular_NMPC_casadi.m:231-233)."""
    v, conv = _terminal_v(_cut(lt.make_preset("REG_NMPC"), N=30, alpha=0.7),
                          [-0.02, -0.016, 0.0, 0.0])
    assert conv
    assert v <= 0.7 * (1.0 + 1e-3), v


def test_ellipsoid_elastic_degrades_gracefully_when_unreachable():
    """From the far transient the hard region is infeasible; the elastic row
    keeps the solver finite and in the same terminal class as the
    unconstrained optimum."""
    base = _cut(lt.make_preset("REG_NMPC"), N=30)
    dx0 = [-0.35, -0.4, 0.0, 0.0]
    v_free, _ = _terminal_v(base, dx0)
    v_ell, _ = _terminal_v(_cut(base, alpha=0.7), dx0)
    assert v_free > 0.7, v_free       # the premise: the unconstrained optimum is outside
    assert v_ell < 2.0 * v_free, (v_ell, v_free)


def test_collocation_nmpc_matches_rk4_nmpc():
    """Collocation-transcription NMPC reproduces the RK4-transcription NMPC
    closed loop (both integrators are accurate on the non-stiff sampling
    interval; ref: collocation_regular_NMPC_test.m)."""
    steps = 30 if RUN_SLOW else 10
    base = lt.make_preset("NMPC_N20", iterations=steps)
    res_rk4 = build_scenario(base, device="cpu").run()
    coll = dataclasses.replace(base, solver=dataclasses.replace(
        base.solver, nmpc_prediction="collocation"))
    res_col = build_scenario(coll, device="cpu").run()
    assert bool(res_col.solver_converged.all())
    d = np.abs(res_col.sys_history.numpy() - res_rk4.sys_history.numpy())
    assert d.max() < 1e-6, d.max()
