"""PyTorch port, the fleet episode (plain versions on the CPU): the
warm-chain hybrid on the kernel route and the xla-route hybrid against the
reference's float64 vmapped episode — the gate of
tests/test_runtime.py:466-510 (trajectory diff < 1e-3, conv 1.0) — and the
default-argument fleet (the xla route) against the reference's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.oracle import init_window
from lbmpc_tpu_torch.runtime import scenario as t_scenario
from lbmpc_tpu_torch.runtime.closed_loop import run_closed_loop_batched

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.runtime.scenario import build_scenario


def _small(preset):
    cfg = preset("LBMPC_N40", iterations=4)
    return dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
        solver=dataclasses.replace(cfg.solver, dtype="float32", sqp_iters=2,
                                   ipm_iters=16),
        oracle=dataclasses.replace(cfg.oracle, q=8))


DX0 = (np.array([-0.35, -0.4, 0.0, 0.0])
       + np.random.default_rng(0).uniform(-0.02, 0.02, (8, 4)))


@pytest.fixture(scope="module")
def reference():
    cfg = _small(make_preset)
    ref_cfg = dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, dtype="float64", sqp_iters=3,
                                        ipm_iters=25))
    return jax.vmap(build_scenario(ref_cfg).episode)(jnp.asarray(DX0))


@pytest.mark.parametrize("warm_chain", [True, False])
def test_fleet_episode_matches_reference(reference, warm_chain):
    sc, run = t_scenario.build_fleet_episode(
        _small(lt.make_preset), backend="hybrid", ipm_iters=(8, 2), qp_warm=True,
        warm_chain=warm_chain, qp_kernel="pallas_full", device="cpu")
    res = run(DX0)
    assert res.sys_history.shape == (8, 5, 5) and res.solver_converged.shape == (8, 4)
    assert float(res.solver_converged.float().mean()) == 1.0
    diff = np.abs(res.sys_history.numpy() - np.asarray(reference.sys_history)).max()
    assert diff < 1e-3, diff
    art = np.abs(res.art_history.numpy() - np.asarray(reference.art_history)).max()
    assert art < 1e-3, art
    assert int(res.final_window.count[0]) == 1 + 4


def test_warm_chain_seeds_step_zero_cold():
    """The chain's first step (qp_init_state = a cold start) equals the
    unchained step. Not bit for bit: the seed state is built from dx_init,
    the step's solve from (x_wp + dx_init) - x_wp, as in the reference."""
    cfg = dataclasses.replace(_small(lt.make_preset), iterations=1)
    runs = [t_scenario.build_fleet_episode(cfg, backend="fused", ipm_iters=(8, 2),
                                           qp_warm=True, warm_chain=c,
                                           qp_kernel="pallas_full", device="cpu")[1]
            for c in (True, False)]
    a, b = (r(DX0) for r in runs)
    assert (a.sys_history - b.sys_history).abs().max() < 1e-5


def test_closed_loop_without_learning_keeps_the_window():
    sc, run = t_scenario.build_fleet_episode(_small(lt.make_preset), device="cpu")
    solver = run.solver
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    win = init_window(8, batch=(8,), dtype=torch.float32, device="cpu")
    res = run_closed_loop_batched(
        solver.raw, lambda x, u: x, lambda z, *_: z, f(np.atleast_2d(sc.ocp.Ks)),
        f(sc.A), f(sc.B), f(sc.ocp.LAMBDA), f(sc.cfg.plant.x_wp), f([sc.cfg.plant.u_wp]),
        f(DX0), torch.zeros(8, sc.nz), win, 2, learn=False, log_post_state=True)
    assert res.final_window is win
    # the plant here is the identity: the logged post-step state is dx
    np.testing.assert_allclose(res.sys_history[:, 1, :4].numpy(), DX0, rtol=0, atol=1e-6)


def test_xla_route_hybrid_fleet_matches_reference(reference):
    """The xla route's hybrid fleet as the reference builds it: the per-step
    repair on the vmapped backend (the per-problem float32 SQP, 1 GN x 8
    IPM, seeded at the fused iterate)."""
    sc, run = t_scenario.build_fleet_episode(
        _small(lt.make_preset), backend="hybrid", ipm_iters=(16, 8), device="cpu")
    assert run.solver.fused.qp_kernel == "xla"
    assert (run.solver.repair_backend, run.solver.repair_warm) == ("vmapped", "fused")
    res = run(DX0)
    assert float(res.solver_converged.float().mean()) == 1.0
    diff = np.abs(res.sys_history.numpy() - np.asarray(reference.sys_history)).max()
    assert diff < 1e-3, diff


def test_default_fleet_matches_reference_default_fleet(monkeypatch):
    """build_fleet_episode(cfg) with default arguments takes the reference's
    route, ladder and repair: the xla route, the solver's five-step Armijo
    ladder, no qp_warm. Reference side on its XLA Cholesky (no Pallas)."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.runtime.scenario import build_fleet_episode

    _, ref_run = build_fleet_episode(_small(make_preset))
    ref = ref_run(jnp.asarray(DX0, jnp.float32))
    monkeypatch.delenv("LBMPC_CHOL")
    _, run = t_scenario.build_fleet_episode(_small(lt.make_preset), device="cpu")
    s = run.solver
    assert (s.qp_kernel, s.alphas, s.qp_warm) == ("xla", (1.0, 0.5, 0.25, 0.125, 0.0625),
                                                  False)
    res = run(DX0)
    np.testing.assert_array_equal(res.solver_converged.numpy(),
                                  np.asarray(ref.solver_converged))
    # two float32 implementations of one route: the one-solve class
    # (median < 1e-6) carried through the plant, within the fleet gate
    d = np.abs(res.sys_history.numpy() - np.asarray(ref.sys_history))
    assert np.median(d) < 1e-6 and d.max() < 1e-3, (np.median(d), d.max())


def test_mono_fleet_matches_reference_xla_fleet(monkeypatch):
    """The pallas_mono fleet (K3's plain version) against the reference's
    fleet on its XLA route with the same ladder and IPM schedule (its XLA
    Cholesky, no Pallas): the same converged steps, the one-solve class in
    the history."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.runtime.scenario import build_fleet_episode

    ladder = ((1.0,), (1.0, 0.5, 0.25))
    _, ref_run = build_fleet_episode(_small(make_preset), alphas=ladder)
    ref = ref_run(jnp.asarray(DX0, jnp.float32))
    monkeypatch.delenv("LBMPC_CHOL")
    _, run = t_scenario.build_fleet_episode(_small(lt.make_preset), qp_kernel="pallas_mono",
                                            device="cpu")
    s = run.solver
    assert (s.qp_kernel, s.alphas, s.ipm_sched) == ("pallas_mono", ladder, (16, 16))
    res = run(DX0)
    assert float(res.solver_converged.float().mean()) == 1.0
    np.testing.assert_array_equal(res.solver_converged.numpy(),
                                  np.asarray(ref.solver_converged))
    d = np.abs(res.sys_history.numpy() - np.asarray(ref.sys_history))
    assert np.median(d) < 1e-6 and d.max() < 1e-3, (np.median(d), d.max())


def test_fleet_rejects_what_is_not_ported():
    """What stays unported or unsupported raises: the warm chain without
    qp_warm or off the kernel route, the casadi family's and the NMPC's fleet
    episode, and the stage-wise backend the reference refuses for LBMPC
    (sparse_parallel). The NMPC presets' setup is ported
    (tests/test_torch_nmpc.py), and so are the sparse backends
    (tests/test_torch_sparse_ipm.py, tests/test_torch_sparse_gn.py). The
    fleet's signature is the reference's: no repair_backend keyword (the
    route picks the repair)."""
    cfg = _small(lt.make_preset)
    with pytest.raises(TypeError, match="repair_backend"):
        t_scenario.build_fleet_episode(cfg, backend="hybrid", repair_backend="fused",
                                       device="cpu")
    with pytest.raises(ValueError, match="qp_warm"):
        t_scenario.build_fleet_episode(cfg, warm_chain=True, device="cpu")
    with pytest.raises(ValueError, match="kernel route"):
        t_scenario.build_fleet_episode(cfg, warm_chain=True, qp_warm=True, device="cpu")
    with pytest.raises(ValueError, match="fmincon"):
        t_scenario.build_fleet_episode(lt.make_preset("DMS_LBMPC_q100"), device="cpu")
    with pytest.raises(ValueError, match="fmincon-family LBMPC"):
        t_scenario.build_fleet_episode(lt.make_preset("NMPC_N20"), device="cpu")
    assert t_scenario.build_scenario(lt.make_preset("NMPC_N20")).nz == 21
    sparse = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                 qp_backend="sparse_parallel"))
    with pytest.raises(ValueError, match="sparse_parallel"):
        t_scenario.build_scenario(sparse, device="cpu")
