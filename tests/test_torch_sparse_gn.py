"""PyTorch port, ops/sparse_gn and controllers/lbmpc.make_lbmpc_solver_sparse:
the stage-form LBMPC GN subproblem against the JAX package, the sparse
LBMPC episodes against the port's condensed ones, and the build-time
refusals of the stage-wise backends.

The JAX side runs jitted on the CPU in float64 (tests/conftest.py). The
reference's 60- and 40-step episodes run with RUN_SLOW=1.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers.lbmpc import LBMPCWeights
from lbmpc_tpu.oracle import init_window, make_xi, nw_estimate_and_jac
from lbmpc_tpu.ops import sparse_gn as j_gn
from lbmpc_tpu.runtime.scenario import build_scenario as j_build_scenario
from lbmpc_tpu_torch import interop
from lbmpc_tpu_torch.controllers.lbmpc import make_lbmpc_solver_sparse
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops import sparse_gn as t_gn
from lbmpc_tpu_torch.runtime import scenario as t_scenario
from lbmpc_tpu_torch.runtime.scenario import build_scenario

SLOW = bool(os.environ.get("RUN_SLOW"))
DX0 = np.array([-0.35, -0.4, 0.0, 0.0])


def _rand_window(rng, q=100):
    win = init_window(q)
    return type(win)(
        X=jnp.asarray(0.1 * rng.standard_normal((q, 3))),
        Y=jnp.asarray(0.001 * rng.standard_normal((q, 4))),
        valid=jnp.ones(q), count=jnp.asarray(q, jnp.int32))


def _gn_case(family, terminal_at, tighten, N=12, zscale=0.01, seed=0):
    """One GN subproblem as tests/test_sparse_gn.py builds it: the reference
    stage data and its linearization around a perturbed iterate, in JAX."""
    name = "LBMPC_N40" if family == "fmincon" else "DMS_LBMPC_q100"
    cfg = make_preset(name)
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(
        cfg.ocp, N=N, terminal_at=terminal_at, tighten_first_step=tighten))
    sc = j_build_scenario(cfg)
    w = LBMPCWeights.make(sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T, sc.ocp.LAMBDA, sc.ocp.PSI)
    rng = np.random.default_rng(seed)
    win = _rand_window(rng)
    Ks = np.atleast_2d(sc.ocp.Ks) if family == "fmincon" else np.zeros((1, 4))
    sg = j_gn.make_stage_gn(sc.A, sc.B, Ks, np.asarray(w.Lq).T @ np.asarray(w.Lq),
                            np.asarray(w.Lr).T @ np.asarray(w.Lr),
                            np.asarray(w.Lp).T @ np.asarray(w.Lp),
                            float(w.sqrtT) ** 2, w.LAMBDA, w.PSI, sc.cs, N, cfg.plant.ts,
                            family=family, terminal_at=terminal_at,
                            tighten_first_step=tighten)
    dx0 = jnp.asarray(DX0)
    z_bar = jnp.asarray(zscale * rng.standard_normal(N + 1))
    Ad, Bd, Ksd = jnp.asarray(sc.A), jnp.asarray(sc.B), jnp.asarray(Ks)
    An = Ad + Bd @ Ksd
    LAM, PSI = jnp.asarray(w.LAMBDA), jnp.asarray(w.PSI)
    Exl = jnp.concatenate([jnp.eye(2, 4), Ksd], axis=0)
    cvals, theta = z_bar[:N].reshape(N, 1), z_bar[N:]

    @jax.jit
    def linearize(cvals, theta):
        def lstep(xl, c):
            u = Ksd @ xl + c
            gv, Jg = nw_estimate_and_jac(make_xi(xl, u), win, 0.5, 0.001)
            return Ad @ xl + Bd @ u + gv, (An + Jg @ Exl, Bd + Jg[:, 2:3], xl, u)

        xlN, (Als, Bls, xls, us) = jax.lax.scan(lstep, dx0, cvals)
        _, xns = jax.lax.scan(lambda x, c: (An @ x + Bd @ c,) * 2, dx0, cvals)
        xn_all = jnp.concatenate([dx0[None], xns])
        ex = xls - (LAM @ theta)[None, :]
        eu = us - (PSI @ theta)[None, :]
        eN = xlN - LAM @ theta
        cm = sg.cost_mask[:, None]
        q_xl = jnp.concatenate([cm * (ex @ sg.Qb.T + eu @ (sg.Ks.T @ sg.Rb).T),
                                (sg.Pb @ eN)[None, :]])
        r_c = cm * (eu @ sg.Rb.T)
        g_th = (-LAM.T @ (sg.Qb @ (ex * cm).sum(0)) - PSI.T @ (sg.Rb @ (eu * cm).sum(0))
                - LAM.T @ (sg.Pb @ eN) + sg.TLL @ theta)
        hx_t = sg.h_x[None, :] - xn_all[1:] @ sg.F_x.T
        hu_t = sg.h_u[None, :] - (cvals + xn_all[:N] @ Ksd.T) @ sg.F_u.T
        hd_t = sg.h_d - sg.F_d @ xn_all[1]
        hw_t = sg.h_w - sg.Fw_x @ xn_all[sg.kT] - sg.Fw_th @ theta
        return Als, Bls, q_xl, r_c, g_th, hx_t, hu_t, hd_t, hw_t

    return cfg, sc, w, sg, win, z_bar, linearize(cvals, theta)


def _lanes(args, k=1):
    """The reference's per-problem arrays as the port's (k, ...) lanes."""
    return [torch.as_tensor(np.array(a))[None].repeat((k,) + (1,) * np.ndim(a)) for a in args]


CASES = [("fmincon", "first", True), ("fmincon", "last", False),
         ("casadi", "first", False), ("casadi", "last", True)]


@pytest.mark.parametrize("family,terminal_at,tighten", CASES)
def test_solve_sparse_gn_matches_reference(family, terminal_at, tighten):
    """One GN subproblem at N=12 through both packages on the same
    linearization and stage data (both families, the terminal set on x_kT
    with kT < N and kT = N, with and without the tightened rows): dC, dtheta,
    mu and the flag to 1e-9."""
    _, _, _, sg, _, _, args = _gn_case(family, terminal_at, tighten)
    assert sg.h_d.shape[0] == (0 if not tighten else sg.h_d.shape[0])
    ref = jax.jit(lambda *a: j_gn.solve_sparse_gn(sg, *a, iters=30))(*args)
    got = t_gn.solve_sparse_gn(interop.from_reference(sg, device="cpu"), *_lanes(args),
                               iters=30)
    assert bool(ref.converged) and bool(got.converged[0])
    for f in ("dC", "dth", "mu", "max_violation"):
        np.testing.assert_allclose(getattr(got, f)[0].numpy(), np.asarray(getattr(ref, f)),
                                   rtol=0, atol=1e-9, err_msg=f)


@pytest.mark.parametrize("family", ["fmincon", "casadi"])
def test_linearization_matches_reference(family):
    """The port's linearization (learned rollout with the NW value and its
    closed-form Jacobian, nominal rollout, GN linear terms, group slacks)
    equals the reference test's at the same iterate."""
    terminal_at, tighten = ("first", True)
    cfg, _, _, _, win, z_bar, args = _gn_case(family, terminal_at, tighten)
    tsc = build_scenario(_with(lt.make_preset, cfg.name, N=12, terminal_at=terminal_at,
                               tighten_first_step=tighten), device="cpu")
    Ks = tsc.ocp.Ks if family == "fmincon" else np.zeros((1, 4))
    solve = make_lbmpc_solver_sparse(
        tsc.qp, tsc.A, tsc.B, Ks, tsc.w, tsc.cs, family=family, delta=cfg.plant.ts,
        dx_ref=np.zeros(4), terminal_at=terminal_at, tighten_first_step=tighten,
        device="cpu")
    twin = interop.from_reference(win, device="cpu")
    got = solve.linearize(torch.as_tensor(np.array(z_bar))[None], torch.tensor(DX0)[None],
                          DataWindow(*(a[None] for a in twin)))
    for i, (a, b) in enumerate(zip(got, args)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=1e-12, atol=1e-12,
                                   err_msg=str(i))


def test_solve_sparse_gn_lanes_are_independent():
    """Three lanes with different linearizations (one far from the others)
    equal their solo solves: mu, sigma, the step lengths, the violation and
    the freeze stay inside a lane."""
    cases = [_gn_case("casadi", "first", True, zscale=s, seed=i)
             for i, s in enumerate((0.0, 0.01, 0.2))]
    sg = interop.from_reference(cases[0][3], device="cpu")
    batch_args = [torch.cat(x) for x in zip(*(_lanes(c[-1]) for c in cases))]
    batch = t_gn.solve_sparse_gn(sg, *batch_args, iters=25)
    assert not bool((batch.mu == batch.mu[0]).all())
    for i, c in enumerate(cases):
        solo = t_gn.solve_sparse_gn(sg, *_lanes(c[-1]), iters=25)
        for f in t_gn.SparseGNSolution._fields:
            np.testing.assert_allclose(getattr(batch, f)[i].double().numpy(),
                                       getattr(solo, f)[0].double().numpy(), rtol=0,
                                       atol=1e-12, err_msg=f)


def test_nan_linearization_takes_a_zero_step():
    """A lane whose oracle window holds a NaN gets a NaN linearization, so a
    NaN step: it fails every rung of the merit ladder (which runs on the raw
    step) and steps 0, keeping its warm start, while the other lane solves
    as it does alone."""
    cfg = lt.make_preset("LBMPC_N20")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=10),
                              solver=dataclasses.replace(cfg.solver, qp_backend="sparse",
                                                         sqp_iters=2, ipm_iters=15))
    sc = build_scenario(cfg, device="cpu")
    rng = np.random.default_rng(5)
    X = torch.as_tensor(0.1 * rng.standard_normal((2, 100, 3)))
    Y = torch.as_tensor(0.001 * rng.standard_normal((2, 100, 4)))
    Y[1, 7, 2] = float("nan")
    win = DataWindow(X, Y, torch.ones(2, 100, dtype=torch.float64),
                     torch.full((2,), 100, dtype=torch.int32))
    dx = torch.tensor(np.array([DX0, DX0]))
    z_ws = torch.as_tensor(0.01 * rng.standard_normal((2, sc.nz)))
    z, conv = sc.solve(dx, win, z_ws)
    assert torch.equal(z[1], z_ws[1]) and not bool(conv[1])
    z0, conv0 = sc.solve(dx[:1], DataWindow(*(a[:1] for a in win)), z_ws[:1])
    assert bool(conv0[0]) and torch.isfinite(z0).all()
    np.testing.assert_allclose(z[0].numpy(), z0[0].numpy(), rtol=0, atol=1e-12)
    assert not torch.equal(z0[0], z_ws[0])


def _sparse(cfg, **solver):
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, qp_backend="sparse", **solver))


def test_sparse_lbmpc_episode_matches_condensed():
    """After tests/test_sparse_gn.py:120-131: qp_backend='sparse' closed
    loop == condensed closed loop (fmincon family, LBMPC_N20, the
    constraints active through the transient), 1e-6. 60 steps with
    RUN_SLOW=1, 4 here."""
    cfg = lt.make_preset("LBMPC_N20", iterations=60 if SLOW else 4)
    r_c = build_scenario(cfg, device="cpu").run()
    r_s = build_scenario(_sparse(cfg, ipm_iters=30), device="cpu").run()
    assert bool(r_s.solver_converged.all())
    assert float((r_s.sys_history - r_c.sys_history).abs().max()) < 1e-6


def test_sparse_lbmpc_casadi_family_episode_matches_condensed():
    """The casadi family (the N=100 flagship structure: dual trajectory,
    tightened first step, terminal at x_1) at N=30, 1e-4 as the reference
    holds it (tests/test_sparse_gn.py:134-147). 40 steps with RUN_SLOW=1,
    3 here."""
    cfg = lt.make_preset("DMS_LBMPC_q100", iterations=40 if SLOW else 3)
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=30))
    r_c = build_scenario(cfg, device="cpu").run()
    r_s = build_scenario(_sparse(cfg, ipm_iters=30), device="cpu").run()
    assert bool(r_s.solver_converged.all())
    assert float((r_s.sys_history - r_c.sys_history).abs().max()) < 1e-4


def test_sparse_lbmpc_no_tightened_rows_episode_matches_condensed():
    """md = 0 (tighten_first_step=False): the empty tightened group sets no
    step limit and its violation is -inf, not an error."""
    cfg = lt.make_preset("LBMPC_N20", iterations=30 if SLOW else 3)
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, tighten_first_step=False))
    r_c = build_scenario(cfg, device="cpu").run()
    r_s = build_scenario(_sparse(cfg, ipm_iters=30), device="cpu").run()
    assert bool(r_s.solver_converged.all())
    assert float((r_s.sys_history - r_c.sys_history).abs().max()) < 1e-6


def _with(make, name, **kw):
    cfg = make(name)
    ocp = {k: v for k, v in kw.items() if k in ("N", "terminal_at", "tighten_first_step")}
    solver = {k: v for k, v in kw.items() if k in ("qp_backend", "dtype")}
    return dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, **ocp),
                               solver=dataclasses.replace(cfg.solver, **solver))


@pytest.mark.parametrize("name,kw", [
    ("NMPC_N20", dict(qp_backend="sparse")),
    ("NMPC_N20", dict(qp_backend="sparse_parallel")),
    ("LBMPC_N20", dict(qp_backend="sparse_parallel")),
    ("DMS_LBMPC_q100", dict(qp_backend="sparse", dtype="mixed")),
    ("DMS_LMPC", dict(qp_backend="sparse_parallel", dtype="mixed")),
    ("LMPC_N20", dict(qp_backend="sparse")),
    ("DMS_LMPC", dict(qp_backend="sparse", terminal_at="first")),
    ("DMS_LMPC", dict(qp_backend="sparse", tighten_first_step=True)),
])
def test_build_time_refusals(name, kw):
    """The configurations the reference refuses when it builds the scenario
    (ref: runtime/scenario.py:79-96, :168-176) raise here too, before any
    solver is built; none runs the condensed backend instead."""
    with pytest.raises(ValueError):
        build_scenario(_with(lt.make_preset, name, **kw), device="cpu")
    with pytest.raises(ValueError):
        j_build_scenario(_with(make_preset, name, **kw))


def test_mesh_raises():
    """A mesh that is not a 'stage' mesh raises (the stage-sharded sweeps:
    tests/test_torch_riccati_sharded.py)."""
    _, _, _, sg, _, _, args = _gn_case("casadi", "first", True, N=4)
    with pytest.raises(ValueError, match="'stage' mesh"):
        t_gn.solve_sparse_gn(interop.from_reference(sg, device="cpu"), *_lanes(args),
                             iters=2, mesh=object())


def test_sparse_parallel_run_batch_guard(monkeypatch):
    """run_batch refuses a sparse_parallel batch whose solve would not fit
    the card's memory (here a card of 64 MiB); the LMPC on 'sparse' has no
    such limit."""
    cfg = dataclasses.replace(
        _with(lt.make_preset, "DMS_LMPC", qp_backend="sparse_parallel", N=10), iterations=1)
    sc = build_scenario(cfg, device="cpu")
    assert t_scenario.sparse_parallel_limit(sc, torch.device("cpu"), torch.float64) is None
    monkeypatch.setattr(t_scenario, "_device_memory", lambda dev: 64 << 20)
    limit = t_scenario.sparse_parallel_limit(sc, torch.device("cpu"), torch.float64)
    assert 0 < limit < 64 << 20
    lanes = limit // 10 + 1
    with pytest.raises(ValueError, match="sparse_parallel"):
        sc.run_batch(np.zeros((lanes, 4)))
    sc.run_batch(np.zeros((1, 4)))
