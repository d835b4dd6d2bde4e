"""PyTorch port, the NMPC family against the JAX reference at float64:
controllers/sqp.sqp_solve_nonlinear_constraints on a seeded small NLP (with
and without an elastic row: z <= 1e-8; a ladder that rejects every step
size leaves z as it was), controllers/nmpc.make_nmpc_solver on each
variant (fmincon and casadi with RK4 prediction, fmincon with collocation,
the casadi regulation LMPC with the DLTI prediction and the elastic
ellipsoid row: z <= 1e-7, the same converged flags), the hand tangent pass
against torch.func.jacfwd, and runtime/scenario.build_scenario's NMPC
branch: NMPC_N20 over 10 steps against the reference's episode (<= 1e-7),
run_batch, every NMPC preset and prediction, and the CUDA default."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers import nmpc as t_nmpc
from lbmpc_tpu_torch.controllers.sqp import sqp_solve_nonlinear_constraints as t_sqp
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers.sqp import sqp_solve_nonlinear_constraints as j_sqp
from lbmpc_tpu.runtime.scenario import build_scenario as j_build

NZ, B = 6, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nlp(seed=0):
    """A seeded NLP: 8 linear and 3 nonlinear residual rows, 6 constraint
    rows of which 4 are nonlinear; both packages' callbacks."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((8, NZ))
    tgt = rng.standard_normal((B, 8))
    z0 = 0.1 * rng.standard_normal((B, NZ))

    def j_res(z, t):
        return jnp.concatenate([W @ z - t, 0.5 * jnp.stack([z[0] * z[1], jnp.sin(z[2]), z[3] ** 2])])

    def j_cons(z):
        return jnp.stack([z @ z - 2.0, z[0] ** 2 + z[1] - 0.5, jnp.sin(z[4]) - 0.3, z[5] - 0.2,
                          -z[5] - 1.0, z[0] + z[1] ** 2 + z[2] ** 2 - 0.1])

    Wt, tt = torch.tensor(W), torch.tensor(tgt)

    def t_res(z, t):
        return torch.cat([z @ Wt.T - t, 0.5 * torch.stack(
            [z[:, 0] * z[:, 1], torch.sin(z[:, 2]), z[:, 3] ** 2], 1)], 1)

    def t_cons(z):
        return torch.stack([(z * z).sum(1) - 2.0, z[:, 0] ** 2 + z[:, 1] - 0.5,
                            torch.sin(z[:, 4]) - 0.3, z[:, 5] - 0.2, -z[:, 5] - 1.0,
                            z[:, 0] + z[:, 1] ** 2 + z[:, 2] ** 2 - 0.1], 1)

    rep = lambda zs: tt.repeat(zs.shape[0] // B, 1)
    t_fns = (lambda zs: (t_res(zs, rep(zs)) ** 2).sum(1), lambda z: t_res(z, tt), t_cons)
    return (j_res, j_cons, tgt), t_fns, z0


@functools.lru_cache(maxsize=None)
def _nlp_reference(elastic):
    (j_res, j_cons, tgt), _, z0 = _nlp()

    def one(z, t):
        return j_sqp(lambda zz: jnp.sum(j_res(zz, t) ** 2), lambda zz: j_res(zz, t), j_cons, z,
                     iters=5, ipm_iters=30, elastic_rows=elastic)

    return jax.jit(jax.vmap(one))(jnp.asarray(z0), jnp.asarray(tgt))


def _caller_jac(t_fns):
    """jac_fn for t_sqp from the NLP's callbacks: (e, J, c, Jc), the
    Jacobians by torch.func's reverse mode over the lane sum."""
    _, res, cons = t_fns
    jac = lambda fn, z: torch.func.jacrev(lambda zz: fn(zz).sum(dim=0))(z).transpose(0, 1)
    return lambda z: (res(z), jac(res, z), cons(z), jac(cons, z))


@pytest.mark.parametrize("elastic", [0, 1])
@pytest.mark.parametrize("jacobians", ["forward", "jac_fn"])
def test_sqp_nonlinear_constraints_matches_reference(elastic, jacobians):
    """The SQP's own forward-mode Jacobians, and a caller's jac_fn (the
    NMPC's route)."""
    _, t_fns, z0 = _nlp()
    ref = _nlp_reference(elastic)
    kw = dict(jac_fn=_caller_jac(t_fns)) if jacobians == "jac_fn" else {}
    got = t_sqp(*t_fns, torch.tensor(z0), iters=5, ipm_iters=30, elastic_rows=elastic, **kw)
    np.testing.assert_allclose(got.z.numpy(), np.asarray(ref.z), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.qp_converged.numpy(), np.asarray(ref.qp_converged))
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(ref.cost), rtol=1e-12, atol=0)
    assert got.step_norms.shape == (B, 5)


def test_sqp_nonlinear_constraints_rejected_ladder_keeps_z():
    """Every step size leaves the residual's domain (sqrt of a negative
    number: a NaN merit), so no step is taken, in the port as in the
    reference, unlike sqp_solve's smallest step."""
    z0 = np.zeros((2, 3))

    def j_res(z):
        return jnp.concatenate([z - 100.0, 1e-3 * jnp.sqrt(1.0 - z[:1])])

    j_cons = lambda z: z - 1e3
    ref = jax.jit(jax.vmap(lambda z: j_sqp(lambda zz: jnp.sum(j_res(zz) ** 2), j_res, j_cons, z,
                                           iters=2, ipm_iters=20)))(jnp.asarray(z0))
    t_res = lambda z: torch.cat([z - 100.0, 1e-3 * torch.sqrt(1.0 - z[:, :1])], 1)
    got = t_sqp(lambda zs: (t_res(zs) ** 2).sum(1), t_res, lambda z: z - 1e3, torch.tensor(z0),
                iters=2, ipm_iters=20)
    assert np.array_equal(np.asarray(ref.z), z0)
    assert torch.equal(got.z, torch.tensor(z0))
    assert bool((got.step_norms > 10.0).all())


def _pair(name, N, family=None, prediction=None, alpha=None):
    out = []
    for mk in (make_preset, lt.make_preset):
        c = mk(name)
        ocp = dataclasses.replace(c.ocp, N=N)
        if alpha is not None:
            ocp = dataclasses.replace(ocp, ellipsoid_alpha=alpha)
        c = dataclasses.replace(c, ocp=ocp)
        if family:
            c = dataclasses.replace(c, family=family)
        if prediction:
            c = dataclasses.replace(c, solver=dataclasses.replace(c.solver,
                                                                  nmpc_prediction=prediction))
        out.append(c)
    return out


VARIANTS = {
    "fmincon-rk4": (("NMPC_N20", 10), {}, (-0.35, -0.4, 0.0, 0.0)),
    "casadi-rk4": (("NMPC_N20", 10), {"family": "casadi"}, (-0.35, -0.4, 0.0, 0.0)),
    "fmincon-collocation": (("NMPC_N20", 10), {"prediction": "collocation"},
                            (-0.35, -0.4, 0.0, 0.0)),
    "regulation-dlti-ellipsoid": (("REG_LMPC", 30), {"alpha": 0.7}, (-0.02, -0.016, 0.0, 0.0)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_nmpc_solve_matches_reference(variant):
    (name, N), kw, dx0 = VARIANTS[variant]
    jc, tc = _pair(name, N, **kw)
    js, ts = j_build(jc), t_build(tc, device="cpu")
    assert ts.nz == js.nz
    dxs = np.array([dx0, np.asarray(dx0) * 0.5])
    jsolve = jax.jit(js.solve)
    ref = [jsolve(jnp.asarray(d), None, jnp.zeros(js.nz)) for d in dxs]
    z, conv = ts.solve(torch.tensor(dxs), None, torch.zeros(2, ts.nz, dtype=torch.float64))
    assert z.dtype == torch.float64 and z.shape == (2, ts.nz)
    for i, (zr, cr) in enumerate(ref):
        np.testing.assert_allclose(z[i].numpy(), np.asarray(zr), rtol=0, atol=1e-7)
        assert bool(conv[i]) == bool(cr)
    assert bool(conv.all())


@pytest.mark.parametrize("cfg", [("NMPC_N20", {}), ("NMPC_N20", {"family": "casadi"}),
                                 ("NMPC_N20", {"prediction": "collocation"}),
                                 ("REG_NMPC", {"alpha": 0.7}), ("REG_LMPC", {})])
def test_tangent_pass_equals_torch_func_jacobians(cfg):
    """The hand tangent pass (value and nz tangents in one rollout) against
    torch.func.jacfwd of the plain rollout's residual and constraint
    stacks, and its values against the plain rollout's (<= 1e-10)."""
    name, kw = cfg
    _, tc = _pair(name, 6, **kw)
    sc = t_build(tc, device="cpu")
    p = tc.plant
    dx0 = torch.tensor([[-0.35, -0.4, 0.0, 0.0], [-0.02, -0.016, 0.0, 0.1]], dtype=torch.float64)
    solve = t_nmpc.make_nmpc_solver(
        sc.cs, sc.ocp.Ks, sc.w, 6, p.ts, np.asarray(p.x_wp), p.u_wp, family=tc.family,
        prediction=tc.solver.nmpc_prediction, AB=(sc.A, sc.B), regulation=tc.ocp.regulation,
        P_term=np.asarray(lt.config.REG_P) if tc.ocp.regulation else None,
        ellipsoid_alpha=tc.ocp.ellipsoid_alpha, device="cpu")
    values = solve.parts["values"]
    z = torch.tensor(np.random.default_rng(3).normal(0.0, 0.05, (2, sc.nz)))
    e, J, c, Jc = solve.parts["jac"](z, dx0)
    e_v, c_v = values(z, dx0)
    for got, fn, want in ((J, lambda zz: values(zz, dx0)[0], e_v),
                          (Jc, lambda zz: values(zz, dx0)[1], c_v)):
        # lanes independent: the per-lane Jacobian is the lane-sum's
        ref = torch.func.jacfwd(lambda zz: fn(zz).sum(dim=0))(z)      # (rows, B, nz)
        np.testing.assert_allclose(got.numpy(), ref.permute(1, 0, 2).numpy(), rtol=0,
                                   atol=1e-10)
    np.testing.assert_allclose(e.numpy(), e_v.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(c.numpy(), c_v.numpy(), rtol=0, atol=1e-10)


def test_nmpc_episode_matches_reference():
    """build_scenario("NMPC_N20").run() over 10 steps (the rk23 plant, no
    learning, the post-step log) against the reference's episode."""
    steps = 10
    ref = j_build(make_preset("NMPC_N20", iterations=steps)).run()
    sc = t_build(lt.make_preset("NMPC_N20", iterations=steps), device="cpu")
    res = sc.run()
    assert bool(res.solver_converged.all()) and bool(np.asarray(ref.solver_converged).all())
    np.testing.assert_allclose(res.sys_history.numpy(), np.asarray(ref.sys_history), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(res.art_history.numpy(), np.asarray(ref.art_history), rtol=0,
                               atol=1e-7)
    # NMPC does not learn: the window stays the seeded one
    assert int(res.final_window.count) == 1


def test_nmpc_run_batch_lanes_equal_single_runs():
    """Each lane of run_batch against its own run, within 1e-9: the batched
    library routines (matmul, Cholesky) round by batch size, so the lanes
    agree to roundoff, not bit for bit."""
    cfg = dataclasses.replace(lt.make_preset("NMPC_N20", iterations=3),
                              ocp=dataclasses.replace(lt.make_preset("NMPC_N20").ocp, N=8))
    sc = t_build(cfg, device="cpu")
    dx = np.array([[-0.35, -0.4, 0.0, 0.0], [-0.3, -0.35, 0.01, 0.0], [-0.1, -0.1, 0.0, 0.5]])
    res = sc.run_batch(dx)
    assert res.sys_history.shape == (3, 4, 5)
    for i in range(3):
        one = sc.run(dx[i])
        np.testing.assert_allclose(res.sys_history[i].numpy(), one.sys_history.numpy(),
                                   rtol=0, atol=1e-9)


NMPC_PRESETS = [("NMPC_N20", {}), ("NMPC_N40", {}), ("NMPC_N50", {}),
                ("NMPC_N50", {"family": "casadi", "N": 100}), ("REG_NMPC", {}), ("REG_LMPC", {}),
                ("NMPC_N20", {"prediction": "collocation"}), ("NMPC_N20", {"prediction": "dlti"})]


@pytest.mark.parametrize("case", range(len(NMPC_PRESETS)))
def test_every_nmpc_preset_builds_and_steps(case):
    name, kw = NMPC_PRESETS[case]
    cfg = lt.make_preset(name, iterations=1)
    if "N" in kw:
        cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=kw["N"]))
    if "family" in kw:
        cfg = dataclasses.replace(cfg, family=kw["family"])
    if "prediction" in kw:
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
            cfg.solver, nmpc_prediction=kw["prediction"]))
    sc = t_build(cfg, device="cpu")
    assert sc.nz == cfg.ocp.N + 1
    solve = sc.solve
    z, conv = solve(torch.tensor([[-0.02, -0.016, 0.0, 0.0]], dtype=torch.float64), None,
                    torch.zeros(1, sc.nz, dtype=torch.float64))
    assert torch.isfinite(z).all() and z.dtype == torch.float64 and bool(conv[0])
    if cfg.ocp.regulation:
        assert bool((z[:, -1] == 0).all())   # theta pinned


def test_nmpc_entry_points_default_to_cuda():
    sc = t_build("NMPC_N20")                 # host setup only
    assert sc.nz == 21
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sc.run()
        with pytest.raises(RuntimeError, match="CUDA"):
            sc.run_batch(np.zeros((2, 4)))


@pytest.mark.parametrize("n", [5, 128, 129, 600, 1100])
def test_exact_sum_and_mv_are_sums_in_a_fixed_order(n):
    """ops/lanes' exact forms (the NMPC's QPs and merits): the sum and the
    product to roundoff, and a lane's bits the same in a batch of 1 and of
    7 (on the card the plain forms part there)."""
    from lbmpc_tpu_torch.ops.lanes import exact_mv, exact_sum

    rng = np.random.default_rng(n)
    v = torch.tensor(rng.standard_normal((7, n)))
    A = torch.tensor(rng.standard_normal((7, n, 9)))
    x = torch.tensor(rng.standard_normal((7, 9)))
    np.testing.assert_allclose(exact_sum(v).numpy(), v.sum(dim=1).numpy(), rtol=1e-13, atol=1e-12)
    np.testing.assert_allclose(exact_mv(A, x).numpy(), (A @ x[..., None])[..., 0].numpy(),
                               rtol=1e-13, atol=1e-12)
    assert torch.equal(exact_sum(v[:1]), exact_sum(v)[:1])
    assert torch.equal(exact_mv(A[:1], x[:1]), exact_mv(A, x)[:1])
