"""PyTorch port, the per-problem SQP (controllers/sqp.sqp_solve behind
controllers/lbmpc.make_lbmpc_solver, on ops/ipm) and what the reference
builds on it: the hybrid solver's vmapped repair and the deferred-repair
fleet solver (make_lbmpc_solver_fleet). At N=12, q=18, B=8, both families,
against lbmpc_tpu's vmapped make_lbmpc_solver, make_lbmpc_solver_hybrid and
make_lbmpc_solver_fleet on their XLA routes (LBMPC_CHOL=xla, no Pallas)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers import lbmpc as t_lbmpc
from lbmpc_tpu_torch.controllers import sqp_fused as t_sqp
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers import condensed as j_cond
from lbmpc_tpu.controllers import lbmpc as j_lbmpc
from lbmpc_tpu.oracle import DataWindow as JWindow
from lbmpc_tpu.runtime.scenario import build_scenario

N, Q, B = 12, 18, 8
PRESET = {"fmincon": "LBMPC_N40", "casadi": "DMS_LBMPC_q100"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(preset, family):
    cfg = preset(PRESET[family])
    return dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
                               oracle=dataclasses.replace(cfg.oracle, q=Q))


@pytest.fixture(scope="module", params=["fmincon", "casadi"])
def case(request):
    """One family at N=12, q=18 on both sides, and seeded lanes: states near
    the family's start, random windows with a third of the points invalid,
    a small random warm start."""
    family = request.param
    cfg = _cut(make_preset, family)
    sc = build_scenario(cfg)
    o = sc.ocp
    if family == "fmincon":
        qp = j_cond.build_fmincon_lmpc(
            sc.A, sc.B, o.Ks, o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI, sc.cs, N,
            dx_ref=np.asarray(cfg.dx_ref), terminal_at=cfg.ocp.terminal_at,
            tighten_first_step=cfg.ocp.tighten_first_step)
    else:
        qp = j_cond.build_casadi_dms(
            sc.A, sc.B, o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI, sc.cs, N,
            delta=cfg.plant.ts, terminal_at=cfg.ocp.terminal_at,
            tighten_first_step=cfg.ocp.tighten_first_step)
    w = j_lbmpc.LBMPCWeights.make(o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI)
    ts = t_build(_cut(lt.make_preset, family))
    kw = dict(family=family, delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    rng = np.random.default_rng(0)
    x0 = (np.array([-0.35, -0.4, 0.0, 0.0]) if family == "fmincon"
          else np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp))
    data = dict(dx=x0 + 0.01 * rng.standard_normal((B, 4)),
                X=0.1 * rng.standard_normal((B, Q, 3)),
                Y=0.001 * rng.standard_normal((B, Q, 4)),
                valid=(rng.uniform(size=(B, Q)) > 0.3).astype(float),
                z=0.01 * rng.standard_normal((B, N + 1)))
    return family, sc, qp, w, ts, kw, data


def _jax(data, dtype):
    win = JWindow(X=jnp.asarray(data["X"], dtype), Y=jnp.asarray(data["Y"], dtype),
                  valid=jnp.asarray(data["valid"], dtype), count=jnp.full((B,), Q, jnp.int32))
    return jnp.asarray(data["dx"], dtype), win, jnp.asarray(data["z"], dtype)


def _torch(data, dtype):
    t = lambda k: torch.tensor(data[k], dtype=dtype)
    win = DataWindow(t("X"), t("Y"), t("valid"), torch.full((B,), Q, dtype=torch.int32))
    return t("dx"), win, t("z")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_make_lbmpc_solver_matches_reference(case, dtype):
    """The per-problem SQP at the reference's defaults (3 GN iterations, 30
    IPM iterations). float64: z within 1e-8, the same converged flags.
    float32: the one-solve class (|z| median < 1e-6, max < 5e-3), the same
    flags."""
    family, sc, qp, w, ts, kw, data = case
    jd, td = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32,
                                                                      torch.float32)
    ref = j_lbmpc.make_lbmpc_solver(qp, sc.A, sc.B, sc.ocp.Ks, w, dtype=jd, **kw)
    with jax.default_matmul_precision("highest"):
        z_r, c_r = jax.vmap(ref)(*_jax(data, jd))
    port = t_lbmpc.make_lbmpc_solver(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, dtype=td,
                                     device="cpu", **kw)
    z_t, c_t = port(*_torch(data, td))
    assert z_t.dtype == td and z_t.shape == (B, N + 1)
    d = np.abs(z_t.numpy() - np.asarray(z_r))
    if dtype == "float64":
        assert d.max() < 1e-8, d.max()
    else:
        assert np.median(d) < 1e-6 and d.max() < 5e-3, (np.median(d), d.max())
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))


def test_sqp_solve_with_autodiff_jacobian_matches_the_hand_jacobian(case):
    """sqp_solve without res_jac_fn (J and the gradient from torch.func)
    takes the same steps as with the hand-derived Jacobian, at float64."""
    from lbmpc_tpu_torch.controllers.sqp import sqp_solve

    family, sc, qp, w, ts, kw, data = case
    residual, res_jac = t_lbmpc.make_residual_and_jac(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w,
                                                      device="cpu", **kw)
    dx, win, z0 = _torch(data, torch.float64)
    G = torch.tensor(ts.qp.G)
    h = torch.tensor(ts.qp.h0) + dx @ torch.tensor(ts.qp.Hp).T
    res = lambda z: residual(z, dx, win)

    def cost(z):
        # sqp_solve's contract: k copies of the batch stacked along the lanes
        k = z.shape[0] // B
        tile = lambda a: a.repeat((k,) + (1,) * (a.ndim - 1))
        return (residual(z, tile(dx), DataWindow(*(tile(a) for a in win))) ** 2).sum(dim=1)

    a = sqp_solve(cost, res, G, h, z0, iters=2, ipm_iters=20,
                  res_jac_fn=lambda z: res_jac(z, dx, win))
    b = sqp_solve(cost, res, G, h, z0, iters=2, ipm_iters=20)
    assert (a.z - b.z).abs().max().item() < 1e-9
    assert torch.equal(a.qp_converged, b.qp_converged)
    assert a.step_norms.shape == (B, 2) and a.cost.shape == (B,)


@pytest.mark.parametrize("repair_warm", ["ws", "fused"])
def test_hybrid_vmapped_repair_matches_reference(case, monkeypatch, repair_warm):
    """The hybrid's vmapped repair: one IPM iteration leaves every lane
    flagged, the first K=5 are re-solved by the per-problem float32 SQP (1
    GN x 16 IPM), from the warm start or from the fused iterate. Against
    the reference's hybrid on its xla route: conv equal, |z| median < 1e-6,
    max < 5e-3."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_hybrid

    family, sc, qp, w, ts, kw, data = case
    hk = dict(sqp_iters=1, ipm_iters=1, repair_frac=5.0 / B, repair_sqp_iters=1,
              repair_ipm_iters=16, repair_warm=repair_warm, repair_backend="vmapped")
    with jax.default_matmul_precision("highest"):
        z_r, c_r = make_lbmpc_solver_hybrid(qp, sc.A, sc.B, sc.ocp.Ks, w, tile=B, **hk,
                                            **kw)(*_jax(data, jnp.float32))
    monkeypatch.delenv("LBMPC_CHOL")
    port = t_sqp.make_lbmpc_solver_hybrid(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu",
                                          **hk, **kw)
    assert port.repair_backend == "vmapped"
    z_t, c_t = port(*_torch(data, torch.float32))
    assert not bool(c_t[5:].any())
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))
    d = np.abs(z_t.numpy() - np.asarray(z_r))
    assert np.median(d) < 1e-6 and d.max() < 5e-3, (np.median(d), d.max())


def test_fleet_solver_matches_reference(case, monkeypatch):
    """make_lbmpc_solver_fleet at R=2: two fused batches at one IPM
    iteration (every lane flagged), then one deferred repair of the K=4
    lanes flagged first over all 16 (1 GN x 20 IPM, from the fused
    iterate). Against the reference's fleet solver on its xla route."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_fleet

    family, sc, qp, w, ts, kw, data = case
    fk = dict(sqp_iters=2, ipm_iters=1, repair_frac=4.0 / (2 * B))
    rng = np.random.default_rng(3)
    two = {k: np.stack([v, v + (0.005 * rng.standard_normal(v.shape) if k != "valid"
                                else 0.0)]) for k, v in data.items()}
    jd = jnp.float32
    jw = JWindow(X=jnp.asarray(two["X"], jd), Y=jnp.asarray(two["Y"], jd),
                 valid=jnp.asarray(two["valid"], jd), count=jnp.full((2, B), Q, jnp.int32))
    with jax.default_matmul_precision("highest"):
        z_r, c_r = make_lbmpc_solver_fleet(qp, sc.A, sc.B, sc.ocp.Ks, w, tile=B, **fk, **kw)(
            jnp.asarray(two["dx"], jd), jw, jnp.asarray(two["z"], jd))
    monkeypatch.delenv("LBMPC_CHOL")
    t = lambda k: torch.tensor(two[k], dtype=torch.float32)
    tw = DataWindow(t("X"), t("Y"), t("valid"), torch.full((2, B), Q, dtype=torch.int32))
    port = t_sqp.make_lbmpc_solver_fleet(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu",
                                         **fk, **kw)
    z_t, c_t = port(t("dx"), tw, t("z"))
    assert z_t.shape == (2, B, N + 1) and c_t.shape == (2, B)
    assert int(c_t.sum()) <= 4
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))
    d = np.abs(z_t.numpy() - np.asarray(z_r))
    assert np.median(d) < 1e-6 and d.max() < 5e-3, (np.median(d), d.max())


def test_hybrid_rejects_unknown_repair_options(case):
    family, sc, qp, w, ts, kw, data = case
    with pytest.raises(ValueError, match="repair_backend"):
        t_sqp.make_lbmpc_solver_hybrid(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu",
                                       repair_backend="scan", **kw)
    with pytest.raises(ValueError, match="repair_warm"):
        t_sqp.make_lbmpc_solver_hybrid(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu",
                                       repair_warm="cold", **kw)
