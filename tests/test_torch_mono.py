"""PyTorch port, the pallas_mono route (K3, ops/mono_kernel) and the pallas
route (plain GN phase + K2), with the plain versions on the CPU: K3's plain
version against the reference's XLA composition of its parts, both routes'
solves against the reference's make_lbmpc_solver_fused(qp_kernel="xla")
with its XLA Cholesky (no Pallas), the pallas route's warm chain, and the
hybrid repair on both routes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers import sqp_fused as t_sqp
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers.condensed import build_fmincon_lmpc
from lbmpc_tpu.controllers.lbmpc import LBMPCWeights, make_residual_and_jac
from lbmpc_tpu.oracle import DataWindow as JWindow
from lbmpc_tpu.runtime.scenario import build_scenario

N, Q, B = 12, 18, 16
LADDER = ((1.0,), (1.0, 0.5, 0.25))
F32 = torch.float32


@pytest.fixture(scope="module")
def setup():
    cfg = make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
                              oracle=dataclasses.replace(cfg.oracle, q=Q))
    sc = build_scenario(cfg)
    qp = build_fmincon_lmpc(
        sc.A, sc.B, sc.ocp.Ks, sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T,
        sc.ocp.LAMBDA, sc.ocp.PSI, sc.cs, N, dx_ref=np.asarray(cfg.dx_ref),
        terminal_at=cfg.ocp.terminal_at,
        tighten_first_step=cfg.ocp.tighten_first_step)
    w = LBMPCWeights.make(sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T,
                          sc.ocp.LAMBDA, sc.ocp.PSI)
    tcfg = lt.make_preset("LBMPC_N40")
    tcfg = dataclasses.replace(tcfg, ocp=dataclasses.replace(tcfg.ocp, N=N),
                               oracle=dataclasses.replace(tcfg.oracle, q=Q))
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    rng = np.random.default_rng(0)
    data = (np.array([-0.35, -0.4, 0, 0]) + 0.01 * rng.standard_normal((B, 4)),
            0.1 * rng.standard_normal((B, Q, 3)), 0.001 * rng.standard_normal((B, Q, 4)))
    return cfg, sc, qp, w, t_build(tcfg), data, kw


def _jax_inputs(data, valid=None):
    dx, X, Y = data
    f32 = jnp.float32
    valid = np.ones((B, Q)) if valid is None else valid
    wins = JWindow(X=jnp.asarray(X, f32), Y=jnp.asarray(Y, f32), valid=jnp.asarray(valid, f32),
                   count=jnp.full((B,), Q, jnp.int32))
    return jnp.asarray(dx, f32), wins, jnp.zeros((B, N + 1), f32)


def _port_inputs(data, valid=None):
    dx, X, Y = data
    valid = np.ones((B, Q)) if valid is None else valid
    wins = DataWindow(torch.tensor(X, dtype=F32), torch.tensor(Y, dtype=F32),
                      torch.tensor(valid, dtype=F32), torch.full((B,), Q, dtype=torch.int32))
    return torch.tensor(dx, dtype=F32), wins, torch.zeros(B, N + 1)


def _port(ts, factory=t_sqp.make_lbmpc_solver_fused, **kw):
    return factory(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu", **kw)


def _mono(ts, kw, iters):
    gn = GNPhase(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu",
                 **{k: v for k, v in kw.items() if k != "family"})
    t = lambda a: torch.tensor(np.asarray(a), dtype=F32)
    return MonoPhase(gn, t(ts.qp.G), t(ts.qp.h0), t(ts.qp.Hp), iters)


@pytest.mark.parametrize("iters", [8, 16])
def test_mono_plain_matches_reference_composition(setup, monkeypatch, iters):
    """K3's plain version (GNPhase.plain -> step_rhs -> mehrotra_h_plain,
    cold) against the reference's XLA parts: make_residual_and_jac for e and
    g (the class of tests/test_pallas_gn.py: e 1e-4, g 1e-5 of max|g|), then
    ipm_fused.build_fused_qp_solver(None, G, scale=True, d_cap=1e6)
    .raw_with_H on h - G z for d (median 1e-6, max 5e-2) and mu (1e-3)."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

    cfg, sc, qp, w, ts, data, kw = setup
    rng = np.random.default_rng(1)
    z = (0.02 * rng.standard_normal((B, qp.nz))).astype(np.float32)
    valid = (rng.uniform(size=(B, Q)) > 0.3).astype(float)
    dx, wins, _ = _jax_inputs(data, valid)
    f32 = jnp.float32
    _, res_jac = make_residual_and_jac(
        qp, sc.A, sc.B, sc.ocp.Ks, w, family="fmincon", delta=cfg.plant.ts,
        bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
        dx_ref=np.asarray(cfg.dx_ref), dtype=f32)
    with jax.default_matmul_precision("highest"):
        e_r, J = jax.vmap(res_jac)(jnp.asarray(z), dx, wins)
        H = (2.0 * jnp.einsum("bei,bej->bij", J, J, precision=jax.lax.Precision.HIGHEST)
             + 1e-6 * jnp.eye(qp.nz, dtype=f32)[None])
        g_r = 2.0 * jnp.einsum("bei,be->bi", J, e_r, precision=jax.lax.Precision.HIGHEST)
        h = (jnp.asarray(qp.h0, f32)[None] + dx @ jnp.asarray(qp.Hp, f32).T
             - jnp.asarray(z) @ jnp.asarray(qp.G, f32).T)
        sub = build_fused_qp_solver(None, qp.G, iters=iters, tile=B, scale=True,
                                    d_cap=1e6).raw_with_H(H, g_r, h)
    tdx, twin, _ = _port_inputs(data, valid)
    e, d, mu, g = _mono(ts, kw, iters)(torch.tensor(z), tdx, twin)
    gmax = np.abs(np.asarray(g_r)).max()
    assert np.abs(e.numpy() - np.asarray(e_r)).max() < 1e-4
    assert np.abs(g.numpy() - np.asarray(g_r)).max() < 1e-5 * gmax
    dd = np.abs(d.numpy() - np.asarray(sub.x))
    assert np.median(dd) < 1e-6 and dd.max() < 5e-2
    assert np.abs(mu.numpy() - np.asarray(sub.mu)).max() < 1e-3


@pytest.mark.parametrize("route", ["pallas_mono", "pallas"])
def test_kernel_route_solve_matches_reference(setup, monkeypatch, route):
    """The two routes' solves (plain versions) against the reference's
    XLA route at ipm_iters=(16, 8) and the two-stage ladder: median < 1e-6,
    max < 5e-3, conv all (tests/test_pallas_gn.py:105)."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_fused

    cfg, sc, qp, w, ts, data, kw = setup
    ref = make_lbmpc_solver_fused(qp, sc.A, sc.B, sc.ocp.Ks, w, sqp_iters=2,
                                  ipm_iters=(16, 8), alphas=LADDER, tile=B, **kw)
    zx, cx = ref(*_jax_inputs(data))
    port = _port(ts, qp_kernel=route, sqp_iters=2, ipm_iters=(16, 8), alphas=LADDER, **kw)
    zt, ct = port(*_port_inputs(data))
    assert zt.dtype == F32 and zt.shape == (B, N + 1)
    d = np.abs(np.asarray(zx) - zt.numpy())
    assert np.median(d) < 1e-6
    assert d.max() < 5e-3
    assert bool(np.asarray(cx).all()) and bool(ct.all())


def test_mono_equals_pallas_full_without_qp_warm(setup):
    """pallas_mono is pallas_full's GN phase and cold QP in one launch, with
    the QP's h formed in the same order: the two routes' solves are equal."""
    cfg, sc, qp, w, ts, data, kw = setup
    common = dict(sqp_iters=2, ipm_iters=(8, 4), alphas=LADDER, **kw)
    zm, cm = _port(ts, qp_kernel="pallas_mono", **common)(*_port_inputs(data))
    zf, cf = _port(ts, qp_kernel="pallas_full", **common)(*_port_inputs(data))
    assert torch.equal(zm, zf) and torch.equal(cm, cf)


def test_pallas_raw_qpwarm_from_init_state_equals_the_solve(setup):
    """The pallas route's receding-horizon entry: raw_qpwarm seeded by
    init_qp_state (a cold state) reproduces the solve bit for bit; the
    pallas_mono route has no warm chain."""
    cfg, sc, qp, w, ts, data, kw = setup
    s = _port(ts, qp_kernel="pallas", sqp_iters=2, ipm_iters=(8, 8), alphas=LADDER,
              qp_warm=True, **kw)
    dx, wins, z0 = _port_inputs(data)
    z1, c1 = s.raw(dx, wins, z0)
    z2, c2, st = s.raw_qpwarm(dx, wins, z0, s.init_qp_state(dx, z0))
    assert st[0].shape == (B, qp.G.shape[0])
    assert torch.equal(z2, z1) and torch.equal(c2, c1) and bool(c2.all())
    mono = _port(ts, qp_kernel="pallas_mono", sqp_iters=2, ipm_iters=8, qp_warm=True, **kw)
    with pytest.raises(ValueError, match="raw_qpwarm needs"):
        mono.raw_qpwarm(dx, wins, z0, st)


@pytest.mark.parametrize("route", ["pallas_mono", "pallas"])
def test_hybrid_repair_on_kernel_routes_matches_reference(setup, monkeypatch, route):
    """The fused compacted repair through each route's own kernels: one IPM
    iteration leaves every lane flagged, the first K lanes are re-solved.
    Reference: make_lbmpc_solver_hybrid on its XLA route, repair "fused"."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_hybrid

    cfg, sc, qp, w, ts, data, kw = setup
    hk = dict(sqp_iters=1, ipm_iters=1, repair_frac=5.0 / B, repair_sqp_iters=1,
              repair_ipm_iters=16, repair_warm="fused", repair_backend="fused")
    zx, cx = make_lbmpc_solver_hybrid(qp, sc.A, sc.B, sc.ocp.Ks, w, tile=B, **hk,
                                      **kw)(*_jax_inputs(data))
    zt, ct = _port(ts, t_sqp.make_lbmpc_solver_hybrid, qp_kernel=route, **hk,
                   **kw)(*_port_inputs(data))
    assert bool(ct[:5].all()) and not bool(ct[5:].any())
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cx))
    d = np.abs(np.asarray(zx) - zt.numpy())
    assert np.median(d) < 1e-6 and d.max() < 5e-3


def test_mono_wrapper_routes_cpu_tensors_to_the_plain_version(setup):
    cfg, sc, qp, w, ts, data, kw = setup
    mono = _mono(ts, kw, 4)
    dx, wins, z0 = _port_inputs(data)
    out, ref = mono(z0, dx, wins), mono.plain(z0, dx, wins)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[1].shape == (B, qp.nz) and out[2].shape == (B,)
    assert out[0].shape == (B, mono.gn.ne) and mono.kernel_ok
