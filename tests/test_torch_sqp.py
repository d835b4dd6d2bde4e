"""PyTorch port, the fused SQP on both routes — xla (ops/ipm_fused on K5)
and the kernel route pallas_full (K1 + K2) — with the plain versions on the
CPU, against the reference's make_lbmpc_solver_fused(qp_kernel="xla") with
its XLA Cholesky (no Pallas), the warm-started QP chain, and the hybrid
compacted repair."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers import sqp_fused as t_sqp
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers.condensed import build_fmincon_lmpc
from lbmpc_tpu.controllers.lbmpc import LBMPCWeights
from lbmpc_tpu.oracle import init_window
from lbmpc_tpu.runtime.scenario import build_scenario

N, Q, B = 12, 18, 16
LADDER = ((1.0,), (1.0, 0.5, 0.25))


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
    rng = np.random.default_rng(0)
    dx = np.array([-0.35, -0.4, 0, 0]) + 0.01 * rng.standard_normal((B, 4))
    X = 0.1 * rng.standard_normal((B, Q, 3))
    Y = 0.001 * rng.standard_normal((B, Q, 4))
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    return cfg, sc, qp, w, t_build(tcfg), (dx, X, Y), kw


def _jax_inputs(data):
    dx, X, Y = data
    f32 = jnp.float32
    win0 = init_window(Q, dtype=f32)
    wins = type(win0)(X=jnp.asarray(X, f32), Y=jnp.asarray(Y, f32),
                      valid=jnp.ones((B, Q), f32), count=jnp.full((B,), Q, jnp.int32))
    return jnp.asarray(dx, f32), wins, jnp.zeros((B, N + 1), f32)


def _port_inputs(data):
    dx, X, Y = data
    wins = DataWindow(torch.tensor(X), torch.tensor(Y), torch.ones(B, Q, dtype=torch.float64),
                      torch.full((B,), Q, dtype=torch.int32))
    return torch.tensor(dx), wins, torch.zeros(B, N + 1)


def _port(ts, factory=t_sqp.make_lbmpc_solver_fused, **kw):
    """The port's solver; the kernel route unless `qp_kernel` says otherwise
    (the port's default is the reference's, "xla")."""
    kw.setdefault("qp_kernel", "pallas_full")
    return factory(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu", **kw)


def test_fused_sqp_matches_reference(setup, monkeypatch):
    """Kernel route (K1/K2 plain versions) vs the reference's XLA route:
    median < 1e-6, max < 5e-3, conv all (tests/test_pallas_gn.py:105)."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_fused

    cfg, sc, qp, w, ts, data, kw = setup
    ref = make_lbmpc_solver_fused(qp, sc.A, sc.B, sc.ocp.Ks, w, qp_kernel="xla",
                                  sqp_iters=2, ipm_iters=16, tile=B, **kw)
    zx, cx = ref(*_jax_inputs(data))
    zt, ct = _port(ts, sqp_iters=2, ipm_iters=16, **kw)(*_port_inputs(data))
    assert zt.dtype == torch.float32 and zt.shape == (B, N + 1)
    d = np.abs(np.asarray(zx) - zt.numpy())
    assert np.median(d) < 1e-6
    assert d.max() < 5e-3
    assert bool(np.asarray(cx).all()) and bool(ct.all())


@pytest.mark.parametrize("ipm_iters", [16, (16, 8)])
def test_xla_route_fused_sqp_matches_reference(setup, monkeypatch, ipm_iters):
    """The default route on both sides: the port's ops/ipm_fused (K5 plain
    versions) vs the reference's with its XLA Cholesky, the per-GN ladder."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_fused

    cfg, sc, qp, w, ts, data, kw = setup
    ref = make_lbmpc_solver_fused(qp, sc.A, sc.B, sc.ocp.Ks, w, sqp_iters=2,
                                  ipm_iters=ipm_iters, alphas=LADDER, tile=B, **kw)
    zx, cx = ref(*_jax_inputs(data))
    monkeypatch.delenv("LBMPC_CHOL")
    port = t_sqp.make_lbmpc_solver_fused(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w,
                                         sqp_iters=2, ipm_iters=ipm_iters,
                                         alphas=LADDER, device="cpu", **kw)
    assert port.qp_kernel == "xla"
    zt, ct = port(*_port_inputs(data))
    assert zt.dtype == torch.float32 and zt.shape == (B, N + 1)
    d = np.abs(np.asarray(zx) - zt.numpy())
    assert np.median(d) < 1e-6
    assert d.max() < 5e-3
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cx))
    assert bool(ct.all())


def test_qp_warm_chain_matches_cold_schedule(setup):
    """qp_warm: QP2 starts from QP1's final interior; the (16, 2) warm
    schedule reproduces the cold (16, 8) SQP (tests/test_pallas_ipm.py:217)."""
    cfg, sc, qp, w, ts, data, kw = setup
    cold = _port(ts, sqp_iters=2, ipm_iters=(16, 8), alphas=LADDER, **kw)
    warm = _port(ts, sqp_iters=2, ipm_iters=(16, 2), alphas=LADDER, qp_warm=True, **kw)
    z_c, c_c = cold(*_port_inputs(data))
    z_w, c_w = warm(*_port_inputs(data))
    assert (z_w - z_c).abs().max() < 1e-4
    assert bool(c_c.all()) and bool(c_w.all())


def test_raw_qpwarm_from_init_state_equals_the_solve(setup):
    """Receding-horizon entry: raw_qpwarm seeded by init_qp_state (a cold
    state) reproduces the solve bit for bit and hands back a (B, mI)
    interior."""
    cfg, sc, qp, w, ts, data, kw = setup
    s = _port(ts, sqp_iters=2, ipm_iters=(8, 8), alphas=LADDER, qp_warm=True, **kw)
    dx, wins, z0 = _port_inputs(data)
    dx, wins, z0 = dx.float(), wins.to(torch.float32), z0.float()
    z1, c1 = s.raw(dx, wins, z0)
    z2, c2, st = s.raw_qpwarm(dx, wins, z0, s.init_qp_state(dx, z0))
    assert st[0].shape == (B, qp.G.shape[0]) and st[1].shape == (B, qp.G.shape[0])
    assert torch.equal(z2, z1) and torch.equal(c2, c1) and bool(c2.all())
    with pytest.raises(ValueError, match="qp_warm"):
        _port(ts, sqp_iters=2, ipm_iters=8, **kw).raw_qpwarm(dx, wins, z0, st)


def test_all_rejected_ladder_takes_no_step(setup):
    """A NaN direction makes every merit comparison false: the lane keeps
    its iterate instead of stepping by the smallest alpha."""
    cfg, sc, qp, w, ts, data, kw = setup
    s = _port(ts, sqp_iters=1, ipm_iters=4, **kw)
    dx, wins, z0 = _port_inputs(data)
    dx, wins = dx.float(), wins.to(torch.float32)
    z0 = torch.full((B, N + 1), 0.01)
    z0[2, 0] = float("nan")
    z, conv = s.raw(dx, wins, z0)
    assert torch.isnan(z[2, 0]) and not bool(conv[2])
    assert bool(torch.isfinite(z[torch.arange(B) != 2]).all())


def test_hybrid_repair_matches_reference(setup, monkeypatch):
    """The compacted repair through the same machinery: one IPM iteration
    leaves every lane flagged (mu >= 1e-2), so the first K = round(B * frac)
    lanes (stable order, as lax.top_k) are re-solved and the rest keep the
    fused result. Reference: make_lbmpc_solver_hybrid on its XLA route with
    repair_backend="fused"."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_hybrid

    cfg, sc, qp, w, ts, data, kw = setup
    hk = dict(sqp_iters=1, ipm_iters=1, repair_frac=5.0 / B, repair_sqp_iters=1,
              repair_ipm_iters=16, repair_warm="fused", repair_backend="fused")
    ref = make_lbmpc_solver_hybrid(qp, sc.A, sc.B, sc.ocp.Ks, w, qp_kernel="xla",
                                   tile=B, **hk, **kw)
    zx, cx = ref(*_jax_inputs(data))
    hyb = _port(ts, t_sqp.make_lbmpc_solver_hybrid, **hk, **kw)
    fused = _port(ts, sqp_iters=1, ipm_iters=1, **kw)
    zt, ct = hyb(*_port_inputs(data))
    zf, cf = fused(*_port_inputs(data))
    assert not bool(cf.any())                       # every lane flagged
    assert bool(ct[:5].all()) and not bool(ct[5:].any())
    assert torch.equal(zt[5:], zf[5:])              # untouched beyond K
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cx))
    d = np.abs(np.asarray(zx) - zt.numpy())
    assert np.median(d) < 1e-6 and d.max() < 5e-3


def test_xla_route_hybrid_matches_reference(setup, monkeypatch):
    """The hybrid on the xla route with repair_backend="fused", both sides:
    the same flagged lanes are repaired and the same lanes end converged."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_hybrid

    cfg, sc, qp, w, ts, data, kw = setup
    hk = dict(sqp_iters=1, ipm_iters=1, repair_frac=5.0 / B, repair_sqp_iters=1,
              repair_ipm_iters=16, repair_warm="fused", repair_backend="fused")
    ref = make_lbmpc_solver_hybrid(qp, sc.A, sc.B, sc.ocp.Ks, w, tile=B, **hk, **kw)
    zx, cx = ref(*_jax_inputs(data))
    monkeypatch.delenv("LBMPC_CHOL")
    zt, ct = _port(ts, t_sqp.make_lbmpc_solver_hybrid, qp_kernel="xla", **hk,
                   **kw)(*_port_inputs(data))
    assert bool(ct[:5].all()) and not bool(ct[5:].any())
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cx))
    d = np.abs(np.asarray(zx) - zt.numpy())
    assert np.median(d) < 1e-6 and d.max() < 5e-3


def test_unported_routes_raise(setup, monkeypatch):
    """What the reference does not have raises ValueError: a jac_mode, a
    repair backend or seed outside its own. What is ported builds:
    jac_mode="jacfwd", pallas_mono above nz 32 and for the casadi family (K3w), the
    vmapped repair with either seed and the ws-seeded fused repair, pallas
    at nz=41, pallas_full for the casadi family, and the xla route with
    LBMPC_CHOL_BLOCKED=1 at n_p >= 32."""
    cfg, sc, qp, w, ts, data, kw = setup
    ts40 = t_build(dataclasses.replace(
        ts.cfg, ocp=dataclasses.replace(ts.cfg.ocp, N=40)))
    assert ts40.nz == 41
    for route in ("pallas", "pallas_mono"):
        _port(ts, qp_kernel=route, **kw)      # nz=13: ported
        assert _port(ts40, qp_kernel=route, **kw).qp_kernel == route   # K2w, K3w
        _port(ts, qp_kernel=route, **{**kw, "family": "casadi"})
    for backend, seed in (("vmapped", "fused"), ("vmapped", "ws"), ("fused", "ws")):
        h = _port(ts, t_sqp.make_lbmpc_solver_hybrid, repair_backend=backend,
                  repair_warm=seed, **kw)
        assert (h.repair_backend, h.repair_warm) == (backend, seed)
    assert _port(ts, t_sqp.make_lbmpc_solver_hybrid, qp_kernel="xla",
                 **kw).repair_backend == "vmapped"
    with pytest.raises(ValueError, match="repair_backend"):
        _port(ts, t_sqp.make_lbmpc_solver_hybrid, repair_backend="scan", **kw)
    assert _port(ts, qp_kernel="xla", jac_mode="jacfwd", **kw).jac_mode == "jacfwd"
    with pytest.raises(ValueError, match="jac_mode"):
        _port(ts, qp_kernel="xla", jac_mode="jacrev", **kw)
    casadi_full = _port(ts, **{**kw, "family": "casadi"})    # pallas_full, K1w
    assert casadi_full.qp_kernel == "pallas_full" and casadi_full.gn.wide
    with pytest.raises(ValueError, match="raw_qpwarm needs"):
        s = _port(ts, qp_kernel="xla", qp_warm=True, **kw)
        dx, wins, z0 = _port_inputs(data)
        s.raw_qpwarm(dx.float(), wins.to(torch.float32), z0, None)
    monkeypatch.setenv("LBMPC_CHOL_BLOCKED", "1")
    s13 = _port(ts, qp_kernel="xla", **kw)          # nz=13 -> n_p=16: no K6 there
    s41 = _port(ts40, qp_kernel="xla", **kw)        # nz=41 -> n_p=48: K6
    assert not any(f.blocked for f in s13._fused.values())
    assert all(f.blocked for f in s41._fused.values())


def test_jacfwd_matches_manual_and_reference(setup, monkeypatch):
    """jac_mode="jacfwd": torch.func.jacfwd of one lane's residual, vmapped
    over the lanes, against the hand-derived Jacobian and the reference's
    jacfwd Jacobian (float32 roundoff), and the xla-route solve against the
    manual one (the float32 class of tests/test_sqp_fused.py:106)."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_fused

    cfg, sc, qp, w, ts, data, kw = setup
    ref = make_lbmpc_solver_fused(qp, sc.A, sc.B, sc.ocp.Ks, w, sqp_iters=2, ipm_iters=16,
                                  tile=B, jac_mode="jacfwd", **kw)
    monkeypatch.delenv("LBMPC_CHOL")
    fwd = _port(ts, qp_kernel="xla", sqp_iters=2, ipm_iters=16, jac_mode="jacfwd", **kw)
    man = _port(ts, qp_kernel="xla", sqp_iters=2, ipm_iters=16, **kw)
    dx, wins, _ = _port_inputs(data)
    dx, wins = dx.float(), wins.to(torch.float32)
    z = 0.01 * torch.randn(B, N + 1, generator=torch.Generator().manual_seed(3))
    J_fwd = fwd.gn.jacfwd(z, dx, wins)
    J_man = man.gn.res_jac(z, dx, wins)[1]
    jx, jw, _ = _jax_inputs(data)
    with jax.default_matmul_precision("highest"):
        J_ref = np.asarray(ref._resjac_b(jnp.asarray(z.numpy()), jx, jw)[1])
    scale = J_ref.__abs__().max()
    assert J_fwd.shape == J_man.shape == J_ref.shape
    assert (J_fwd - J_man).abs().max().item() < 1e-5 * scale
    assert np.abs(J_fwd.numpy() - J_ref).max() < 1e-5 * scale
    zf, cf = fwd(*_port_inputs(data))
    zm, cm = man(*_port_inputs(data))
    d = (zf - zm).abs()
    assert d.median().item() < 1e-6 and d.max().item() < 5e-3
    assert bool(cf.all()) and bool(cm.all())
