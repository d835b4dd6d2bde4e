"""PyTorch port, the DMS flagship family (casadi, N=100, q=100): the casadi
condensed builders and host setup against the reference at DMS_LBMPC_q100,
and the casadi-family fused SQP on the xla route (K5 plain versions on the
CPU) against the reference's make_lbmpc_solver_fused(family="casadi",
qp_kernel="xla") with its XLA Cholesky, at a cut horizon."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch import interop
from lbmpc_tpu_torch.controllers import condensed as t_cond
from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers import condensed as j_cond
from lbmpc_tpu.controllers.lbmpc import LBMPCWeights
from lbmpc_tpu.oracle import init_window
from lbmpc_tpu.runtime.scenario import build_scenario

QP_FIELDS = ["H", "Gg", "g0", "G", "h0", "Hp", "Sx", "Sc"]
LADDER = ((1.0,), (1.0, 0.5, 0.25))


@pytest.fixture(scope="module")
def dms():
    """DMS_LBMPC_q100 on both sides: the reference's host setup and the
    port's."""
    return build_scenario("DMS_LBMPC_q100"), t_build("DMS_LBMPC_q100")


def _assert_qp_close(a, b, atol=1e-12):
    for f in QP_FIELDS:
        np.testing.assert_allclose(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                   rtol=0, atol=atol, err_msg=f)
    assert (a.N, a.n, a.m) == (b.N, b.n, b.m)


@pytest.mark.parametrize("builder", ["build_casadi_dms", "build_casadi_dms_k"])
def test_casadi_builders_match_reference(dms, builder):
    """The two casadi condensed builders on the same matrices, within 1e-12
    (float64 host code)."""
    sc, _ = dms
    cfg = sc.cfg
    o = sc.ocp
    mats = (o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI, sc.cs, cfg.ocp.N)
    if builder == "build_casadi_dms":
        kw = dict(delta=cfg.plant.ts, terminal_at=cfg.ocp.terminal_at,
                  tighten_first_step=cfg.ocp.tighten_first_step)
        args = (sc.A, sc.B) + mats
    else:
        kw = dict(delta=cfg.plant.ts)
        args = (sc.A, sc.B, o.Ks) + mats
    ref = getattr(j_cond, builder)(*args, **kw)
    cs = interop.from_reference(sc.cs)
    got = getattr(t_cond, builder)(*args[:-2], cs, cfg.ocp.N, **kw)
    _assert_qp_close(got, ref)


def test_dms_host_setup_matches_reference(dms):
    """The port's build_scenario on the flagship: G (1024, 101) with 224
    one-column rows, 16 two-column rows and 784 others, as the reference
    builds it; the casadi_k preset DMS_LMPC_K too."""
    sc, ts = dms
    ref = j_cond.build_casadi_dms(
        sc.A, sc.B, sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T, sc.ocp.LAMBDA, sc.ocp.PSI,
        sc.cs, 100, delta=sc.cfg.plant.ts, terminal_at="first", tighten_first_step=True)
    _assert_qp_close(ts.qp, ref)
    assert ts.qp.G.shape == (1024, 101) and ts.nz == 101
    support = np.count_nonzero(ts.qp.G, axis=1)
    assert [(support == 1).sum(), (support == 2).sum(), (support > 2).sum()] == [224, 16, 784]
    for f in dataclasses.fields(ts.cs):
        a, b = getattr(ts.cs, f.name), getattr(sc.cs, f.name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-12, err_msg=f.name)
    w = LBMPCWeights.make(sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T, sc.ocp.LAMBDA, sc.ocp.PSI)
    np.testing.assert_allclose(ts.w.Lq, w.Lq, rtol=0, atol=1e-12)
    kref = build_scenario("DMS_LMPC_K")
    kq = j_cond.build_casadi_dms_k(
        kref.A, kref.B, kref.ocp.Ks, kref.ocp.Q, kref.ocp.R, kref.ocp.P, kref.ocp.T,
        kref.ocp.LAMBDA, kref.ocp.PSI, kref.cs, 100, delta=kref.cfg.plant.ts)
    _assert_qp_close(t_build("DMS_LMPC_K").qp, kq)
    got = interop.from_reference(ref)
    assert type(got) is t_cond.CondensedQP
    _assert_qp_close(got, ref, atol=0)


def _small_dms(preset, N=8, q=8):
    cfg = preset("DMS_LBMPC_q100")
    return dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
                               oracle=dataclasses.replace(cfg.oracle, q=q))


def test_casadi_xla_route_matches_reference(monkeypatch):
    """The casadi-family fused SQP (N=8, q=8, B=16) with the flagship's
    schedule: sqp_iters=2, ipm_iters=(16, 8), the per-GN ladder."""
    B, N, q = 16, 8, 8
    cfg = _small_dms(make_preset)
    sc = build_scenario(cfg)
    qp = j_cond.build_casadi_dms(
        sc.A, sc.B, sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T, sc.ocp.LAMBDA, sc.ocp.PSI,
        sc.cs, N, delta=cfg.plant.ts, terminal_at=cfg.ocp.terminal_at,
        tighten_first_step=cfg.ocp.tighten_first_step)
    w = LBMPCWeights.make(sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T, sc.ocp.LAMBDA, sc.ocp.PSI)
    kw = dict(family="casadi", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref), sqp_iters=2,
              ipm_iters=(16, 8), alphas=LADDER)
    rng = np.random.default_rng(0)
    dx0 = np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp)
    dx = dx0 + 0.01 * rng.standard_normal((B, 4))
    X = 0.1 * rng.standard_normal((B, q, 3))
    Y = 0.001 * rng.standard_normal((B, q, 4))

    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_fused as ref_fused

    f32 = jnp.float32
    win0 = init_window(q, dtype=f32)
    wins = type(win0)(X=jnp.asarray(X, f32), Y=jnp.asarray(Y, f32),
                      valid=jnp.ones((B, q), f32), count=jnp.full((B,), q, jnp.int32))
    zx, cx = ref_fused(qp, sc.A, sc.B, sc.ocp.Ks, w, qp_kernel="xla", tile=B, **kw)(
        jnp.asarray(dx, f32), wins, jnp.zeros((B, qp.nz), f32))
    monkeypatch.delenv("LBMPC_CHOL")

    ts = t_build(_small_dms(lt.make_preset))
    _assert_qp_close(ts.qp, qp)
    port = make_lbmpc_solver_fused(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu", **kw)
    tw = DataWindow(torch.tensor(X), torch.tensor(Y), torch.ones(B, q, dtype=torch.float64),
                    torch.full((B,), q, dtype=torch.int32))
    zt, ct = port(torch.tensor(dx), tw, torch.zeros(B, ts.nz))
    assert zt.shape == (B, N + 1) and zt.dtype == torch.float32
    d = np.abs(zt.numpy() - np.asarray(zx))
    assert np.median(d) < 1e-6, np.median(d)
    assert d.max() < 5e-3, d.max()
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cx))
    assert bool(ct.all())


def test_kernel_route_refuses_the_flagship(dms):
    """The one kernel route that refuses the flagship is pallas_mono: at the
    DMS shape (q=100) the reference's own fused kernel exceeds its VMEM
    budget, and the first solve raises with the reference's message, as the
    reference raises when its kernel is first called with the window.
    pallas_full (K1w + K2w) and pallas (K2w) build at nz=101. The fmincon
    family at nz=101 has 1606 constraint rows, beyond the QP kernels' 1024
    (as the reference's), so every kernel route refuses it with a clear
    ValueError instead of computing."""
    _, ts = dms
    mono = make_lbmpc_solver_fused(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, family="casadi",
                                   qp_kernel="pallas_mono", device="cpu")
    from lbmpc_tpu_torch.oracle import init_window as t_window

    win = t_window(ts.cfg.oracle.q, batch=(2,), dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match=r"scoped-VMEM need 59\.3M \(nz_p=104, q_p=104, "
                       r"tile=128, ipm=True\) exceeds the 60M grant budget"):
        mono(torch.zeros(2, 4), win, torch.zeros(2, ts.nz))
    for route in ("pallas_full", "pallas"):
        s = make_lbmpc_solver_fused(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, family="casadi",
                                    qp_kernel=route, device="cpu")
        assert s.gn.wide and not s.gn.narrow
    fm = dataclasses.replace(ts.cfg, family="fmincon", ocp=dataclasses.replace(
        ts.cfg.ocp, terminal_at="last", tighten_first_step=False))
    tf = t_build(fm)
    assert tf.nz == 101 and tf.qp.G.shape[0] > 1024
    for route in ("pallas_full", "pallas", "pallas_mono"):
        with pytest.raises(ValueError, match="mI <= 1024"):
            make_lbmpc_solver_fused(tf.qp, tf.A, tf.B, tf.ocp.Ks, tf.w,
                                    qp_kernel=route, device="cpu")
