"""PyTorch port, the Gauss-Newton phase: the residual/Jacobian against
lbmpc_tpu.controllers.lbmpc.make_residual_and_jac, K1's plain version
(ops/gn_kernel.GNPhase on the CPU) against the reference's normal terms, and
the K1 -> K2 hand-off layout."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers import lbmpc as t_lbmpc
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.ops.qp_kernel import QPSolverH
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers.condensed import build_fmincon_lmpc
from lbmpc_tpu.controllers.lbmpc import LBMPCWeights, make_residual_and_jac
from lbmpc_tpu.oracle import DataWindow as JWindow
from lbmpc_tpu.runtime.scenario import build_scenario

N, Q, B = 12, 18, 16


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
    return cfg, sc, qp, w, t_build(tcfg)


def _inputs(nz, seed=0, partial=True):
    rng = np.random.default_rng(seed)
    z = 0.02 * rng.standard_normal((B, nz))
    dx = np.array([-0.35, -0.4, 0, 0]) + 0.01 * rng.standard_normal((B, 4))
    X = 0.1 * rng.standard_normal((B, Q, 3))
    Y = 0.001 * rng.standard_normal((B, Q, 4))
    valid = (rng.uniform(size=(B, Q)) > 0.3).astype(float) if partial else np.ones((B, Q))
    return z, dx, X, Y, valid


def _ref_resjac(cfg, sc, qp, w, dtype, family="fmincon"):
    _, res_jac = make_residual_and_jac(
        qp, sc.A, sc.B, sc.ocp.Ks, w, family=family, delta=cfg.plant.ts,
        bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
        dx_ref=np.asarray(cfg.dx_ref), dtype=dtype)
    return jax.vmap(res_jac, in_axes=(0, 0, 0))


def _port_resjac(cfg, ts, dtype, family="fmincon"):
    return t_lbmpc.make_residual_and_jac(
        ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, family=family, delta=cfg.plant.ts,
        bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
        dx_ref=np.asarray(cfg.dx_ref), dtype=dtype, device="cpu")


def _win_pair(X, Y, valid, jdt, tdt):
    jw = JWindow(jnp.asarray(X, jdt), jnp.asarray(Y, jdt), jnp.asarray(valid, jdt),
                 jnp.full((B,), Q, jnp.int32))
    tw = DataWindow(torch.tensor(X, dtype=tdt), torch.tensor(Y, dtype=tdt),
                    torch.tensor(valid, dtype=tdt), torch.full((B,), Q, dtype=torch.int32))
    return jw, tw


@pytest.mark.parametrize("family", ["fmincon", "casadi"])
def test_residual_and_jacobian_match_reference_f64(setup, family):
    cfg, sc, qp, w, ts = setup
    z, dx, X, Y, valid = _inputs(qp.nz)
    jw, tw = _win_pair(X, Y, valid, jnp.float64, torch.float64)
    e_r, J_r = _ref_resjac(cfg, sc, qp, w, jnp.float64, family)(
        jnp.asarray(z), jnp.asarray(dx), jw)
    residual, res_jac = _port_resjac(cfg, ts, torch.float64, family)
    e_t, J_t = res_jac(torch.tensor(z), torch.tensor(dx), tw)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_r), rtol=0, atol=1e-12)
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_r), rtol=0, atol=1e-12)
    e_only = residual(torch.tensor(z), torch.tensor(dx), tw)
    np.testing.assert_allclose(e_only.numpy(), np.asarray(e_r), rtol=0, atol=1e-12)
    ne = t_lbmpc.residual_rows(N, 4, 1, family)
    assert e_t.shape == (B, ne) and J_t.shape == (B, ne, qp.nz)


def test_residual_and_jacobian_match_reference_f32(setup):
    """float32 (the kernel route's precision): f32 roundoff class."""
    cfg, sc, qp, w, ts = setup
    z, dx, X, Y, valid = _inputs(qp.nz, seed=1)
    jw, tw = _win_pair(X, Y, valid, jnp.float32, torch.float32)
    with jax.default_matmul_precision("highest"):
        e_r, J_r = _ref_resjac(cfg, sc, qp, w, jnp.float32)(
            jnp.asarray(z, jnp.float32), jnp.asarray(dx, jnp.float32), jw)
    _, res_jac = _port_resjac(cfg, ts, torch.float32)
    e_t, J_t = res_jac(torch.tensor(z, dtype=torch.float32),
                       torch.tensor(dx, dtype=torch.float32), tw)
    assert np.abs(e_t.numpy() - np.asarray(e_r)).max() < 1e-4
    jmax = np.abs(np.asarray(J_r)).max()
    assert np.abs(J_t.numpy() - np.asarray(J_r)).max() < 1e-5 * jmax


def _gn(cfg, ts):
    return GNPhase(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, delta=cfg.plant.ts,
                   bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                   dx_ref=np.asarray(cfg.dx_ref), device="cpu")


def test_gn_phase_plain_matches_reference_normal_terms(setup):
    """K1's plain version vs the reference's H = 2J'J + 1e-6 I, g = 2J'e
    (the class of tests/test_pallas_gn.py: e 1e-4, H and g 1e-5 max|H|)."""
    cfg, sc, qp, w, ts = setup
    z, dx, X, Y, valid = _inputs(qp.nz, seed=2)
    jw, tw = _win_pair(X, Y, valid, jnp.float32, torch.float32)
    f32 = jnp.float32
    with jax.default_matmul_precision("highest"):
        e_x, J = _ref_resjac(cfg, sc, qp, w, f32)(jnp.asarray(z, f32), jnp.asarray(dx, f32), jw)
        Hb = (2.0 * jnp.einsum("bei,bej->bij", J, J, precision=jax.lax.Precision.HIGHEST)
              + 1e-6 * jnp.eye(qp.nz, dtype=f32)[None])
        gb = 2.0 * jnp.einsum("bei,be->bi", J, e_x, precision=jax.lax.Precision.HIGHEST)
    gn = _gn(cfg, ts)
    e_t, H_t, g_t = gn(torch.tensor(z, dtype=torch.float32),
                       torch.tensor(dx, dtype=torch.float32), tw)
    hmax = np.abs(np.asarray(Hb)).max()
    assert np.abs(e_t.numpy() - np.asarray(e_x)).max() < 1e-4
    assert np.abs(H_t.numpy() - np.asarray(Hb)).max() < 1e-5 * hmax
    assert np.abs(g_t.numpy() - np.asarray(gb)).max() < 1e-5 * hmax


def test_gn_kernel_constant_block_folds_the_constant_rows(setup):
    """The kernel's host-side constants: Hconst = 1e-6 I + 2 J_rT' J_rT, so
    that the rank-1 rows the kernel accumulates (every row of J but the
    last n) complete H exactly."""
    cfg, sc, qp, w, ts = setup
    gn = _gn(cfg, ts)
    assert gn.kernel_ok and gn.ne == (N - 2) * 5 + 8
    nz = qp.nz
    Hc = gn.cst[72:].reshape(nz, nz).double().numpy()
    z, dx, X, Y, valid = _inputs(nz, seed=3)
    _, tw = _win_pair(X, Y, valid, jnp.float64, torch.float64)
    _, res_jac = _port_resjac(cfg, ts, torch.float64)
    e, J = res_jac(torch.tensor(z), torch.tensor(dx), tw)
    Jd = J[:, :-4].numpy()
    H_full = 2.0 * np.einsum("bri,brj->bij", J.numpy(), J.numpy()) + 1e-6 * np.eye(nz)
    H_fold = 2.0 * np.einsum("bri,brj->bij", Jd, Jd) + Hc[None]
    assert np.abs(H_fold - H_full).max() < 1e-6 * np.abs(H_full).max()
    np.testing.assert_allclose(gn.cst[:16].double().numpy(), np.asarray(ts.A).ravel(),
                               rtol=1e-6)


def test_gn_to_qp_handoff_layout_is_pinned(setup):
    """K1 emits H as (B, nz, nz) row-major, symmetric, contiguous float32 and
    K2's raw_packed reads it as it is: lane b's solve depends on lane b's H
    only (a de-interleaved layout would mix lanes — the reference once lost
    all convergence that way), and equals the reference-layout (per-lane
    2J'J + 1e-6 I) solve."""
    cfg, sc, qp, w, ts = setup
    z, dx, X, Y, valid = _inputs(qp.nz, seed=4, partial=False)
    _, tw = _win_pair(X, Y, valid, jnp.float32, torch.float32)
    gn = _gn(cfg, ts)
    zt, dxt = torch.tensor(z, dtype=torch.float32), torch.tensor(dx, dtype=torch.float32)
    e, H, g = gn(zt, dxt, tw)
    assert H.shape == (B, qp.nz, qp.nz) and H.is_contiguous() and H.dtype == torch.float32
    assert torch.equal(H, H.transpose(1, 2))
    _, J = gn.res_jac(zt, dxt, tw)
    lane3 = 2.0 * J[3].T @ J[3] + 1e-6 * torch.eye(qp.nz)
    assert (H[3] - lane3).abs().max() < 1e-5 * lane3.abs().max()
    G = torch.tensor(qp.G, dtype=torch.float32)
    h = (torch.tensor(qp.h0, dtype=torch.float32)[None]
         + dxt @ torch.tensor(qp.Hp, dtype=torch.float32).T - zt @ G.T)
    solver = QPSolverH(qp.G, iters=12, device="cpu")
    x, mu = solver.raw_packed(H, g, h)
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(0))
    xp, mup = solver.raw_packed(H[perm].contiguous(), g[perm], h[perm])
    assert (xp - x[perm]).abs().max() < 1e-5
    x_ref, _ = solver(J.transpose(1, 2) @ J * 2.0 + 1e-6 * torch.eye(qp.nz), g, h)
    assert (x_ref - x).abs().max() < 1e-4
