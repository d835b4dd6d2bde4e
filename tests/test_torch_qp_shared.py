"""PyTorch port, the shared-H Mehrotra QP (K4's plain version,
ops/qp_kernel.QPSolver on the CPU) against the reference: ops/ipm.solve_qp
on the random problem and on the N=20 LMPC QP (the cases of
tests/test_pallas_ipm.py:17-69), and build_pallas_qp_solver itself in
interpret mode on the random problem, converged flags included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lbmpc_tpu_torch.controllers.condensed import build_fmincon_lmpc
from lbmpc_tpu_torch.models.mgcm import mgcm_dlti
from lbmpc_tpu_torch.ops.qp_kernel import QPSolver, mehrotra, mehrotra_plain
from lbmpc_tpu_torch.sets.terminal import get_cons
from lbmpc_tpu_torch.synthesis import mat_ocp

from lbmpc_tpu.ops.ipm import solve_qp


def _random_problem():
    """tests/test_pallas_ipm.py:17-26: nz=6, 22 rows, B=128."""
    rng = np.random.default_rng(0)
    n, m = 6, 10
    A = rng.standard_normal((n, n))
    H = A @ A.T + n * np.eye(n)
    G = np.vstack([np.eye(n), -np.eye(n), rng.standard_normal((m, n))])
    hb = np.concatenate([np.full(2 * n, 5.0), rng.uniform(1, 3, m)])
    B = 128
    gs = rng.standard_normal((B, n))
    hs = np.tile(hb, (B, 1)) + 0.05 * rng.uniform(0, 1, (B, 2 * n + m))
    return H, G, gs, hs


def _lmpc_problem(B=128):
    """tests/test_pallas_ipm.py:38-59: the N=20 LMPC QP (806 rows, 616-row
    terminal set), built by the port's own host setup."""
    Ad, Bd, C, _ = mgcm_dlti()
    ocp = mat_ocp(Ad, Bd, C)
    cs = get_cons(
        x_min=[0.0, 1.1875, 0.1547, -20.0], x_max=[1.0, 2.1875, 2.1547, 20.0],
        u_min=0.1547, u_max=2.1547, x_wp=[0.5, 1.6875, 1.1547, 0.0], u_wp=1.1547,
        A=Ad, B=Bd, K=ocp.Ks, LAMBDA=ocp.LAMBDA, PSI=ocp.PSI,
        LAMBDA_0=ocp.LAMBDA_0, PSI_0=ocp.PSI_0, cache=True)
    qp = build_fmincon_lmpc(Ad, Bd, ocp.Ks, ocp.Q, ocp.R, ocp.P, ocp.T,
                            ocp.LAMBDA, ocp.PSI, cs, 20)
    rng = np.random.default_rng(1)
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((B, 4))
    return qp, (qp.Gg @ dxs.T).T + qp.g0, qp.h0 + (qp.Hp @ dxs.T).T


def _ref(H, g, G, h):
    return np.asarray(solve_qp(jnp.asarray(H), jnp.asarray(g), jnp.asarray(G),
                               jnp.asarray(h), iters=30).x)


def test_shared_qp_plain_matches_solve_qp_random():
    H, G, gs, hs = _random_problem()
    x, conv = QPSolver(H, G, iters=18, device="cpu").solve(gs, hs)
    assert x.dtype == torch.float32 and x.shape == gs.shape
    assert bool(conv.all())
    for i in range(6):
        np.testing.assert_allclose(x[i].numpy(), _ref(H, gs[i], G, hs[i]), atol=1e-5)


def test_shared_qp_plain_on_the_lmpc_qp():
    """float32 against the float64 reference: the control-relevant head of
    z within 5e-4, and conv > 0.95 (the reference kernel's own gates)."""
    qp, g, h = _lmpc_problem()
    assert qp.G.shape == (806, 21)
    x, conv = QPSolver(qp.H, qp.G, iters=20, device="cpu").solve(g, h)
    assert float(conv.float().mean()) > 0.95
    for i in range(4):
        np.testing.assert_allclose(x[i, :1].numpy(), _ref(qp.H, g[i], qp.G, h[i])[:1],
                                   atol=5e-4)


def test_shared_qp_plain_matches_the_reference_kernel():
    """The reference kernel itself (build_pallas_qp_solver, interpret mode)
    at nz=6, B=128: x within 1e-5 and the same converged flags. Both pad the
    22 rows to 128 with rows h = 1e6, z = 1 that enter the dual ratio test."""
    from lbmpc_tpu.ops.pallas_ipm import build_pallas_qp_solver

    H, G, gs, hs = _random_problem()
    x_pl, conv_pl = build_pallas_qp_solver(H, G, iters=18, tile=128, interpret=True)(
        jnp.asarray(gs), jnp.asarray(hs))
    x, conv = QPSolver(H, G, iters=18, device="cpu").solve(gs, hs)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_pl), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_pl))


def test_shared_qp_wrapper_routes_and_limits():
    """CPU tensors take the plain version; any batch size solves lane by
    lane as inside the batch; beyond nz 32 or 1024 rows the kernel raises."""
    H, G, gs, hs = _random_problem()
    s = QPSolver(H, G, iters=10, device="cpu")
    x, conv = s.solve(gs, hs)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    xr, cr, mur = mehrotra(t(G), t(H), t(gs), t(hs), 10)
    xp, cp, mup = mehrotra_plain(t(G), t(H), t(gs), t(hs), 10)
    assert torch.equal(x, xp) and torch.equal(xr, xp) and torch.equal(conv, cp)
    assert torch.equal(mur, mup) and mup.shape == (gs.shape[0],)
    x7, _ = s.solve(gs[:7], hs[:7])
    assert (x7 - x[:7]).abs().max() < 1e-5
    with pytest.raises(ValueError, match="nz <= 32"):
        QPSolver(np.eye(33), np.ones((4, 33)), device="cpu")
    with pytest.raises(ValueError, match="mI <= 1024"):
        QPSolver(np.eye(3), np.ones((1025, 3)), device="cpu")
