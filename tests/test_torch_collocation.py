"""PyTorch port, models/collocation.py against the JAX reference at float64:
legendre_coeffs (<= 1e-14, and the reference's quadrature checks), the
batched collocation step (<= 1e-12 against the reference vmapped) and its
forward derivatives in x and u through the fixed Newton iterations
(<= 1e-10 against jax.jacfwd; the hand tangent and torch.func alike), and
the reference's own behavioural tests (tests/test_collocation.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lbmpc_tpu_torch.models import collocation as tc
from lbmpc_tpu_torch.models.mgcm import MGCM_EQ_U, MGCM_EQ_X, rk4_step, mgcm_ode, mgcm_ode_jac

from lbmpc_tpu.models import collocation as jc

B = 8


def _states(seed=0):
    rng = np.random.default_rng(seed)
    x = MGCM_EQ_X + np.array([0.2, 0.2, 0.3, 1.0]) * rng.uniform(-1, 1, (B, 4))
    u = MGCM_EQ_U + 0.3 * rng.uniform(-1, 1, B)
    return x, u


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_legendre_coeffs_match_reference(d):
    for a, b in zip(tc.legendre_coeffs(d), jc.legendre_coeffs(d)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)
    C, D, Bq = tc.legendre_coeffs(d)
    assert C.shape == (d + 1, d + 1) and D.shape == Bq.shape == (d + 1,)
    # the reference's test_coefficients_quadrature_exact, at every degree:
    # B integrates constants, D extrapolates polynomials up to degree d exactly
    assert np.isclose(Bq.sum(), 1.0)
    pts, _ = np.polynomial.legendre.leggauss(d)
    tau = np.concatenate([[0.0], (pts + 1.0) / 2.0])
    assert np.isclose(np.dot(D, tau ** d), 1.0)
    # the quadrature is exact to degree 2d - 1 (Gauss) on the collocation points
    assert np.isclose(np.dot(Bq[1:], tau[1:] ** (2 * d - 1)), 1.0 / (2 * d))


@pytest.mark.parametrize("dt", [0.01, 0.1])
@pytest.mark.parametrize("degree", [2, 3])
def test_collocation_step_matches_reference(dt, degree):
    x, u = _states(int(dt * 100) + degree)
    ref = jax.jit(jax.vmap(lambda a, b: jc.collocation_step(a, b, dt, degree=degree)))(x, u)
    got = tc.collocation_step(torch.tensor(x), torch.tensor(u), dt, degree=degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)
    # (B, 1) inputs, as a rollout passes them
    got2 = tc.collocation_step(torch.tensor(x), torch.tensor(u)[:, None], dt, degree=degree)
    assert torch.equal(got, got2)


@pytest.mark.parametrize("dt", [0.01, 0.1])
def test_collocation_forward_derivative_matches_reference_jacfwd(dt):
    """d x+ / d (x, u) through the three Newton iterations, each with the
    Newton Jacobian of the residual stack, against jax.jacfwd."""
    x, u = _states(7)
    Jx, Ju = jax.jit(jax.vmap(jax.jacfwd(lambda a, b: jc.collocation_step(a, b, dt),
                                         argnums=(0, 1))))(x, u)
    Jx, Ju = np.asarray(Jx), np.asarray(Ju)
    # the hand tangent: tangents e_0..e_3 in x and e_4 in u
    K = 5
    Tx = torch.zeros(B, K, 4, dtype=torch.float64)
    Tx[:, torch.arange(4), torch.arange(4)] = 1.0
    Tu = torch.zeros(B, K, dtype=torch.float64)
    Tu[:, 4] = 1.0
    val, T = tc.collocation_step_tangent(torch.tensor(x), Tx, torch.tensor(u), Tu, dt)
    np.testing.assert_allclose(val.numpy(), np.asarray(
        jax.vmap(lambda a, b: jc.collocation_step(a, b, dt))(x, u)), rtol=0, atol=1e-12)
    np.testing.assert_allclose(T[:, :4].transpose(1, 2).numpy(), Jx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(T[:, 4].numpy(), Ju, rtol=0, atol=1e-10)
    # torch.func through the plain step: the closed-form Newton Jacobian is
    # differentiable
    for i in range(2):
        tx, tu = torch.tensor(x[i]), torch.tensor(u[i])
        jx, ju = torch.func.jacfwd(
            lambda a, b: tc.collocation_step(a[None], b[None], dt)[0], argnums=(0, 1))(tx, tu)
        np.testing.assert_allclose(jx.numpy(), Jx[i], rtol=0, atol=1e-10)
        np.testing.assert_allclose(ju.numpy(), Ju[i], rtol=0, atol=1e-10)


def test_closed_form_ode_jacobian_matches_autodiff():
    x, u = _states(3)
    xu = torch.cat([torch.tensor(x), torch.tensor(u)[:, None]], dim=1)
    ref = torch.func.vmap(torch.func.jacfwd(lambda v: mgcm_ode(v[:4], v[4])))(xu)
    np.testing.assert_allclose(mgcm_ode_jac(torch.tensor(x)).numpy(), ref.numpy(),
                               rtol=0, atol=1e-13)


def test_collocation_matches_fine_rk4():
    """The reference's test_collocation_matches_fine_rk4, batched."""
    x = torch.tensor(MGCM_EQ_X + np.array([-0.2, -0.3, 0.0, 0.0]))[None].repeat(3, 1)
    u = torch.full((3,), MGCM_EQ_U + 0.2, dtype=torch.float64)
    ref = rk4_step(x, u, 0.01, substeps=64)
    got = tc.collocation_step(x, u, 0.01)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=2e-6)


def test_collocation_stable_at_large_step():
    """The reference's test: the throttle mode (lambda ~ -44.7) makes
    explicit RK4 diverge for dt >~ 0.065; implicit collocation stays
    bounded."""
    x = torch.tensor(MGCM_EQ_X + np.array([0.0, 0.0, 0.1, 0.0]))[None]
    u = torch.full((1,), MGCM_EQ_U, dtype=torch.float64)
    col, rk = x, x
    for _ in range(10):
        col = tc.collocation_step(col, u, 0.1)
        rk = rk4_step(rk, u, 0.1)
    assert torch.isfinite(col).all() and col.abs().max() < 10.0
    assert (~torch.isfinite(rk)).any() or rk.abs().max() > 1e3


def test_collocation_batches():
    """The reference's test_collocation_vmaps: a batch of 4 lanes, each
    equal to its lane alone."""
    xs = torch.tensor(MGCM_EQ_X)[None, :] + 0.05 * torch.arange(4.0, dtype=torch.float64)[
        :, None] * torch.tensor([1.0, 1.0, 0.0, 0.0], dtype=torch.float64)
    us = torch.full((4,), MGCM_EQ_U, dtype=torch.float64)
    out = tc.collocation_step(xs, us, 0.01)
    assert out.shape == (4, 4) and torch.isfinite(out).all()
    for i in range(4):
        np.testing.assert_allclose(tc.collocation_step(xs[i:i + 1], us[i:i + 1], 0.01)[0].numpy(),
                                   out[i].numpy(), rtol=0, atol=1e-15)
