"""PyTorch port, oracle: NW value and Jacobian, window pushes, residuals —
against the JAX reference at float64 (roundoff: 1e-12)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lbmpc_tpu_torch import oracle as t_or
from lbmpc_tpu import oracle as j_or

ATOL = 1e-12


def _windows(B=6, q=10, seed=0, partial=True):
    rng = np.random.default_rng(seed)
    X = 0.2 * rng.standard_normal((B, q, 3))
    Y = 0.01 * rng.standard_normal((B, q, 4))
    valid = (rng.uniform(size=(B, q)) > 0.3).astype(float) if partial else np.ones((B, q))
    count = rng.integers(0, 3 * q, B).astype(np.int32)
    xi = 0.2 * rng.standard_normal((B, 3))
    return X, Y, valid, count, xi


def _pair(X, Y, valid, count):
    jw = j_or.DataWindow(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(valid),
                         jnp.asarray(count))
    tw = t_or.DataWindow(torch.tensor(X), torch.tensor(Y), torch.tensor(valid),
                         torch.tensor(count))
    return jw, tw


def _assert_window(tw, jw):
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


def test_nw_estimate_matches_reference():
    X, Y, valid, count, xi = _windows()
    jw, tw = _pair(X, Y, valid, count)
    ref = jax.vmap(j_or.nw_estimate)(jnp.asarray(xi), jw)
    got = t_or.nw_estimate(torch.tensor(xi), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_nw_estimate_shared_window_query_stack():
    """A stack of queries against one window (the reference's unbatched form)."""
    X, Y, valid, count, xi = _windows(B=1)
    jw, tw = _pair(X[0], Y[0], valid[0], count[0])
    rng = np.random.default_rng(4)
    qs = 0.2 * rng.standard_normal((7, 3))
    ref = j_or.nw_estimate(jnp.asarray(qs), jw)
    got = t_or.nw_estimate(torch.tensor(qs), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_nw_estimate_and_jac_matches_reference():
    X, Y, valid, count, xi = _windows(seed=1)
    jw, tw = _pair(X, Y, valid, count)
    yr, Jr = jax.vmap(j_or.nw_estimate_and_jac)(jnp.asarray(xi), jw)
    yt, Jt = t_or.nw_estimate_and_jac(torch.tensor(xi), tw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yr), rtol=0, atol=ATOL)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jr), rtol=0, atol=ATOL)
    # and the closed form is the derivative of the value
    Jad = jax.vmap(jax.jacfwd(j_or.nw_estimate))(jnp.asarray(xi), jw)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jad), rtol=0, atol=1e-10)


def test_push_single_window_matches_reference():
    X, Y, valid, count, xi = _windows(B=1, q=5)
    jw, tw = _pair(X[0], Y[0], valid[0], count[0])
    rng = np.random.default_rng(2)
    for _ in range(7):  # wraps the ring
        xn, yn = rng.standard_normal(3), rng.standard_normal(4)
        jw = j_or.push(jw, jnp.asarray(xn), jnp.asarray(yn))
        tw = t_or.push(tw, torch.tensor(xn), torch.tensor(yn))
        _assert_window(tw, jw)


@pytest.mark.parametrize("lockstep", [True, False])
def test_push_batched_matches_reference(lockstep):
    """Both branches: the shared-index slab write when every lane's count is
    equal, the per-lane scatter when they differ."""
    X, Y, valid, count, xi = _windows(q=6, seed=3)
    if lockstep:
        count = np.full_like(count, 9)
    jw, tw = _pair(X, Y, valid, count)
    rng = np.random.default_rng(5)
    for _ in range(8):
        xn, yn = rng.standard_normal((6, 3)), rng.standard_normal((6, 4))
        jw = j_or.push_batched(jw, jnp.asarray(xn), jnp.asarray(yn))
        tw2 = t_or.push_batched(tw, torch.tensor(xn), torch.tensor(yn))
        assert tw2.X.data_ptr() != tw.X.data_ptr()  # input left as it was
        tw = tw2
        _assert_window(tw, jw)


def test_init_window_and_observe_residual_match_reference():
    jw = j_or.init_window(12, d_out=4)
    tw = t_or.init_window(12, d_out=4, device="cpu")
    _assert_window(tw, jw)
    tb = t_or.init_window(12, batch=(3,), dtype=torch.float32, device="cpu")
    assert tb.X.shape == (3, 12, 3) and tb.valid[:, 0].eq(1).all()
    assert tb.count.dtype == torch.int32 and tb.count.eq(1).all()
    rng = np.random.default_rng(6)
    A, B = rng.standard_normal((4, 4)), rng.standard_normal((4, 1))
    dx, du, dx1 = rng.standard_normal((5, 4)), rng.standard_normal((5, 1)), rng.standard_normal((5, 4))
    xr, yr = jax.vmap(lambda a, b, c: j_or.observe_residual(a, b, c, jnp.asarray(A), jnp.asarray(B)))(
        jnp.asarray(dx), jnp.asarray(du), jnp.asarray(dx1))
    xt, yt = t_or.observe_residual(torch.tensor(dx), torch.tensor(du), torch.tensor(dx1),
                                   torch.tensor(A), torch.tensor(B))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xr), rtol=0, atol=ATOL)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yr), rtol=0, atol=ATOL)
