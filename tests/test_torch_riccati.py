"""PyTorch port, ops/riccati: the DARE by doubling, the sequential and the
associative-scan LQ factorizations, against scipy and the JAX package.

The same inputs (numpy, from a seed) go through both packages in float64;
the port takes a batch of lanes where the reference takes one problem.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from lbmpc_tpu.models.mgcm import mgcm_dlti
from lbmpc_tpu.ops import riccati as j_ric
from lbmpc_tpu_torch.ops import riccati as t_ric

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=F64)


def _lq_problem(seed, n, m, N, stage_varying=False):
    rng = np.random.default_rng(seed)
    A = 0.95 * np.eye(n) + 0.05 * rng.standard_normal((n, n))
    B = rng.standard_normal((n, m))
    if stage_varying:
        Lq = 0.3 * rng.standard_normal((N, n, n))
        Q = np.eye(n) + Lq @ np.swapaxes(Lq, -1, -2)
        Lr = 0.3 * rng.standard_normal((N, m, m))
        R = np.eye(m) + Lr @ np.swapaxes(Lr, -1, -2)
    else:
        Q, R = np.eye(n), np.eye(m)
    P = 3 * np.eye(n)
    x0 = rng.standard_normal(n)
    q = 0.1 * rng.standard_normal((N, n))
    r = 0.1 * rng.standard_normal((N, m))
    c = 0.02 * rng.standard_normal((N, n))
    p = 0.1 * rng.standard_normal(n)
    return A, B, Q, R, P, x0, q, r, c, p


def _port(fn, A, B, Q, R, P, x0, q, r, c, p):
    """The port's fn on one lane (lane axis added on every per-problem array)."""
    Qt = _t(Q)[None] if np.ndim(Q) == 3 else _t(Q)
    Rt = _t(R)[None] if np.ndim(R) == 3 else _t(R)
    return fn(_t(A), _t(B), Qt, Rt, _t(P), _t(x0)[None], q=_t(q)[None],
              r=_t(r)[None], c=_t(c)[None], p=_t(p)[None])


def _assert_solution_close(got, ref, atol, lane=0):
    for f in ("X", "U", "K", "k_ff", "V"):
        np.testing.assert_allclose(getattr(got, f)[lane].numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0, atol=atol,
                                   err_msg=f)


def test_dare_doubling_matches_scipy_and_reference():
    Ad, Bd, _, _ = mgcm_dlti()
    X = t_ric.dare_doubling(_t(Ad), _t(Bd), torch.eye(4, dtype=F64),
                            torch.eye(1, dtype=F64)).numpy()
    X_scipy = scipy.linalg.solve_discrete_are(Ad, Bd, np.eye(4), np.eye(1))
    np.testing.assert_allclose(X, X_scipy, rtol=1e-9)
    X_ref = np.asarray(j_ric.dare_doubling(jnp.asarray(Ad), jnp.asarray(Bd), jnp.eye(4),
                                           jnp.eye(1)))
    np.testing.assert_allclose(X, X_ref, rtol=1e-12)


def test_dare_doubling_batched_lanes():
    """Two lanes with different weights: each equals its own solve."""
    Ad, Bd, _, _ = mgcm_dlti()
    Qs = _t(np.stack([np.eye(4), np.diag([2.0, 1.0, 0.5, 3.0])]))
    X = t_ric.dare_doubling(_t(Ad), _t(Bd), Qs, torch.eye(1, dtype=F64)).numpy()
    for i in range(2):
        X_scipy = scipy.linalg.solve_discrete_are(Ad, Bd, Qs[i].numpy(), np.eye(1))
        np.testing.assert_allclose(X[i], X_scipy, rtol=1e-9)


@pytest.mark.parametrize("stage_varying", [False, True])
def test_lqr_backward_matches_reference(stage_varying):
    """Every affine term set (q, r, c, p); time-invariant and stage-varying
    Q/R; V as [V_0 .. V_N]."""
    prob = _lq_problem(0, 4, 2, 12, stage_varying)
    ref = jax.jit(j_ric.lqr_backward)(*map(jnp.asarray, prob[:6]),
                                      **dict(zip("qrcp", map(jnp.asarray, prob[6:]))))
    got = _port(t_ric.lqr_backward, *prob)
    assert got.V.shape == (1, 13, 4, 4)
    _assert_solution_close(got, ref, 1e-12)
    # dynamics consistency
    A, B, c = prob[0], prob[1], prob[8]
    X, U = got.X[0].numpy(), got.U[0].numpy()
    for k in range(12):
        np.testing.assert_allclose(X[k + 1], A @ X[k] + B @ U[k] + c[k], atol=1e-12)


def test_lqr_parallel_matches_sequential_and_reference():
    """N=64 (tests/test_riccati.py:75-94's problem, with p set), at tighter
    tolerances than the reference's own test (1e-7 / 1e-6)."""
    prob = _lq_problem(1, 4, 1, 64)
    jargs = list(map(jnp.asarray, prob[:6]))
    jkw = dict(zip("qrcp", map(jnp.asarray, prob[6:])))
    seq = _port(t_ric.lqr_backward, *prob)
    par = _port(t_ric.lqr_parallel, *prob)
    np.testing.assert_allclose(par.U.numpy(), seq.U.numpy(), atol=1e-12)
    np.testing.assert_allclose(par.X.numpy(), seq.X.numpy(), atol=1e-12)
    np.testing.assert_allclose(par.V[:, 0].numpy(), seq.V[:, 0].numpy(), atol=1e-10)
    _assert_solution_close(par, jax.jit(j_ric.lqr_parallel)(*jargs, **jkw), 1e-10)


def test_lqr_parallel_stage_varying_matches_reference():
    prob = _lq_problem(2, 4, 1, 21, stage_varying=True)
    ref = jax.jit(j_ric.lqr_parallel)(*map(jnp.asarray, prob[:6]),
                                      **dict(zip("qrcp", map(jnp.asarray, prob[6:]))))
    _assert_solution_close(_port(t_ric.lqr_parallel, *prob), ref, 1e-10)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 13])
def test_associative_scan_combines_pairs_as_jax_does(k):
    """A non-commutative operation (3x3 matrix products) scanned at odd and
    even lengths: the odd/even recursion meets the same pairs in the same
    order as jax.lax.associative_scan, so the products agree at roundoff."""
    rng = np.random.default_rng(k)
    mats = rng.standard_normal((k, 3, 3))
    ref = np.asarray(jax.jit(lambda x: jax.lax.associative_scan(jnp.matmul, x))(
        jnp.asarray(mats)))
    got = t_ric.associative_scan(lambda a, b: [a[0] @ b[0]], [_t(mats)[None]])[0][0]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=1e-13)


def test_lanes_are_independent():
    """Lanes with different x0 and dynamics: each equals its solo solve."""
    probs = [_lq_problem(s, 4, 1, 16) for s in (3, 4, 5)]
    stack = lambda i: _t(np.stack([p[i] for p in probs]))
    for fn in (t_ric.lqr_backward, t_ric.lqr_parallel):
        batch = fn(stack(0), stack(1), stack(2), stack(3), stack(4), stack(5),
                   q=stack(6), r=stack(7), c=stack(8), p=stack(9))
        for i, p in enumerate(probs):
            solo = _port(fn, *p)
            for f in ("X", "U", "K", "k_ff", "V"):
                np.testing.assert_allclose(getattr(batch, f)[i].numpy(),
                                           getattr(solo, f)[0].numpy(), rtol=0,
                                           atol=1e-13, err_msg=f)


def test_riccati_converges_to_dare():
    """Finite-horizon V_0 -> the DARE solution as N grows (after
    tests/test_riccati.py:96-107: the slow closed-loop pole of the MGCM LQR
    is ~0.996, so ~1e-4 relative at N=2000)."""
    Ad, Bd, _, _ = mgcm_dlti()
    N = 2000
    sol = t_ric.lqr_backward(_t(Ad), _t(Bd), torch.eye(4, dtype=F64),
                             torch.eye(1, dtype=F64), torch.eye(4, dtype=F64),
                             torch.zeros(1, 4, dtype=F64),
                             q=torch.zeros(1, N, 4, dtype=F64))
    X_inf = scipy.linalg.solve_discrete_are(Ad, Bd, np.eye(4), np.eye(1))
    np.testing.assert_allclose(sol.V[0, 0].numpy(), X_inf, rtol=5e-3)


def test_singular_systems_give_nonfinite_output_and_no_exception():
    """A singular S = R + B'VB (here R = 0, B = 0) gives inf/NaN, as
    jnp.linalg.solve does, and raises nothing (no host check of the
    factorization)."""
    n, m, N = 3, 1, 5
    A = _t(np.eye(n))
    B = torch.zeros(n, m, dtype=F64)
    R = torch.zeros(m, m, dtype=F64)
    x0 = torch.ones(2, n, dtype=F64)
    q = torch.zeros(2, N, n, dtype=F64)
    for fn in (t_ric.lqr_backward, t_ric.lqr_parallel):
        sol = fn(A, B, torch.eye(n, dtype=F64), R, torch.eye(n, dtype=F64), x0, q=q)
        assert not torch.isfinite(sol.K).all()
        assert not torch.isfinite(sol.U).all()
    X = t_ric.dare_doubling(A, torch.ones(n, m, dtype=F64), torch.eye(n, dtype=F64), R)
    assert not torch.isfinite(X).all()
