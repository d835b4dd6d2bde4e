"""PyTorch port, K6 — the slab-blocked Cholesky behind LBMPC_CHOL_BLOCKED=1:
its plain version (K5's, ops/chol_kernel) against the reference's blocked
Pallas kernels (ops/pallas_chol.py kernel_blocked, interpret mode), the
switch's threshold, and the fused SQP's xla route with the switch on
against the route with it off at nz=41."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lbmpc_tpu_torch.ops import chol_kernel as ck
from lbmpc_tpu_torch.ops import ipm_fused as t_fused

from lbmpc_tpu.ops import pallas_chol

N_BLOCKED, B = 32, 8           # n_p = 32: the smallest shape that takes kernel_blocked


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(Bn, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((Bn, n, n))
    M = (A @ np.swapaxes(A, 1, 2) + n * np.eye(n)).astype(np.float32)
    return M, rng.standard_normal((Bn, n)).astype(np.float32)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def _clear_reference_caches():
    """The reference reads LBMPC_CHOL_BLOCKED when it traces; drop its jit
    caches so the switch is read again."""
    for fn in (pallas_chol.chol_factor_solve, pallas_chol._factor_solve_call,
               pallas_chol.chol_solve, pallas_chol._solve_call):
        fn.clear_cache()


@pytest.fixture
def blocked(monkeypatch):
    monkeypatch.setenv("LBMPC_CHOL_BLOCKED", "1")
    _clear_reference_caches()
    yield
    monkeypatch.delenv("LBMPC_CHOL_BLOCKED")
    _clear_reference_caches()


def test_plain_version_matches_the_blocked_pallas_kernels(blocked):
    """n=32 (n_p=32, four slabs), B=8, one tile: K6a's and K6b's plain
    version (K5's) against the reference's blocked chol_factor_solve and
    chol_solve in interpret mode, to float32 roundoff (relative 1e-5); K5c
    resolves K6a's L."""
    n = N_BLOCKED
    M, b = _spd(B, n, 0)
    L_flat, x_ref = pallas_chol.chol_factor_solve(jnp.asarray(M), jnp.asarray(b), tile=B,
                                                  interpret=True)
    xs_ref = pallas_chol.chol_solve(jnp.asarray(M), jnp.asarray(b), tile=B, interpret=True)
    Mt, bt = torch.tensor(M), torch.tensor(b)
    L, x = ck.chol_factor_solve_blocked(Mt, bt)
    L_ref = np.swapaxes(np.asarray(L_flat).reshape(B, n, n), 1, 2)
    assert _rel(L.numpy(), L_ref) < 1e-5
    assert _rel(x.numpy(), x_ref) < 1e-5
    assert _rel(ck.chol_solve_blocked(Mt, bt).numpy(), xs_ref) < 1e-5
    assert torch.equal(ck.chol_resolve(L, bt), x)
    assert torch.equal(torch.triu(L, diagonal=1), torch.zeros_like(L))


@pytest.mark.parametrize("n, store, expect", [(24, True, False), (25, True, True),
                                              (101, True, True), (101, False, True)])
def test_switch_threshold(monkeypatch, n, store, expect):
    """The switch takes the blocked kernels where the reference does, at
    n_p = 8 ceil(n / 8) >= 32 and only with LBMPC_CHOL_BLOCKED=1; the
    factor-store choice is independent of it."""
    assert not ck.blocked_switch(n)
    monkeypatch.setenv("LBMPC_CHOL_BLOCKED", "1")
    if not store:
        monkeypatch.setenv("LBMPC_CHOL_STORE", "0")
    assert ck.blocked_switch(n) == expect
    assert ck.factor_store_feasible() == store


@pytest.mark.parametrize("store", ["1", "0"])
def test_xla_route_blocked_equals_unblocked(monkeypatch, store):
    """LBMPC_N40 (nz=41), q=8, B=8: the fused SQP's xla route with
    LBMPC_CHOL_BLOCKED=1 goes through K6a + K5c (or K6b twice with
    LBMPC_CHOL_STORE=0) and returns the route's z and conv with the switch
    off bit for bit."""
    import dataclasses

    import lbmpc_tpu_torch as lt
    from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
    from lbmpc_tpu_torch.oracle import DataWindow
    from lbmpc_tpu_torch.runtime.scenario import build_scenario

    Bn, q, iters = 8, 8, 6
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, oracle=dataclasses.replace(cfg.oracle, q=q))
    ts = build_scenario(cfg)
    assert ts.nz == 41
    rng = np.random.default_rng(1)
    dx = torch.tensor(np.array([-0.35, -0.4, 0, 0]) + 0.01 * rng.standard_normal((Bn, 4)),
                      dtype=torch.float32)
    win = DataWindow(torch.tensor(0.1 * rng.standard_normal((Bn, q, 3)), dtype=torch.float32),
                     torch.tensor(0.001 * rng.standard_normal((Bn, q, 4)), dtype=torch.float32),
                     torch.ones(Bn, q), torch.full((Bn,), q, dtype=torch.int32))
    z0 = torch.zeros(Bn, ts.nz)
    build = lambda: make_lbmpc_solver_fused(
        ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, family="fmincon", delta=cfg.plant.ts,
        bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
        dx_ref=np.asarray(cfg.dx_ref), sqp_iters=1, ipm_iters=iters, alphas=(1.0, 0.5),
        device="cpu")
    monkeypatch.setenv("LBMPC_CHOL_STORE", store)
    off = build()
    monkeypatch.setenv("LBMPC_CHOL_BLOCKED", "1")
    on = build()
    assert on._fused[iters].blocked and not off._fused[iters].blocked
    calls = {"blocked": 0, "unblocked": 0}

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    for blk, unblk in (("chol_factor_solve_blocked", "chol_factor_solve"),
                       ("chol_solve_blocked", "chol_solve")):
        monkeypatch.setattr(t_fused, blk, count("blocked", getattr(ck, blk)))
        monkeypatch.setattr(t_fused, unblk, count("unblocked", getattr(ck, unblk)))
    z_on, c_on = on.raw(dx, win, z0)
    assert calls == {"blocked": (1 if store == "1" else 2) * iters, "unblocked": 0}
    z_off, c_off = off.raw(dx, win, z0)
    assert calls["unblocked"] == calls["blocked"]
    assert torch.equal(z_on, z_off) and torch.equal(c_on, c_off)
