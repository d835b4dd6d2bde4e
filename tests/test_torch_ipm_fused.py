"""PyTorch port, the fused batch QP of the xla route (ops/ipm_fused with the
K5 plain versions on the CPU) against the reference's
ops/ipm_fused.build_fused_qp_solver with its XLA Cholesky (LBMPC_CHOL=xla:
no Pallas run on the reference side)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lbmpc_tpu_torch.ops import chol_kernel
from lbmpc_tpu_torch.ops import ipm_fused as t_fused

from test_torch_qp import _problems


def _port(*args, **kw):
    """The port's solver (built before a test sets LBMPC_CHOL=xla for the
    reference, the port's own K5 route)."""
    return t_fused.build_fused_qp_solver(*args, device="cpu", **kw)


def _close(x, ref):
    d = np.abs(np.asarray(x) - np.asarray(ref))
    assert np.median(d) < 1e-6, np.median(d)
    assert d.max() < 5e-2, d.max()


@pytest.mark.parametrize("iters", [8, 16])
def test_raw_with_H_matches_reference(iters, monkeypatch):
    G, Hb, g, h = _problems()
    port = _port(None, G, iters=iters)
    sol = port.raw_with_H(torch.tensor(Hb), torch.tensor(g), torch.tensor(h))
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

    ref = build_fused_qp_solver(None, G, iters=iters, tile=Hb.shape[0])
    with jax.default_matmul_precision("highest"):
        rs = ref.raw_with_H(jnp.asarray(Hb), jnp.asarray(g), jnp.asarray(h))
    _close(sol.x.numpy(), rs.x)
    assert np.abs(sol.mu.numpy() - np.asarray(rs.mu)).max() < 1e-3
    # converged compares mu with a threshold: a lane at the edge may flip
    assert (sol.converged.numpy() != np.asarray(rs.converged)).sum() <= 1
    assert sol.x.dtype == torch.float32 and sol.x.shape == g.shape


def _fmincon_qp():
    from lbmpc_tpu.controllers.condensed import build_fmincon_lmpc
    from lbmpc_tpu.models.mgcm import mgcm_dlti
    from lbmpc_tpu.sets.terminal import get_cons
    from lbmpc_tpu.synthesis import mat_ocp

    A, B, C, _ = mgcm_dlti()
    ocp = mat_ocp(A, B, C)
    cs = get_cons(
        x_min=[0.0, 1.1875, 0.1547, -20.0], x_max=[1.0, 2.1875, 2.1547, 20.0],
        u_min=0.1547, u_max=2.1547, x_wp=[0.5, 1.6875, 1.1547, 0.0], u_wp=1.1547,
        A=A, B=B, K=ocp.Ks, LAMBDA=ocp.LAMBDA, PSI=ocp.PSI,
        LAMBDA_0=ocp.LAMBDA_0, PSI_0=ocp.PSI_0, cache=True)
    return build_fmincon_lmpc(A, B, ocp.Ks, ocp.Q, ocp.R, ocp.P, ocp.T,
                              ocp.LAMBDA, ocp.PSI, cs, 20)


def test_shared_H_solve_matches_reference(monkeypatch):
    """The fmincon QP of tests/test_ipm_fused.py:84 with its shared H, at
    10 iterations: from about 12 on, float32 mu-stalls (the documented
    hard-lane class, cond(M) ~ d_cap ||G||^2) set in on lanes that depend on
    the roundoff of either implementation."""
    qp = _fmincon_qp()
    rng = np.random.default_rng(0)
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((64, 4))
    g = (qp.Gg @ dxs.T).T + qp.g0
    h = qp.h0 + (qp.Hp @ dxs.T).T
    sol = _port(qp.H, qp.G, iters=10)(torch.tensor(g), torch.tensor(h))
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

    rs = build_fused_qp_solver(qp.H, qp.G, iters=10, tile=64)(jnp.asarray(g),
                                                             jnp.asarray(h))
    _close(sol.x.numpy(), rs.x)
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(rs.converged))
    assert float(sol.converged.float().mean()) > 0.9


def _fmincon_batch(batch=512):
    qp = _fmincon_qp()
    rng = np.random.default_rng(0)
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((batch, 4))
    return qp, (qp.Gg @ dxs.T).T + qp.g0, qp.h0 + (qp.Hp @ dxs.T).T


@pytest.fixture(scope="module")
def per_lane_f64():
    """x of every lane by the reference's dense float64 solve_qp at 30
    iterations: independent of both fused solvers."""
    from lbmpc_tpu.ops.ipm import solve_qp

    qp, g, h = _fmincon_batch()
    H, G = jnp.asarray(qp.H), jnp.asarray(qp.G)
    x = jax.vmap(lambda g_, h_: solve_qp(H, g_, G, h_, iters=30).x)(jnp.asarray(g),
                                                                    jnp.asarray(h))
    return np.asarray(x)


@pytest.mark.parametrize("impl", ["port", "reference"])
@pytest.mark.parametrize("iters", [16, 20])
def test_shared_H_solve_matches_per_lane_f64(impl, iters, per_lane_f64, monkeypatch):
    """At the xla route's first-solve count (16) and the reference test's
    (20), where the port and the reference end on different hard lanes, each
    is held on its own to the check of tests/test_ipm_fused.py:84 at its
    batch of 512: x[:, 0] of lanes 0-5 within 5e-3 of an independent float64
    per-lane solve, and conv > 0.9. Over all lanes, at least 95% are within
    5e-3 (the rest are the float32 hard-lane class, in both solvers)."""
    qp, g, h = _fmincon_batch()
    if impl == "port":
        sol = _port(qp.H, qp.G, iters=iters)(torch.tensor(g), torch.tensor(h))
        x, conv = sol.x.numpy(), sol.converged.numpy()
    else:
        monkeypatch.setenv("LBMPC_CHOL", "xla")
        from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

        rs = build_fused_qp_solver(qp.H, qp.G, iters=iters, tile=512)(jnp.asarray(g),
                                                                      jnp.asarray(h))
        x, conv = np.asarray(rs.x), np.asarray(rs.converged)
    assert conv.mean() > 0.9
    d = np.abs(x[:, 0] - per_lane_f64[:, 0])
    assert d[:6].max() < 5e-3, d[:6]
    assert (d < 5e-3).mean() >= 0.95, np.nonzero(d >= 5e-3)[0]


def test_farkas_certificate_matches_reference(monkeypatch):
    """The infeasible lane of tests/test_ipm_fused.py:115 is flagged, with
    the reference's Farkas gap; the feasible lanes converge."""
    G = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
    h = np.array([[1.0, 1.0, 1.0, 1.0], [-1.0, -1.0, 1.0, 1.0], [2.0, 0.5, 1.0, 1.0]])
    sol = _port(np.eye(2), G, iters=30)(torch.zeros(3, 2), torch.tensor(h))
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

    rs = build_fused_qp_solver(np.eye(2), G, iters=30, tile=128)(jnp.zeros((3, 2)),
                                                                jnp.asarray(h))
    assert sol.infeasible.tolist() == [False, True, False] == np.asarray(rs.infeasible).tolist()
    assert sol.converged.tolist() == [True, False, True] == np.asarray(rs.converged).tolist()
    np.testing.assert_allclose(sol.farkas_gap[1].item(), float(np.asarray(rs.farkas_gap)[1]),
                               rtol=1e-5)
    assert bool(torch.isfinite(sol.x[[0, 2]]).all())


def _structured_G(seed=0, nz=13):
    """One-column rows (input boxes), a 2-column group on {0, nz-1} (the
    terminal rows on {c_0, theta}), causal dense rows and an empty row."""
    rng = np.random.default_rng(seed)
    rows = []
    for c in range(nz - 1):
        for sgn in (1.0, -1.0):
            r = np.zeros(nz)
            r[c] = sgn * rng.uniform(0.5, 2.0)
            rows.append(r)
    for _ in range(9):
        r = np.zeros(nz)
        r[0], r[nz - 1] = rng.standard_normal(2)
        rows.append(r)
    for k in range(1, nz):
        r = np.zeros(nz)
        r[:k] = rng.standard_normal(k)
        rows.append(r)
    rows.append(np.zeros(nz))
    return np.stack(rows).astype(np.float32)


@pytest.mark.parametrize("n_b", [1, 4, 7])
def test_structured_assembly_matches_dense(n_b):
    from lbmpc_tpu.ops.ipm_fused import _build_structured_assembly as ref_asm

    G = _structured_G()
    d = np.random.default_rng(1).uniform(0.0, 1e3, (6, G.shape[0])).astype(np.float32)
    M = t_fused._build_structured_assembly(G, n_b=n_b, device="cpu")(torch.tensor(d))
    dense = np.einsum("ki,bk,kj->bij", G.astype(np.float64), d.astype(np.float64),
                      G.astype(np.float64))
    rel = np.abs(M.numpy() - dense).max() / np.abs(dense).max()
    assert rel < 1e-5, rel
    with jax.default_matmul_precision("highest"):
        R = np.asarray(ref_asm(G, n_b=n_b)(jnp.asarray(d)))
    assert np.abs(M.numpy() - R).max() / np.abs(R).max() < 1e-5


def test_store_switch_routes_through_the_refactor_kernel(monkeypatch):
    """LBMPC_CHOL_STORE=0: every KKT solve refactors (K5b's plain version)
    and x equals the factor-store route bit for bit on the CPU."""
    G, Hb, g, h = _problems(seed=6, B=8)
    args = (torch.tensor(Hb), torch.tensor(g), torch.tensor(h))
    store = _port(None, G, iters=6)
    monkeypatch.setenv("LBMPC_CHOL_STORE", "0")
    nostore = _port(None, G, iters=6)
    assert store.store_L and not nostore.store_L
    calls = []
    monkeypatch.setattr(t_fused, "chol_solve",
                        lambda *a: calls.append(1) or chol_kernel.chol_solve(*a))
    assert torch.equal(nostore.raw_with_H(*args).x, store.raw_with_H(*args).x)
    assert len(calls) == 2 * 6


@pytest.mark.parametrize("what", ["refine", "LBMPC_CHOL", "LBMPC_CHOL_BLOCKED"])
def test_unported_options_raise(what, monkeypatch):
    """The fused solver's options, each off by default as in the reference,
    build now: refine=True (with L stored), LBMPC_CHOL=xla (the library
    Cholesky) and LBMPC_CHOL_BLOCKED=1 (K6, at nz=40: n_p >= 32, which the
    switch once refused)."""
    G = _structured_G(nz=40)
    kw = {}
    if what == "refine":
        kw["refine"] = True
    else:
        monkeypatch.setenv(what, "xla" if what == "LBMPC_CHOL" else "1")
    s = _port(None, G, **kw)
    assert {"refine": s.refine, "LBMPC_CHOL": s.chol_xla,
            "LBMPC_CHOL_BLOCKED": s.blocked}[what]
    assert (s.refine, s.chol_xla, s.blocked).count(True) == 1


def _ill_posed(seed=3, B=6, n=12):
    """SPD systems from the condition ~1e2 to ~1.5e9 (d = z/s spread, as late
    IPM iterations make them), their right-hand sides, and the equilibrated
    float32 factor of each (the last lane's does not exist: NaN)."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((B, n, n)))[0]
    ev = np.stack([np.logspace(0, k, n) for k in np.linspace(2, 9, B)])
    M = ((Q * ev[:, None, :]) @ Q.transpose(0, 2, 1)).astype(np.float32)
    M = 0.5 * (M + M.transpose(0, 2, 1))
    rhs = rng.standard_normal((B, n)).astype(np.float32)
    Mt, r = torch.tensor(M), torch.tensor(rhs)
    sc = torch.rsqrt(torch.diagonal(Mt, dim1=1, dim2=2))
    L, u = chol_kernel.chol_factor_solve(Mt * (sc[:, :, None] * sc[:, None, :]), r * sc, True)
    return Mt, r, sc, L, u * sc


def test_refine_step_matches_a_float64_computation():
    """_refine (the corrector's safeguarded refinement) against numpy in
    float64 on the same M, dx and L: the float64 residual, the correction
    from L (solved here in float64 on L's float32 entries), and the lanes
    where it shrinks the residual: the same lanes, dx within float32
    roundoff of the correction. The lane float32 cannot factor gets a NaN
    correction, which the safeguard does not apply."""
    M, r, sc, L, dx = _ill_posed()
    got = t_fused._refine(M, L, dx, r, sc, True)
    M64, dx64, r64 = (a.numpy().astype(np.float64) for a in (M, dx, r))
    sc64, L64 = sc.numpy().astype(np.float64), L.numpy().astype(np.float64)
    resid = np.einsum("bij,bj->bi", M64, dx64) - r64
    rhs = (resid.astype(np.float32).astype(np.float64) * sc64)[..., None]
    with np.errstate(invalid="ignore"):
        e = np.linalg.solve(L64 @ L64.transpose(0, 2, 1), rhs)[..., 0] * sc64
    resid2 = resid - np.einsum("bij,bj->bi", M64, e)
    better = (resid2 ** 2).sum(1) < (resid ** 2).sum(1)
    want = dx64 - np.where(better[:, None], e, 0.0)
    moved = (got != dx).any(dim=1).numpy()
    np.testing.assert_array_equal(moved, better)
    assert better[:-1].all() and not better[-1] and torch.equal(got[-1], dx[-1])
    scale = np.abs(dx64).max(axis=1, keepdims=True)
    assert (np.abs(got.numpy() - want) / scale)[:-1].max() < 1e-5


def test_refine_adds_one_resolve_an_iteration(monkeypatch):
    """refine=True: one more K5c re-solve an IPM iteration (the residual's),
    the solution within the float32 class of refine=False, and beside the
    JAX package's refine=True (interpret-mode Cholesky at nz=12, 4 lanes)."""
    G, Hb, g, h = _problems(seed=4, B=4, nz=12, mI=40)
    args = (torch.tensor(Hb), torch.tensor(g), torch.tensor(h))
    calls = []
    monkeypatch.setattr(t_fused, "chol_resolve",
                        lambda *a: calls.append(1) or chol_kernel.chol_resolve(*a))
    base = _port(None, G, iters=6).raw_with_H(*args)
    n_base = len(calls)
    ref_on = _port(None, G, iters=6, refine=True).raw_with_H(*args)
    assert n_base == 6 and len(calls) - n_base == 12
    assert bool(torch.isfinite(ref_on.x).all())
    _close(ref_on.x.numpy(), base.x.numpy())
    from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

    ref = build_fused_qp_solver(None, G, iters=6, refine=True, tile=4, interpret=True)
    with jax.default_matmul_precision("highest"):
        rs = ref.raw_with_H(jnp.asarray(Hb), jnp.asarray(g), jnp.asarray(h))
    _close(ref_on.x.numpy(), rs.x)


def test_library_cholesky_route_matches_reference(monkeypatch):
    """LBMPC_CHOL=xla on both sides: the port's torch.linalg route against
    the reference's jnp.linalg route, and not one K5 launch."""
    G, Hb, g, h = _problems(seed=5)
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    for name in ("chol_factor_solve", "chol_solve", "chol_resolve",
                 "chol_factor_solve_blocked", "chol_solve_blocked"):
        monkeypatch.setattr(t_fused, name, lambda *a, n=name: pytest.fail(f"{n} called"))
    port = _port(None, G, iters=8)
    assert port.chol_xla
    sol = port.raw_with_H(torch.tensor(Hb), torch.tensor(g), torch.tensor(h))
    from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

    ref = build_fused_qp_solver(None, G, iters=8, tile=Hb.shape[0])
    with jax.default_matmul_precision("highest"):
        rs = ref.raw_with_H(jnp.asarray(Hb), jnp.asarray(g), jnp.asarray(h))
    _close(sol.x.numpy(), rs.x)
    assert (sol.converged.numpy() != np.asarray(rs.converged)).sum() <= 1
    bad = torch.tensor(Hb[:2]).clone()
    bad[1] = -torch.eye(bad.shape[-1])             # a lane the library cannot factor
    L = t_fused._library_factor(bad)
    assert bool(torch.isfinite(L[0]).all()) and bool(torch.isnan(L[1]).all())
