"""PyTorch port, the per-problem interior-point stack: ops/chol (the batched
Cholesky and triangular solves, on torch.linalg's cholesky_ex and
solve_triangular) and ops/ipm (solve_qp, solve_qp_warm, solve_qp_mixed,
batched over a leading axis) against lbmpc_tpu's ops/chol and vmapped
ops/ipm, at float64 (x within 1e-9, every flag equal) and at float32 (the K2
class), on random strictly convex QPs, an infeasible one and the N=20 LMPC
QP through controllers/lmpc."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch  # noqa: F401  (TF32 off)
from lbmpc_tpu_torch.controllers.lmpc import make_lmpc_solver
from lbmpc_tpu_torch.ops import chol as t_chol
from lbmpc_tpu_torch.ops import ipm as t_ipm
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers.condensed import build_fmincon_lmpc
from lbmpc_tpu.controllers.lmpc import make_lmpc_solver as j_lmpc
from lbmpc_tpu.ops import chol as j_chol
from lbmpc_tpu.ops import ipm as j_ipm
from lbmpc_tpu.runtime.scenario import build_scenario

B, N_X, M_ROWS = 8, 6, 14
FLAGS = ("converged", "iters", "infeasible")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qps():
    """B random strictly convex QPs with x = 0 strictly feasible (h > 0) and
    a shared G, seeded with numpy."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, N_X, N_X))
    H = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(N_X)
    g = 3.0 * rng.standard_normal((B, N_X))
    G = rng.standard_normal((M_ROWS, N_X))
    h = rng.uniform(0.2, 1.0, (B, M_ROWS))
    return H, g, G, h


def _ref(fn, H, g, G, h, *args, **kw):
    out = jax.vmap(lambda H_, g_, h_: fn(H_, g_, jnp.asarray(G), h_, *args, **kw))(
        jnp.asarray(H), jnp.asarray(g), jnp.asarray(h))
    return {k: np.asarray(v) for k, v in out._asdict().items()}


def _port(fn, H, g, G, h, *args, dtype=torch.float64, **kw):
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    out = fn(t(H), t(g), t(G), t(h), *args, **kw)
    return {k: v.numpy() for k, v in out._asdict().items()}


def test_chol_matches_reference():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((B, 9, 9))
    M = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(9)
    b = rng.standard_normal((B, 9))
    L_r = np.asarray(j_chol.chol_batched(jnp.asarray(M)))
    L_t = t_chol.chol_batched(torch.tensor(M))
    np.testing.assert_allclose(L_t.numpy(), L_r, rtol=0, atol=1e-12 * np.abs(L_r).max())
    y_r = np.asarray(j_chol.solve_tri_lower(jnp.asarray(L_r), jnp.asarray(b)))
    y_t = t_chol.solve_tri_lower(torch.tensor(L_r), torch.tensor(b)).numpy()
    np.testing.assert_allclose(y_t, y_r, rtol=1e-12, atol=1e-12)
    x_r = np.asarray(j_chol.solve_tri_upper_t(jnp.asarray(L_r), jnp.asarray(y_r)))
    x_t = t_chol.solve_tri_upper_t(torch.tensor(L_r), torch.tensor(y_r)).numpy()
    np.testing.assert_allclose(x_t, x_r, rtol=1e-12, atol=1e-12)
    s_r = np.asarray(j_chol.cholesky_solve(jnp.asarray(M), jnp.asarray(b)))
    s_t = t_chol.cholesky_solve(torch.tensor(M), torch.tensor(b)).numpy()
    np.testing.assert_allclose(s_t, s_r, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(M @ s_t[..., None], b[..., None], atol=1e-10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chol_follows_the_reference_past_a_failed_pivot(dtype):
    """A lane the library cannot factor (a negative pivot) takes the
    reference's column loop with its 1e-300 floor: the same factor as the
    reference's, inf and NaN where it has them; the other lane keeps the
    library's factor."""
    M = np.stack([np.eye(3) + 0.1, np.diag([1.0, -1.0, 1.0]) + 0.01]).astype(dtype)
    L_r = np.asarray(j_chol.chol_batched(jnp.asarray(M)))
    L_t = t_chol.chol_batched(torch.tensor(M)).numpy()
    np.testing.assert_allclose(L_t, L_r, rtol=1e-6, atol=1e-6)
    assert not np.isfinite(L_t[1]).all() or np.abs(L_t[1]).max() > 1e6


@pytest.mark.parametrize("iters", [6, 30])
def test_solve_qp_float64_matches_reference(qps, iters):
    ref = _ref(j_ipm.solve_qp, *qps, iters=iters)
    port = _port(t_ipm.solve_qp, *qps, iters=iters)
    np.testing.assert_allclose(port["x"], ref["x"], rtol=0, atol=1e-9)
    for k in ("s", "z"):
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-7, atol=1e-9)
    for k in FLAGS:
        np.testing.assert_array_equal(port[k], ref[k])
    assert port["converged"].all() == (iters == 30)


def test_solve_qp_float32_matches_reference(qps):
    """Float32: the same flags (every lane freezes at the same iteration).
    Float32 freezes at the tolerance 30 eps (3.6e-6), which these random QPs
    meet in their 5th iteration ~1e-5 from the optimum, and two float32
    computations end ~2e-6 apart in the median — above the K2 class. So
    both are held to the float64 optimum: the port's median distance from it
    at most twice the reference's (+1e-7), every entry within 5e-3 of it."""
    f32 = [np.asarray(a, np.float32) for a in qps]
    ref = _ref(j_ipm.solve_qp, *f32, iters=20)
    port = _port(t_ipm.solve_qp, *f32, iters=20, dtype=torch.float32)
    x64 = _ref(j_ipm.solve_qp, *qps, iters=30)["x"]
    assert port["x"].dtype == np.float32
    e_t, e_r = np.abs(port["x"] - x64), np.abs(ref["x"] - x64)
    assert np.median(e_t) <= 2 * np.median(e_r) + 1e-7, (np.median(e_t), np.median(e_r))
    assert e_t.max() < 5e-3, e_t.max()
    for k in FLAGS:
        np.testing.assert_array_equal(port[k], ref[k])


def test_solve_qp_warm_and_mixed_match_reference(qps):
    H, g, G, h = qps
    mid = _ref(j_ipm.solve_qp, *qps, iters=5)
    init = (mid["x"], np.maximum(mid["s"], 1e-8), np.maximum(mid["z"], 1e-8))
    ref = jax.vmap(lambda H_, g_, h_, x_, s_, z_: j_ipm.solve_qp_warm(
        H_, g_, jnp.asarray(G), h_, (x_, s_, z_), iters=6))(
        *(jnp.asarray(a) for a in (H, g, h, *init)))
    t = lambda a: torch.tensor(np.asarray(a))
    port = t_ipm.solve_qp_warm(t(H), t(g), t(G), t(h), tuple(t(a) for a in init), iters=6)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-9)
    for k in FLAGS:
        np.testing.assert_array_equal(getattr(port, k).numpy(), np.asarray(getattr(ref, k)))
    ref_m = _ref(j_ipm.solve_qp_mixed, *qps, f32_iters=12, f64_iters=5)
    port_m = _port(t_ipm.solve_qp_mixed, *qps, f32_iters=12, f64_iters=5)
    # the float32 stage differs by roundoff; the float64 polish closes it
    d = np.abs(port_m["x"] - ref_m["x"])
    assert d.max() < 1e-6, d.max()
    np.testing.assert_array_equal(port_m["converged"], ref_m["converged"])
    assert port_m["x"].dtype == np.float64 and port_m["converged"].all()


def test_farkas_certificate_matches_reference():
    """An infeasible QP (x0 <= -1 and x0 >= 1) is flagged with the same
    Farkas gap; a feasible one beside it is not."""
    G = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
    h = np.array([[-1.0, -1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0]])
    H = np.broadcast_to(np.eye(2), (2, 2, 2)).copy()
    g = np.array([[0.3, -0.2], [0.3, -0.2]])
    ref = _ref(j_ipm.solve_qp, H, g, G, h, iters=30)
    port = _port(t_ipm.solve_qp, H, g, G, h, iters=30)
    np.testing.assert_array_equal(port["infeasible"], [True, False])
    np.testing.assert_array_equal(port["infeasible"], ref["infeasible"])
    np.testing.assert_allclose(port["farkas_gap"], ref["farkas_gap"], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("rank", ["full", "deficient"])
def test_farkas_certificate_float32(rank):
    """float32, where the projection's 1e-12 ridge is below eps. With a
    full-rank G the infeasible QP is flagged and the feasible one beside it
    is not (the reference's float32 gap is NaN on this QP: it flags
    neither). With a rank-deficient G (x0 + x1 <= -1 and >= 1) G'G fails to
    factor: the eager solve takes the reference's column loop, whose pivot
    floor underflows in float32, and like the reference flags neither; a
    caller that passes chol_failed (the NMPC's graph) finds the failure
    marked instead."""
    if rank == "full":
        G = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]])
        h = np.array([[-1.0, -1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0]])
    else:
        G = np.array([[1.0, 1.0], [-1.0, -1.0], [2.0, 2.0]])
        h = np.array([[-1.0, -1.0, 3.0], [1.0, 1.0, 3.0]])
    H = np.broadcast_to(np.eye(2), (2, 2, 2)).copy()
    g = np.array([[0.3, -0.2], [0.3, -0.2]])
    f32 = jnp.float32
    ref = jax.vmap(lambda H_, g_, h_: j_ipm.solve_qp(H_, g_, jnp.asarray(G, f32), h_, iters=30))(
        jnp.asarray(H, f32), jnp.asarray(g, f32), jnp.asarray(h, f32))
    port = _port(t_ipm.solve_qp, H, g, G, h, iters=30, dtype=torch.float32)
    failed = torch.zeros(2, dtype=torch.bool)
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    t_ipm.solve_qp(t(H), t(g), t(G), t(h), iters=30, chol_failed=failed)
    if rank == "full":
        np.testing.assert_array_equal(port["infeasible"], [True, False])
        assert port["farkas_gap"][0] > 1.0 and port["farkas_gap"][1] < 0.0
        assert not bool(failed.any())
    else:
        np.testing.assert_array_equal(port["infeasible"], np.asarray(ref.infeasible))
        np.testing.assert_array_equal(port["infeasible"], [False, False])
        assert bool(failed.all())


@pytest.fixture(scope="module")
def lmpc():
    """The reference's N=20 LMPC scenario and condensed QP, the port's QP and
    B states near the fmincon family's start."""
    cfg = make_preset("LMPC_N20")
    sc = build_scenario(cfg)
    o = sc.ocp
    ref_qp = build_fmincon_lmpc(sc.A, sc.B, o.Ks, o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI,
                                sc.cs, cfg.ocp.N, dx_ref=np.asarray(cfg.dx_ref),
                                terminal_at=cfg.ocp.terminal_at,
                                tighten_first_step=cfg.ocp.tighten_first_step)
    rng = np.random.default_rng(2)
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.05 * rng.standard_normal((B, 4))
    return sc, ref_qp, t_build("LMPC_N20").qp, dxs


def test_lmpc_solver_float64_matches_reference(lmpc):
    """The N=20 LMPC QP (controllers/lmpc on ops/ipm) at the preset's 25
    iterations against the reference scenario's vmapped solver."""
    ref_sc, _, qp, dxs = lmpc
    z_r, conv_r = jax.vmap(lambda dx: ref_sc.solve(dx, None, None))(jnp.asarray(dxs))
    z_t, sol = make_lmpc_solver(qp, ipm_iters=25, device="cpu")(torch.tensor(dxs))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_r), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(sol.converged.numpy(), np.asarray(conv_r))
    assert bool(sol.converged.all())


def test_lmpc_solver_float32_matches_reference(lmpc):
    """Float32: the same converged flags; where both sides converge, the K2
    class (|z| median < 1e-6, max < 5e-2). float32 Mehrotra stalls on some
    lanes of this QP (2 of these 8 at 25 iterations, unconverged on both
    sides), and there two computations that differ by roundoff end apart."""
    _, ref_qp, qp, dxs = lmpc
    z_r, sol_r = jax.vmap(j_lmpc(ref_qp, ipm_iters=25, dtype=jnp.float32))(
        jnp.asarray(dxs, jnp.float32))
    z_t, sol_t = make_lmpc_solver(qp, ipm_iters=25, dtype=torch.float32, device="cpu")(
        torch.tensor(dxs))
    conv = sol_t.converged.numpy()
    np.testing.assert_array_equal(conv, np.asarray(sol_r.converged))
    d = np.abs(z_t.numpy() - np.asarray(z_r))[conv]
    assert conv.sum() >= B // 2
    assert np.median(d) < 1e-6 and d.max() < 5e-2, (np.median(d), d.max())


def test_lmpc_solver_mixed_matches_reference(lmpc):
    """Mixed (a float32 IPM polished by 5 float64 iterations): where neither
    float32 stage stalls (mu < 1e-6 on both sides), the polished z within
    1e-6 and the same flags, all converged. Where a float32 stage stalls,
    the two polishes start up to 1e-2 apart, and 5 iterations may converge
    on one side only."""
    _, ref_qp, qp, dxs = lmpc
    z_r, sol_r = jax.vmap(j_lmpc(ref_qp, ipm_iters=25, mixed=True))(jnp.asarray(dxs))
    z_t, sol_t = make_lmpc_solver(qp, ipm_iters=25, mixed=True, device="cpu")(
        torch.tensor(dxs))
    # the float32 stages on their own (solve_qp_mixed's first call)
    mu_r = jax.vmap(j_lmpc(ref_qp, ipm_iters=25, dtype=jnp.float32))(
        jnp.asarray(dxs, jnp.float32))[1].mu
    mu_t = make_lmpc_solver(qp, ipm_iters=25, dtype=torch.float32, device="cpu")(
        torch.tensor(dxs))[1].mu.numpy()
    clean = (np.asarray(mu_r) < 1e-6) & (mu_t < 1e-6)
    assert clean.sum() >= B // 2
    assert z_t.dtype == torch.float64
    d = np.abs(z_t.numpy() - np.asarray(z_r))[clean]
    assert d.max() < 1e-6, d.max()
    np.testing.assert_array_equal(sol_t.converged.numpy()[clean],
                                  np.asarray(sol_r.converged)[clean])
    assert bool(sol_t.converged.numpy()[clean].all())


def test_lane_sum_sums_every_row_alike():
    """ops/lanes.lane_sum: rows of at most 128 entries sum as v.sum(-1) does,
    bit for bit; longer rows are summed from a padded copy (the padding not
    summed) and agree with v.sum(-1) to float32 roundoff; identical rows,
    strided views included, give identical sums."""
    from lbmpc_tpu_torch.ops.lanes import lane_sum

    rng = np.random.default_rng(8)
    for n in (51, 128, 129, 414, 514, 1024):
        v = torch.tensor(rng.standard_normal((6, n)), dtype=torch.float32)
        s = lane_sum(v)
        if n <= 128:
            assert torch.equal(s, v.sum(dim=-1))
        else:
            assert torch.allclose(s, v.sum(dim=-1), rtol=0, atol=n * 1e-6)
        same = v[:1].expand(5, n)
        assert torch.equal(lane_sum(same), lane_sum(same)[:1].expand(5))
        wide = torch.tensor(rng.standard_normal((4, n + 3)), dtype=torch.float32)[:, 1:n + 1]
        assert torch.equal(lane_sum(wide), lane_sum(wide.contiguous()))


def _random_qp(rng, n, m):
    """tests/test_ipm.py's strictly convex QP with a bounded feasible set
    (a box and random cuts)."""
    A = rng.standard_normal((n, n))
    H = A @ A.T + n * np.eye(n)
    g = rng.standard_normal(n)
    G = np.vstack([np.eye(n), -np.eye(n), rng.standard_normal((m, n))])
    h = np.concatenate([np.full(2 * n, 5.0), rng.uniform(1.0, 3.0, m)])
    return H, g, G, h


def test_solve_qp_batched_matches_reference_and_each_lane_alone():
    """The reference's test_batched_matches_loop: 16 random QPs, a G per
    lane. ops/ipm.solve_qp_batched against lbmpc_tpu's (vmapped solve_qp)
    within 1e-9 in float64, every lane converged; each lane equals its own
    solve alone (solve_qp_batched on that lane) bit for bit, and solve_qp
    with its G shared within 1e-9, as the reference holds its loop."""
    rng = np.random.default_rng(7)
    Hb, gb, Gb, hb = (np.stack(a) for a in zip(*(_random_qp(rng, 5, 6) for _ in range(16))))
    ref = j_ipm.solve_qp_batched(*map(jnp.asarray, (Hb, gb, Gb, hb)))
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    H, g, G, h = map(t, (Hb, gb, Gb, hb))
    got = t_ipm.solve_qp_batched(H, g, G, h)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    assert bool(got.converged.all())
    for i in range(16):
        alone = t_ipm.solve_qp_batched(H[i:i + 1], g[i:i + 1], G[i:i + 1], h[i:i + 1])
        assert torch.equal(alone.x[0], got.x[i]) and torch.equal(alone.mu[0], got.mu[i]), i
        single = t_ipm.solve_qp(H[i], g[i], G[i], h[i])
        np.testing.assert_allclose(single.x.numpy(), got.x[i].numpy(), rtol=0, atol=1e-9)


def _support_cases():
    """The unit box in R^4 with tests/test_ipm.py's 12 directions, and a
    bounded random polytope in R^5 (tests/test_ipm.py's LP) with 8."""
    n = 4
    box = (np.vstack([np.eye(n), -np.eye(n)]), np.ones(2 * n),
           np.random.default_rng(0).standard_normal((12, n)))
    rng = np.random.default_rng(3)
    n = 5
    F = np.vstack([np.eye(n), -np.eye(n), rng.standard_normal((10, n))])
    h = np.concatenate([np.full(2 * n, 2.0), rng.uniform(0.5, 2.0, 10)])
    return {"box": box, "random": (F, h, rng.standard_normal((8, n)))}


@pytest.mark.parametrize("case", ["box", "random"])
def test_support_function_matches_reference(case):
    """ops/ipm.support_function_batched against lbmpc_tpu's within 1e-8 in
    float64 (on the unit box also against |c|_1, the reference's
    test_support_function_box); support_function on one direction equals
    that direction's lane."""
    F, h, C = _support_cases()[case]
    ref = np.asarray(j_ipm.support_function_batched(*map(jnp.asarray, (C, F, h))))
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    got = t_ipm.support_function_batched(t(C), t(F), t(h))
    assert got.shape == (C.shape[0],) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-8)
    if case == "box":
        np.testing.assert_allclose(got.numpy(), np.abs(C).sum(axis=1), rtol=0, atol=1e-8)
    one = t_ipm.support_function(t(C[2]), t(F), t(h))
    assert one.shape == () and torch.equal(one, got[2])


def test_support_function_float32_lane_bits_do_not_depend_on_k():
    """Float32 on the CPU: each of 16 directions over the random polytope
    gets the same bits from a solve of its first k directions, k = 1, 2, 3
    and 16 (ops/lanes' forms), and the values stay within float32's class
    (2e-4) of the float64 ones."""
    F, h, C = _support_cases()["random"]
    C = np.vstack([C, np.random.default_rng(17).standard_normal((8, C.shape[1]))])
    t = lambda a: torch.tensor(a, dtype=torch.float32)
    full = t_ipm.support_function_batched(t(C), t(F), t(h))
    for k in (1, 2, 3, 16):
        assert torch.equal(t_ipm.support_function_batched(t(C[:k]), t(F), t(h)), full[:k]), k
    f64 = t_ipm.support_function_batched(*(torch.tensor(a) for a in (C, F, h)))
    np.testing.assert_allclose(full.double().numpy(), f64.numpy(), rtol=0, atol=2e-4)
