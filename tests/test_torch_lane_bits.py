"""PyTorch port, a lane's bits on the per-problem stack
(runtime/scenario.build_scenario's LBMPC solver: controllers/lbmpc,
controllers/sqp, ops/ipm, ops/chol; the closed loop and the oracle around
it): a lane of a batch of B equals its solve alone, bit for bit, at every B
and wherever it sits in the batch, in float32 and float64. The products
with a shared matrix take ops/lanes.lane_mm, those per lane exact_mv, the
sums exact_sum (over the NW window too), and on the card a solve runs at
least ops/lanes.MIN_LANES lanes. At N=8, q=8 on the CPU; the solve agrees with
lbmpc_tpu's vmapped make_lbmpc_solver, and each form with its plain
product within roundoff. tests/test_torch_gpu.py holds the same on the
card at the sweep's batch sizes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.ops import ipm as t_ipm
from lbmpc_tpu_torch.ops import lanes
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.runtime.scenario import build_scenario

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers import condensed as j_cond
from lbmpc_tpu.controllers import lbmpc as j_lbmpc
from lbmpc_tpu.oracle import DataWindow as JWindow
from lbmpc_tpu.runtime.scenario import build_scenario as j_build

N, Q, LANES = 8, 8, 40
BATCHES = (1, 2, 3, 4, 5, 16, 33)
DX0 = np.array([-0.35, -0.4, 0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(make, dtype, **kw):
    cfg = make("LBMPC_N40", **kw)
    return dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
                               oracle=dataclasses.replace(cfg.oracle, q=Q),
                               solver=dataclasses.replace(cfg.solver, dtype=dtype,
                                                          sqp_iters=2, ipm_iters=10))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return dict(dx=DX0 + rng.uniform(-0.05, 0.05, (LANES, 4)),
                X=0.1 * rng.standard_normal((LANES, Q, 3)),
                Y=0.001 * rng.standard_normal((LANES, Q, 4)),
                valid=(rng.uniform(size=(LANES, Q)) > 0.2).astype(float),
                z=0.01 * rng.standard_normal((LANES, N + 1)))


@pytest.fixture(scope="module", params=["float32", "float64"])
def case(request):
    dtype = request.param
    sc = build_scenario(_cut(lt.make_preset, dtype, iterations=5), device="cpu")
    f = getattr(torch, dtype)
    d = _data()
    t = lambda k: torch.tensor(d[k], dtype=f)
    win = DataWindow(t("X"), t("Y"), t("valid"), torch.full((LANES,), Q, dtype=torch.int32))
    return dtype, sc, t("dx"), win, t("z"), d


def _lanes(dx, win, z, i, j):
    return dx[i:j], DataWindow(*(a[i:j] for a in win)), z[i:j]


def test_solve_gives_a_lane_the_same_bits_at_any_batch(case):
    """Lanes 0, B/2 and B-1 of a batch of B (the batch's head, and 7 lanes
    on) equal their solves alone, z and the converged flag, bit for bit, at
    every B."""
    _, sc, dx, win, z, _ = case
    solo = {}
    for B in BATCHES:
        for lo in (0, 7):
            zb, cb = sc.solve(*_lanes(dx, win, z, lo, lo + B))
            for i in {0, B // 2, B - 1}:
                if lo + i not in solo:
                    solo[lo + i] = sc.solve(*_lanes(dx, win, z, lo + i, lo + i + 1))
                zs, cs = solo[lo + i]
                assert torch.equal(zb[i], zs[0]) and bool(cb[i] == cs[0]), (B, lo, i)


def test_episode_gives_a_lane_the_same_bits_at_any_batch(case):
    """A 5-step closed loop (the solver, the RK23 plant, the window's push):
    lanes 0, 5 and 32 of a batch of B equal their episodes alone, bit for
    bit."""
    _, sc, dx, _, _, _ = case
    dx = dx[:33].numpy()
    alone = {i: sc.run_batch(dx[i:i + 1]) for i in (0, 5, 32)}
    for B in BATCHES:
        res = sc.run_batch(dx[:B])
        for i, one in alone.items():
            if i < B:
                for a, b in ((res.sys_history[i], one.sys_history[0]),
                             (res.final_x[i], one.final_x[0]),
                             (res.final_window.Y[i], one.final_window.Y[0])):
                    assert torch.equal(a, b), (B, i)


def test_solve_matches_the_reference():
    """The solve at B=16 against lbmpc_tpu's vmapped make_lbmpc_solver
    (float64, its XLA route): z within 1e-8, the same flags."""
    cfg = _cut(make_preset, "float64")
    jsc = j_build(cfg)
    o = jsc.ocp
    qp = j_cond.build_fmincon_lmpc(
        jsc.A, jsc.B, o.Ks, o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI, jsc.cs, N,
        dx_ref=np.asarray(cfg.dx_ref), terminal_at=cfg.ocp.terminal_at,
        tighten_first_step=cfg.ocp.tighten_first_step)
    kw = dict(family="fmincon", delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    w = j_lbmpc.LBMPCWeights.make(o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI)
    ref = j_lbmpc.make_lbmpc_solver(qp, jsc.A, jsc.B, o.Ks, w, sqp_iters=2,
                                    ipm_iters=10, dtype=jnp.float64, **kw)
    d = {k: v[:16] for k, v in _data(1).items()}
    jwin = JWindow(X=jnp.asarray(d["X"]), Y=jnp.asarray(d["Y"]),
                   valid=jnp.asarray(d["valid"]), count=jnp.full((16,), Q, jnp.int32))
    with jax.default_matmul_precision("highest"):
        z_r, c_r = jax.vmap(ref)(jnp.asarray(d["dx"]), jwin, jnp.asarray(d["z"]))
    sc = build_scenario(_cut(lt.make_preset, "float64"), device="cpu")
    t = lambda k: torch.tensor(d[k])
    z_t, c_t = sc.solve(t("dx"), DataWindow(t("X"), t("Y"), t("valid"),
                                            torch.full((16,), Q, dtype=torch.int32)), t("z"))
    assert np.abs(z_t.numpy() - np.asarray(z_r)).max() < 1e-8
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("c,r", [(1, 1), (1, 4), (4, 1), (4, 4), (9, 94), (94, 9), (41, 414)])
def test_lane_mm_rows_do_not_depend_on_the_row_count(dtype, c, r):
    """lane_mm's rows equal the same rows of a longer product, bit for bit,
    at every row count from 1 to 70 (and at an offset), and v @ M' within
    roundoff; 3-D rows fold."""
    g = torch.Generator().manual_seed(c * 1000 + r)
    v = torch.randn(140, c, generator=g, dtype=dtype)
    M = torch.randn(r, c, generator=g, dtype=dtype)
    ref = lanes.lane_mm(v, M)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert (ref - v @ M.T).abs().max() <= tol * (1 + c)
    for B in range(1, 71):
        for lo in (0, 5):
            assert torch.equal(lanes.lane_mm(v[lo:lo + B], M), ref[lo:lo + B]), (B, lo)
    assert torch.equal(lanes.lane_mm(v[:60].reshape(4, 15, c), M).reshape(60, r), ref[:60])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fma_chain_and_the_batched_forms_are_the_plain_products(dtype):
    """The card's forms of a short contraction (a product, then FMAs in
    order, or each product and sum rounded: _term_chain, run here on CPU
    tensors) are the product within roundoff, and a row's bits do not
    depend on the rows beside it; on the CPU lane_left is the batched
    product itself;
    lane_sum_dim (the NW window's sums) is the sum within roundoff in the
    card's form, its rows' bits independent of the rows beside them, and
    the sum itself on the CPU."""
    g = torch.Generator().manual_seed(3)
    v, M = torch.randn(33, 7, 4, generator=g, dtype=dtype), torch.randn(5, 4, generator=g,
                                                                      dtype=dtype)
    tol = 1e-14 if dtype == torch.float64 else 1e-5
    for fused in (True, False):
        rows = lambda w: lanes._term_chain(lambda j: w[..., j:j + 1], lambda j: M[:, j], 4,
                                           fused)
        fm = rows(v)
        assert (fm - v @ M.T).abs().max() <= tol
        for B in (1, 2, 5, 17):
            assert torch.equal(rows(v[3:3 + B]), fm[3:3 + B])
    w = torch.randn(33, 140, 4, 3, generator=g, dtype=dtype)
    card = lambda x: lanes.split_sum(x.movedim(1, -1))    # lane_sum_dim's card form
    ws = card(w)
    assert (ws - w.sum(1)).abs().max() <= 30 * tol
    for B in (1, 2, 5, 17):
        assert torch.equal(card(w[3:3 + B]), ws[3:3 + B])
    assert torch.equal(lanes.lane_sum_dim(w, 1), w.sum(1))
    S = torch.randn(33, 4, 9, generator=g, dtype=dtype)
    assert torch.equal(lanes.lane_left(M, S), M @ S)


def test_ipm_pads_a_single_lane_to_min_lanes():
    """The solvers' card path for fewer than MIN_LANES lanes
    (ops/lanes.on_lanes, which on_min_lanes takes there, run here on the
    CPU) around ops/ipm: the lane's solve is its own, its IPMSolution cut
    back to one lane."""
    rng = np.random.default_rng(2)
    n, m = 6, 14
    A = rng.standard_normal((n, n))
    H = torch.tensor(A @ A.T + n * np.eye(n))
    G = torch.tensor(rng.standard_normal((m, n)))
    g = torch.tensor(rng.standard_normal((1, n)))
    h = torch.tensor(1.0 + rng.uniform(size=(1, m)))
    want = t_ipm.solve_qp(H, g, G, h, iters=12)
    got = lanes.on_lanes(lambda g_, h_: t_ipm.solve_qp(H, g_, G, h_, iters=12),
                         lanes.MIN_LANES, g, h)
    assert lanes.MIN_LANES == 2 and isinstance(got, t_ipm.IPMSolution)
    assert got.x.shape == (1, n)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
