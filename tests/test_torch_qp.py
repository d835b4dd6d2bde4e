"""PyTorch port, the Mehrotra QP (K2's plain version, ops/qp_kernel on the
CPU) against the reference's XLA-composed fused solver
(ops/ipm_fused.build_fused_qp_solver(None, G, scale=True, d_cap=1e6)
.raw_with_H — same d_cap, ridge, equilibration and tau), plus the warm-state
contract."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.ops.qp_kernel import (QPSolverH, analyze_constraint_rows,
                                           mehrotra_h, mehrotra_h_plain)
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

NZ, MI, B = 21, 214, 32


def _problems(seed=0, B=B, nz=NZ, mI=MI):
    """SQP-style QPs: a Gauss-Newton Hessian per lane, shared G (the class
    of tests/test_pallas_ipm.py:72)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((mI, nz)).astype(np.float32)
    Hb = np.zeros((B, nz, nz), np.float32)
    g = np.zeros((B, nz), np.float32)
    h = np.zeros((B, mI), np.float32)
    for b in range(B):
        J = rng.standard_normal((40, nz))
        Hb[b] = (2 * J.T @ J + 1e-3 * np.eye(nz)).astype(np.float32)
        g[b] = rng.standard_normal(nz)
        h[b] = np.abs(rng.standard_normal(mI)) + 0.1
    return G, Hb, g, h


@pytest.fixture
def xla_chol(monkeypatch):
    """The reference's fused solver with its XLA Cholesky (no Pallas)."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

    return build_fused_qp_solver


def test_qp_plain_matches_reference_fused_solver(xla_chol):
    G, Hb, g, h = _problems()
    ref = xla_chol(None, G, iters=16, tile=B, scale=True, d_cap=1e6)
    with jax.default_matmul_precision("highest"):
        sub = ref.raw_with_H(jnp.asarray(Hb), jnp.asarray(g), jnp.asarray(h))
    x, mu = QPSolverH(G, iters=16, device="cpu")(torch.tensor(Hb), torch.tensor(g),
                                                  torch.tensor(h))
    d = np.abs(x.numpy() - np.asarray(sub.x))
    assert np.median(d) < 1e-6
    assert d.max() < 5e-2
    assert np.abs(mu.numpy() - np.asarray(sub.mu)).max() < 1e-3


def test_qp_batch_of_any_size():
    """No tile: a batch of 20 (not a multiple of anything) solves lane by
    lane exactly as inside the batch of 32; so does a single lane."""
    G, Hb, g, h = _problems(seed=1)
    s = QPSolverH(G, iters=10, device="cpu")
    x, mu = s(torch.tensor(Hb), torch.tensor(g), torch.tensor(h))
    x20, mu20 = s(torch.tensor(Hb[:20]), torch.tensor(g[:20]), torch.tensor(h[:20]))
    assert (x20 - x[:20]).abs().max() < 1e-5
    x1, _ = s(torch.tensor(Hb[5:6]), torch.tensor(g[5:6]), torch.tensor(h[5:6]))
    assert (x1[0] - x[5]).abs().max() < 1e-5


def test_cold_state_reproduces_the_cold_solve_bit_for_bit():
    G, Hb, g, h = _problems(seed=2)
    H, gt, ht = torch.tensor(Hb), torch.tensor(g), torch.tensor(h)
    cold = QPSolverH(G, iters=8, warm_out=True, device="cpu")
    warm = QPSolverH(G, iters=8, warm_in=True, warm_out=True, device="cpu")
    x0, mu0, (s0, z0) = cold(H, gt, ht)
    x1, mu1, (s1, z1) = warm(H, gt, ht, warm=QPSolverH.cold_state(ht))
    for a, b in ((x0, x1), (mu0, mu1), (s0, s1), (z0, z1)):
        assert torch.equal(a, b)


def test_warm_state_layout_and_chain():
    """Warm state: (s, z), each (B, mI) float32 in G's row order — at a
    converged solve s = h - G x row by row. Chained into the step-space QP
    at that solution (h' = h - G x, the SQP's next rhs) with warm_in, a
    short solve stays at the optimum: the step is ~0 and mu stays small."""
    G, Hb, g, h = _problems(seed=3)
    H, gt, ht = torch.tensor(Hb), torch.tensor(g), torch.tensor(h)
    Gt = torch.tensor(G)
    x, mu, (s, z) = QPSolverH(G, iters=30, warm_out=True, device="cpu")(H, gt, ht)
    assert s.shape == (B, MI) and z.shape == (B, MI) and s.dtype == torch.float32
    assert (s - (ht - x @ Gt.T)).abs().max() < 1e-3
    # f32 hard lanes may stall (mu ~ 1e-3, the documented class); chain the
    # converged ones
    ok = mu < 1e-6
    assert int(ok.sum()) >= 3 * B // 4
    g2 = gt + (H @ x[..., None])[..., 0]
    warm = QPSolverH(G, iters=3, warm_in=True, device="cpu")
    dx, mu2 = warm(H, g2, ht - x @ Gt.T, warm=(s, z))
    assert dx[ok].abs().max() < 1e-3
    assert bool((mu2[ok] < 1e-4).all())
    with pytest.raises(ValueError, match="warm state"):
        warm(H, g2, ht)
    # the floor: a zero state starts strictly inside at warm_eps
    _, _, (s3, z3) = mehrotra_h_plain(Gt, H, gt, ht, 0, warm=(torch.zeros_like(ht),
                                                              torch.zeros_like(ht)))
    assert torch.all(s3 == 1e-5) and torch.all(z3 == 1e-5)


def test_qp_wrapper_routes_cpu_tensors_to_the_plain_version():
    G, Hb, g, h = _problems(seed=4, B=6)
    args = [torch.tensor(a) for a in (G, Hb, g, h)]
    x, mu, st = mehrotra_h(*args, iters=5, want_state=True)
    xp, mup, stp = mehrotra_h_plain(*args, iters=5)
    assert torch.equal(x, xp) and torch.equal(mu, mup) and torch.equal(st[0], stp[0])
    assert mehrotra_h(*args, iters=5)[2] is None


def test_bench_constraint_rows():
    """The bench shape (LBMPC_N40 cut to N=20): G is (214, 21) with no
    2-column split-G block — every row is dense."""
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=20))
    qp = t_build(cfg).qp
    from lbmpc_tpu.ops.pallas_ipm import analyze_constraint_rows as ref_rows

    r, rr = analyze_constraint_rows(qp.G), ref_rows(qp.G)
    assert qp.G.shape == (214, 21)
    assert r["mS"] == rr["mS"] == 0 and r["mD"] == rr["mD"] == 214
    assert r["d_rows"] == rr["d_rows"]
