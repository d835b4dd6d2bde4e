"""PyTorch port on the card: K1 (gn_phase), K2 (mehrotra_h) and K5a/b/c
(chol) against their plain versions on the same CUDA tensors, and both
routes of the fused solve against their plain routes. Marked `gpu`; without
CUDA every test skips. On a machine with an NVIDIA GPU and nvcc (no JAX
needed):

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops import chol_kernel, gn_kernel, qp_kernel
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.ops.qp_kernel import QPSolverH, mehrotra_h, mehrotra_h_plain
from lbmpc_tpu_torch.runtime.scenario import build_scenario

pytestmark = pytest.mark.gpu

N, Q = 20, 100


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def bench(cuda):
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
                              oracle=dataclasses.replace(cfg.oracle, q=Q))
    sc = build_scenario(cfg)
    kw = dict(delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    return sc, kw


def _inputs(B, nz, device, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    dx = f(np.array([-0.35, -0.4, 0, 0]) + 0.01 * rng.standard_normal((B, 4)))
    win = DataWindow(f(0.1 * rng.standard_normal((B, Q, 3))),
                     f(0.001 * rng.standard_normal((B, Q, 4))),
                     f((rng.uniform(size=(B, Q)) > 0.2).astype(float)),
                     torch.full((B,), Q, dtype=torch.int32, device=device))
    return f(0.02 * rng.standard_normal((B, nz))), dx, win


def test_gn_kernel_matches_plain(cuda, bench):
    sc, kw = bench
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    z, dx, win = _inputs(96, sc.nz, cuda)
    n0 = gn_kernel.KERNEL.launches
    e, H, g = gn(z, dx, win)
    assert gn_kernel.KERNEL.launches == n0 + 1
    e_p, H_p, g_p = gn.plain(z, dx, win)
    torch.cuda.synchronize()
    hmax = H_p.abs().max().item()
    for a, b in ((e, e_p), (H, H_p), (g, g_p)):
        assert (a - b).abs().max().item() <= 1e-5 * hmax
    assert torch.equal(H, H.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous"):
        gn(z.t().contiguous().t(), dx, win)
    with pytest.raises(ValueError, match="dtype"):
        gn(z.double(), dx, win)


@pytest.mark.parametrize("B", [24, 300])
def test_qp_kernel_matches_plain(cuda, bench, B):
    sc, kw = bench
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    z, dx, win = _inputs(B, sc.nz, cuda, seed=1)
    _, H, g = gn(z, dx, win)
    G = torch.as_tensor(sc.qp.G, dtype=torch.float32, device=cuda)
    h = (torch.as_tensor(sc.qp.h0, dtype=torch.float32, device=cuda)[None]
         + dx @ torch.as_tensor(sc.qp.Hp, dtype=torch.float32, device=cuda).T
         - z @ G.T).contiguous()
    x, mu, st = mehrotra_h(G, H, g, h, 8, want_state=True)
    xp, mup, _ = mehrotra_h_plain(G, H, g, h, 8)
    d = (x - xp).abs()
    assert d.median().item() < 1e-6 and d.max().item() < 5e-2
    assert (mu - mup).abs().max().item() < 1e-3
    xw, _, _ = mehrotra_h(G, H, g, h, 2, warm=st)
    xwp, _, _ = mehrotra_h_plain(G, H, g, h, 2, warm=st)
    d = (xw - xwp).abs()
    assert d.median().item() < 1e-6 and d.max().item() < 5e-2
    xc, muc, stc = mehrotra_h(G, H, g, h, 8, warm=QPSolverH.cold_state(h), want_state=True)
    assert torch.equal(xc, x) and torch.equal(muc, mu) and torch.equal(stc[1], st[1])


def test_fused_solve_kernel_route_matches_plain(cuda, bench):
    sc, kw = bench
    args = (sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w)
    common = dict(family="fmincon", sqp_iters=2, ipm_iters=(8, 2),
                  alphas=((1.0,), (1.0, 0.5, 0.25)), qp_warm=True,
                  qp_kernel="pallas_full", device=cuda, **kw)
    sk = make_lbmpc_solver_fused(*args, **common)
    sp = make_lbmpc_solver_fused(*args, plain=True, **common)
    _, dx, win = _inputs(256, sc.nz, cuda, seed=2)
    z0 = torch.zeros(256, sc.nz, device=cuda)
    n1, n2 = gn_kernel.KERNEL.launches, qp_kernel.KERNEL.launches
    zk, ck = sk(dx, win, z0)
    assert gn_kernel.KERNEL.launches - n1 == 2 and qp_kernel.KERNEL.launches - n2 == 2
    zp, cp = sp(dx, win, z0)
    d = (zk - zp).abs()
    assert d.median().item() < 1e-6 and d.max().item() < 5e-2
    assert abs(ck.float().mean().item() - cp.float().mean().item()) <= 0.005


@pytest.mark.parametrize("n, B", [(21, 300), (101, 40), (128, 3)])
def test_chol_kernels_match_plain(cuda, n, B):
    """K5a, K5b and K5c reproduce their plain versions bit for bit (the same
    operations in the same order, each rounded on its own), and L keeps the
    pinned layout: lower triangle, zeros above."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((B, n, n))
    M = torch.tensor(A @ np.swapaxes(A, 1, 2) + n * np.eye(n), dtype=torch.float32,
                     device=cuda)
    b = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32, device=cuda)
    n0 = [k.launches for k in chol_kernel.KERNELS]
    L, x = chol_kernel.chol_factor_solve(M, b)
    xs = chol_kernel.chol_solve(M, b)
    xr = chol_kernel.chol_resolve(L, 2.0 * b)
    assert [k.launches - c for k, c in zip(chol_kernel.KERNELS, n0)] == [1, 1, 1]
    Lp, xp = chol_kernel.chol_factor_solve(M, b, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(L, Lp) and torch.equal(x, xp) and torch.equal(xs, xp)
    assert torch.equal(xr, chol_kernel.chol_resolve(Lp, 2.0 * b, plain=True))
    assert torch.equal(torch.triu(L, diagonal=1), torch.zeros_like(L))
    with pytest.raises(ValueError, match="n <= 128"):
        chol_kernel.chol_solve(torch.zeros(1, 129, 129, device=cuda),
                               torch.zeros(1, 129, device=cuda))


def test_fused_solve_xla_route_matches_plain(cuda, bench):
    """The xla route (ops/ipm_fused on K5a + K5c) against the same route on
    the plain versions: K5 is bit-exact, so z and conv are equal."""
    sc, kw = bench
    args = (sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w)
    common = dict(family="fmincon", sqp_iters=2, ipm_iters=(16, 8),
                  alphas=((1.0,), (1.0, 0.5, 0.25)), device=cuda, **kw)
    sk = make_lbmpc_solver_fused(*args, **common)
    sp = make_lbmpc_solver_fused(*args, plain=True, **common)
    _, dx, win = _inputs(256, sc.nz, cuda, seed=3)
    z0 = torch.zeros(256, sc.nz, device=cuda)
    n0 = [k.launches for k in chol_kernel.KERNELS]
    zk, ck = sk(dx, win, z0)
    assert [k.launches - c for k, c in zip(chol_kernel.KERNELS, n0)] == [24, 0, 24]
    zp, cp = sp(dx, win, z0)
    assert torch.equal(zk, zp) and torch.equal(ck, cp)
    assert ck.float().mean().item() >= 0.99
