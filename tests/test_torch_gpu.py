"""PyTorch port on the card: K1 (gn_phase), K1w (gn_wide), K2 (mehrotra_h),
K2w (mehrotra_h_wide), K3 (gn_mehrotra), K3w (gn_mehrotra_wide), K4
(mehrotra), K5a/b/c (chol) and K6a/b (chol_blocked) against their plain
versions on the same CUDA tensors (K3 and K3w also against the two-launch
composition, bit for bit), the routes of the fused solve against their
plain routes, and identical lanes of a fleet staying identical. Marked `gpu`; without CUDA every test skips. On a machine with
an NVIDIA GPU and nvcc (no JAX needed):

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops import chol_kernel, gn_kernel, mono_kernel, qp_kernel
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.ops.lanes import lane_sum
from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
from lbmpc_tpu_torch.ops.qp_kernel import (QPSolver, QPSolverH, mehrotra_h,
                                           mehrotra_h_plain, mehrotra_plain, step_rhs)
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


def test_qp_kernel_matches_plain_at_16_iterations(cuda, bench):
    """K2 cold at 16 IPM iterations: a lane outside the K2 class has a QP
    that stalled (mu >= 1e-6) on one side (chip_smoke.qp_step_gates)."""
    sc, kw = bench
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    z, dx, win = _inputs(64, sc.nz, cuda, seed=5)
    _, H, g = gn(z, dx, win)
    G = torch.as_tensor(sc.qp.G, dtype=torch.float32, device=cuda)
    h = step_rhs(*(torch.as_tensor(a, dtype=torch.float32, device=cuda)
                   for a in (sc.qp.h0, sc.qp.Hp)), G, dx, z)
    x, mu, _ = mehrotra_h(G, H, g, h, 16)
    xp, mup, _ = mehrotra_h_plain(G, H, g, h, 16)
    dd = (x - xp).abs()
    assert dd.median().item() < 1e-6
    off = (dd.amax(dim=1) > 5e-2) | ((mu - mup).abs() > 1e-3)
    assert not bool((off & (mu < 1e-6) & (mup < 1e-6)).any())


@pytest.mark.parametrize("iters", [8, 16])
def test_mono_kernel_matches_plain_and_k1_k2(cuda, bench, iters):
    """K3 against its plain version with chip_smoke's gates, and against K1
    then K2 (cold) on the same inputs, which run the same device code: equal
    bit for bit."""
    sc, kw = bench
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    G, h0, Hp = t(sc.qp.G), t(sc.qp.h0), t(sc.qp.Hp)
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    mono = MonoPhase(gn, G, h0, Hp, iters)
    z, dx, win = _inputs(128, sc.nz, cuda, seed=4)
    n0 = mono_kernel.KERNEL.launches
    e, d, mu, g = mono(z, dx, win)
    assert mono_kernel.KERNEL.launches == n0 + 1
    ep, dp, mup, gp = mono.plain(z, dx, win)
    e1, H1, g1 = gn(z, dx, win)
    hmax = H1.abs().max().item()              # the K1 class
    assert (e - ep).abs().max().item() <= 1e-5 * hmax
    assert (g - gp).abs().max().item() <= 1e-5 * hmax
    dd = (d - dp).abs()
    assert dd.median().item() < 1e-6
    # a lane outside the K2 class has a QP that stalled (mu >= 1e-6) on one
    # side: float32 Mehrotra chaos after ~12 iterations, not a fault
    off = (dd.amax(dim=1) > 5e-2) | ((mu - mup).abs() > 1e-3)
    assert not bool((off & (mu < 1e-6) & (mup < 1e-6)).any())
    if iters == 8:
        assert not bool(off.any())
    x2, mu2, _ = mehrotra_h(G, H1, g1, step_rhs(h0, Hp, G, dx, z), iters)
    assert torch.equal(e, e1) and torch.equal(g, g1)
    assert torch.equal(d, x2) and torch.equal(mu, mu2)


def test_shared_qp_kernel_matches_plain(cuda):
    """K4 on the N=20 LMPC QP (806 rows) against its plain version with
    chip_smoke's gates: K4 is as close to the float64 optimum (the plain
    version at 60 iterations) as the float32 plain version, and converges
    as often, within 5 % of the lanes here."""
    from lbmpc_tpu_torch.controllers.condensed import build_fmincon_lmpc
    from lbmpc_tpu_torch.models.mgcm import mgcm_dlti
    from lbmpc_tpu_torch.sets.terminal import get_cons
    from lbmpc_tpu_torch.synthesis import mat_ocp

    Ad, Bd, C, _ = mgcm_dlti()
    ocp = mat_ocp(Ad, Bd, C)
    cs = get_cons(x_min=[0.0, 1.1875, 0.1547, -20.0], x_max=[1.0, 2.1875, 2.1547, 20.0],
                  u_min=0.1547, u_max=2.1547, x_wp=[0.5, 1.6875, 1.1547, 0.0], u_wp=1.1547,
                  A=Ad, B=Bd, K=ocp.Ks, LAMBDA=ocp.LAMBDA, PSI=ocp.PSI,
                  LAMBDA_0=ocp.LAMBDA_0, PSI_0=ocp.PSI_0)
    qp = build_fmincon_lmpc(Ad, Bd, ocp.Ks, ocp.Q, ocp.R, ocp.P, ocp.T, ocp.LAMBDA,
                            ocp.PSI, cs, 20)
    rng = np.random.default_rng(1)          # tests/test_pallas_ipm.py's lanes
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((128, 4))
    g, h = (qp.Gg @ dxs.T).T + qp.g0, qp.h0 + (qp.Hp @ dxs.T).T
    n0 = qp_kernel.KERNEL_SHARED.launches
    k4 = QPSolver(qp.H, qp.G, iters=20, device=cuda)
    x, conv = k4.solve(g, h)
    assert qp_kernel.KERNEL_SHARED.launches == n0 + 1
    xp, cp = QPSolver(qp.H, qp.G, iters=20, device=cuda, plain=True).solve(g, h)
    assert (x - xp).abs().median().item() < 1e-6
    x64 = mehrotra_plain(k4.G.double(), k4.H.double(), k4.G.new_tensor(g).double(),
                         k4.G.new_tensor(h).double(), 60)[0]
    far, far_p = (int((~((a.double() - x64).abs().amax(dim=1) <= 5e-2)).sum()) for a in (x, xp))
    assert far <= far_p + 0.05 * len(g)
    assert conv.float().mean().item() >= cp.float().mean().item() - 0.05


def test_fused_solve_mono_and_pallas_routes(cuda, bench):
    """pallas_mono: 2 K3 launches a solve and the same z as pallas_full
    without qp_warm (same device code, same QP rhs); pallas: 2 K2 launches
    and no K1."""
    sc, kw = bench
    args = (sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w)
    common = dict(family="fmincon", sqp_iters=2, ipm_iters=(16, 8),
                  alphas=((1.0,), (1.0, 0.5, 0.25)), device=cuda, **kw)
    _, dx, win = _inputs(256, sc.nz, cuda, seed=7)
    z0 = torch.zeros(256, sc.nz, device=cuda)
    counts = lambda: (gn_kernel.KERNEL.launches, qp_kernel.KERNEL.launches,
                      mono_kernel.KERNEL.launches)
    n0 = counts()
    zm, cm = make_lbmpc_solver_fused(*args, qp_kernel="pallas_mono", **common)(dx, win, z0)
    assert [b - a for a, b in zip(n0, counts())] == [0, 0, 2]
    zf, cf = make_lbmpc_solver_fused(*args, qp_kernel="pallas_full", **common)(dx, win, z0)
    assert torch.equal(zm, zf) and torch.equal(cm, cf)
    n0 = counts()
    zk, ck = make_lbmpc_solver_fused(*args, qp_kernel="pallas", **common)(dx, win, z0)
    assert [b - a for a, b in zip(n0, counts())] == [0, 2, 0]
    d = (zk - zf).abs()
    assert d.median().item() < 1e-6 and d[:, 0].max().item() < 5e-2
    assert ck.float().mean().item() >= 0.99 and cm.float().mean().item() >= 0.99


@pytest.fixture(scope="module")
def wide(cuda):
    """The two wide shapes: the DMS flagship (casadi, N=100, nz=101, G (1024,
    101)) and LBMPC_N40 uncut (fmincon, N=40, nz=41, G (414, 41)), q=100."""
    out = {}
    for name, family in (("DMS_LBMPC_q100", "casadi"), ("LBMPC_N40", "fmincon")):
        cfg = lt.make_preset(name)
        sc = build_scenario(cfg)
        assert cfg.oracle.q == Q
        out[family] = (sc, dict(family=family, delta=cfg.plant.ts,
                                bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                                dx_ref=np.asarray(cfg.dx_ref)))
    return out


@pytest.mark.parametrize("n, B", [(25, 64), (41, 300), (101, 40), (128, 3)])
def test_chol_blocked_kernels_equal_k5(cuda, n, B):
    """K6a equals K5a (L and x) and K6b equals K5b bit for bit: the
    slab-blocked factorization subtracts each entry's terms in K5's order,
    each operation rounded on its own; K5c resolves K6a's L as it is."""
    rng = np.random.default_rng(100 + n)
    A = rng.standard_normal((B, n, n))
    M = torch.tensor(A @ np.swapaxes(A, 1, 2) + n * np.eye(n), dtype=torch.float32,
                     device=cuda)
    b = torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32, device=cuda)
    n0 = [k.launches for k in chol_kernel.BLOCKED_KERNELS]
    Lb, xb = chol_kernel.chol_factor_solve_blocked(M, b)
    xsb = chol_kernel.chol_solve_blocked(M, b)
    assert [k.launches - c for k, c in zip(chol_kernel.BLOCKED_KERNELS, n0)] == [1, 1]
    L, x = chol_kernel.chol_factor_solve(M, b)
    xs = chol_kernel.chol_solve(M, b)
    torch.cuda.synchronize()
    assert torch.equal(Lb, L) and torch.equal(xb, x) and torch.equal(xsb, xs)
    assert torch.equal(chol_kernel.chol_resolve(Lb, 2.0 * b), chol_kernel.chol_resolve(L, 2.0 * b))
    Lp, xp = chol_kernel.chol_factor_solve_blocked(M, b, plain=True)
    assert torch.equal(Lb, Lp) and torch.equal(xb, xp)


def _spd_on(cuda, n, B, seed):
    """Seeded SPD systems, equilibrated as the IPM's are (unit diagonal)."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    A = torch.randn(B, n, n, device=cuda, generator=gen)
    M = A @ A.transpose(1, 2) + n * torch.eye(n, device=cuda)
    dg = torch.rsqrt(torch.diagonal(M, dim1=1, dim2=2))
    return ((M * dg[:, :, None] * dg[:, None, :]).contiguous(),
            torch.randn(B, n, device=cuda, generator=gen))


def _bits(a, b):
    """Bit for bit, a NaN equal to a NaN in the same place."""
    return a.shape == b.shape and bool(((a == b) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("B", [1, 3, 40, 1024])
@pytest.mark.parametrize("n", [25, 32, 33, 41, 64, 65, 101, 127, 128])
def test_chol_blocked_kernels_equal_k5_and_plain_over_the_domain(cuda, n, B):
    """K6a equals K5a and the plain version (L and x) and K6b equals K5b bit
    for bit over the switch's domain (n_p >= 32: n 25..128) at one lane, a
    ragged few and full batches, one launch a call at the host's shape."""
    M, b = _spd_on(cuda, n, B, 7 * n + B)
    n0 = [k.launches for k in chol_kernel.BLOCKED_KERNELS]
    Lb, xb = chol_kernel.chol_factor_solve_blocked(M, b)
    xsb = chol_kernel.chol_solve_blocked(M, b)
    assert [k.launches - c for k, c in zip(chol_kernel.BLOCKED_KERNELS, n0)] == [1, 1]
    L, x = chol_kernel.chol_factor_solve(M, b)
    xs = chol_kernel.chol_solve(M, b)
    Lp, xp = chol_kernel.chol_factor_solve(M, b, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(Lb, L) and torch.equal(xb, x) and torch.equal(xsb, xs)
    assert torch.equal(Lb, Lp) and torch.equal(xb, xp)
    assert torch.equal(torch.triu(Lb, diagonal=1), torch.zeros_like(Lb))


@pytest.mark.parametrize("n", [33, 101])
def test_chol_blocked_kernels_give_a_lane_the_same_bits_anywhere(cuda, n):
    """A lane's L and x do not depend on where it sits in the batch, on how
    many lanes share its block, or on B: lane 0's system alone, and placed
    at lanes 1, 5, 31 and B - 1 of B = 40 and 1024."""
    M0, b0 = _spd_on(cuda, n, 1, 3 * n)
    L1, x1 = chol_kernel.chol_factor_solve_blocked(M0, b0)
    xs1 = chol_kernel.chol_solve_blocked(M0, b0)
    for B in (40, 1024):
        M, b = _spd_on(cuda, n, B, 5 * n + B)
        at = [1, 5, 31, B - 1]
        M[at], b[at] = M0[0], b0[0]
        L, x = chol_kernel.chol_factor_solve_blocked(M, b)
        xs = chol_kernel.chol_solve_blocked(M, b)
        torch.cuda.synchronize()
        for i in at:
            assert torch.equal(L[i], L1[0]) and torch.equal(x[i], x1[0])
            assert torch.equal(xs[i], xs1[0])


@pytest.mark.parametrize("n", [25, 41, 101, 128])
def test_chol_blocked_kernels_keep_a_nan_lane_and_a_floored_lane(cuda, n):
    """A NaN below the diagonal of lane 2 and a lane (5) whose pivots all hit
    the floor: K6 matches K5 and the plain version lane by lane (NaN where
    they have NaN), and every other lane keeps its bits from the batch
    without them."""
    M, b = _spd_on(cuda, n, 8, 11 * n)
    L0, x0 = chol_kernel.chol_factor_solve_blocked(M, b)
    M[2, n - 1, n // 2] = float("nan")
    M[5] = -M[5]
    Lb, xb = chol_kernel.chol_factor_solve_blocked(M, b)
    xsb = chol_kernel.chol_solve_blocked(M, b)
    L, x = chol_kernel.chol_factor_solve(M, b)
    xs = chol_kernel.chol_solve(M, b)
    Lp, xp = chol_kernel.chol_factor_solve(M, b, plain=True)
    torch.cuda.synchronize()
    assert _bits(Lb, L) and _bits(xb, x) and _bits(xsb, xs)
    assert _bits(Lb, Lp) and _bits(xb, xp)
    assert bool(torch.isnan(xb[2]).any())
    keep = [i for i in range(8) if i not in (2, 5)]
    assert torch.equal(Lb[keep], L0[keep]) and torch.equal(xb[keep], x0[keep])


def test_chol_blocked_shared_memory_is_the_hosts(cuda):
    """The block's shared memory that chol_kernel.blocked_launch sizes the
    launch by is the one K6 carves, for every shape it takes (-1 where it
    takes none), and the lanes an SM hold at least one block of the
    host's shape."""
    import ctypes

    from lbmpc_tpu_torch.ops.chol_kernel import (BLOCKED_MAX_LANES, BLOCKED_MAX_THREADS,
                                                 blocked_launch, blocked_smem_bytes)

    k = chol_kernel.FACTOR_SOLVE_BLOCKED
    k.fn()
    lib = ctypes.CDLL(str(k.library_path()))
    smem, res = lib.chol_blocked_smem_bytes, lib.chol_blocked_resident_lanes
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_longlong
    res.argtypes, res.restype = [ctypes.c_int] * 4, ctypes.c_int
    for n in range(1, 129):
        for warps in (1, 2, 4, 8):
            for lanes in range(1, 10):
                ok = lanes <= BLOCKED_MAX_LANES and warps * lanes * 32 <= BLOCKED_MAX_THREADS
                assert smem(n, warps, lanes) == (blocked_smem_bytes(n, lanes) if ok else -1)
        for B in (1, 1024):
            warps, lanes = blocked_launch(n, B)[:2]
            assert res(0, n, warps, lanes) >= lanes and res(1, n, warps, lanes) >= lanes


@pytest.mark.parametrize("family", ["casadi", "fmincon"])
def test_gn_wide_kernel_matches_plain(cuda, wide, family):
    """K1w at the DMS and N40 shapes: e, H, g within 1e-5 max|H| of the
    plain version (the K1 class), H exactly symmetric, and one launch of
    K1w and none of K1."""
    sc, kw = wide[family]
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    assert gn.wide and not gn.narrow
    z, dx, win = _inputs(64, sc.nz, cuda, seed=11)
    n0 = (gn_kernel.KERNEL.launches, gn_kernel.KERNEL_WIDE.launches)
    e, H, g = gn(z, dx, win)
    assert (gn_kernel.KERNEL.launches - n0[0], gn_kernel.KERNEL_WIDE.launches - n0[1]) == (0, 1)
    e_p, H_p, g_p = gn.plain(z, dx, win)
    torch.cuda.synchronize()
    hmax = H_p.abs().max().item()
    for a, b in ((e, e_p), (H, H_p), (g, g_p)):
        assert (a - b).abs().max().item() <= 1e-5 * hmax
    assert torch.equal(H, H.transpose(1, 2))


def _as_close(ref, a, b, slack: int = 1):
    """a is as close to the anchor `ref` as b: median |a - ref| at most 1.5
    times b's (+1e-8), and at most `slack` more lanes beyond 5e-2 of it."""
    ea, eb = ((x.double() - ref.double()).abs() for x in (a, b))
    far = lambda e: int((~(e.amax(dim=1) <= 5e-2)).sum())
    assert ea.median().item() <= 1.5 * eb.median().item() + 1e-8, (
        ea.median().item(), eb.median().item())
    assert far(ea) <= far(eb) + slack, (far(ea), far(eb))


def _wide_qp(cuda, family: str, nz: int, B: int, seed: int):
    """A QP above nz 32 from K1w's H and g on seeded inputs: LBMPC_N40 /
    the DMS preset at N = nz - 1 (nz = 41 and 101 are the presets as they
    ship), G cut to its first 1024 rows where the stack is longer (the
    kernels' limit). Returns (G, H, g, h)."""
    name = "LBMPC_N40" if family == "fmincon" else "DMS_LBMPC_q100"
    cfg = lt.make_preset(name)
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=nz - 1))
    sc = build_scenario(cfg)
    kw = dict(family=family, delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    z, dx, win = _inputs(B, nz, cuda, seed=seed)
    _, H, g = gn(z, dx, win)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)[:1024], device=cuda)
    G = t(sc.qp.G)
    return G, H, g, step_rhs(t(sc.qp.h0), t(sc.qp.Hp), G, dx, z)


@pytest.mark.parametrize("family, nz", [("fmincon", 33), ("fmincon", 41), ("fmincon", 64),
                                        ("casadi", 41), ("casadi", 101), ("casadi", 128)])
def test_qp_wide_kernel_matches_plain(cuda, family, nz):
    """K2w on the QP built from K1w's H and g, cold at 8 iterations and warm
    for 2 from K2w's state, at nz 33 to 128: one K2w launch a solve and no
    K2; cold_state reproduces the cold start bit for bit. The fmincon cold
    solves hold the K2 class. Where that class cannot hold — the casadi QPs,
    whose float32 plain version is itself ~1e-6 from the float64 solve in
    the median, and the 2-iteration warm solves, which start where d = z/s
    reaches the 1e6 cap — K2w is held to the plain version in float64
    (chip_smoke.f64_gates)."""
    G, H, g, h = _wide_qp(cuda, family, nz, 96, seed=12)
    f64 = lambda it, warm=None: mehrotra_h_plain(
        G.double(), H.double(), g.double(), h.double(), it,
        warm=None if warm is None else tuple(a.double() for a in warm))[0]
    n0 = (qp_kernel.KERNEL.launches, qp_kernel.KERNEL_WIDE.launches)
    x, mu, st = mehrotra_h(G, H, g, h, 8, want_state=True)
    assert (qp_kernel.KERNEL.launches - n0[0], qp_kernel.KERNEL_WIDE.launches - n0[1]) == (0, 1)
    xp, mup, _ = mehrotra_h_plain(G, H, g, h, 8)
    assert bool(x.isfinite().all()) and bool(mu.isfinite().all())
    if family == "fmincon":
        d = (x - xp).abs()
        assert d.median().item() < 1e-6 and d.max().item() < 5e-2
        assert (mu - mup).abs().max().item() < 1e-3
    else:
        _as_close(f64(8), x, xp)
    xw, _, _ = mehrotra_h(G, H, g, h, 2, warm=st)
    xwp, _, _ = mehrotra_h_plain(G, H, g, h, 2, warm=st)
    _as_close(f64(2, st), xw, xwp)
    xc, muc, stc = mehrotra_h(G, H, g, h, 8, warm=QPSolverH.cold_state(h), want_state=True)
    assert torch.equal(xc, x) and torch.equal(muc, mu) and torch.equal(stc[1], st[1])


@pytest.mark.parametrize("family, nz", [("fmincon", 41), ("casadi", 101)])
def test_qp_wide_kernel_keeps_a_nan_lane(cuda, family, nz):
    """A lane whose g or h holds a NaN ends with NaN in x and mu, though
    the plan skips G's structural zeros; the other lanes are bit for bit
    what they are without it (lanes are independent)."""
    G, H, g, h = _wide_qp(cuda, family, nz, 16, seed=14)
    x0, mu0, _ = mehrotra_h(G, H, g, h, 8)
    g1, h1 = g.clone(), h.clone()
    g1[3, 0] = float("nan")
    h1[7, G.shape[0] // 2] = float("nan")
    x1, mu1, _ = mehrotra_h(G, H, g1, h1, 8)
    for lane in (3, 7):
        assert bool(torch.isnan(mu1[lane])) and bool(torch.isnan(x1[lane]).any())
    keep = [i for i in range(16) if i not in (3, 7)]
    assert torch.equal(x1[keep], x0[keep]) and torch.equal(mu1[keep], mu0[keep])


@pytest.mark.parametrize("route", ["pallas_mono", "xla"])
def test_identical_lanes_stay_identical(cuda, route):
    """Identical lanes give identical results: 8 copies of dx_init through
    the float32 hybrid at LBMPC_N50 (on pallas_mono: chip_smoke.py phase
    29's fleet, every flagged lane repaired on the vmapped backend; and on
    the default xla route), 40 steps. The port's ops/ipm (and ops/ipm_fused)
    summed mu over mI = 514 entries with a CUDA reduction whose order
    depends on each row's address (ops/lanes.lane_sum), which parted the
    lanes from step 0 and their trajectories from step 31."""
    from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode

    cfg = lt.make_preset("LBMPC_N50", iterations=40)
    _, run = build_fleet_episode(cfg, backend="hybrid", qp_kernel=route,
                                 ipm_iters=(16, 8), sqp_iters=2, repair_frac=1.0, device=cuda)
    res = run(np.broadcast_to(np.asarray(cfg.dx_init), (8, 4)).copy())
    for a in (res.sys_history, res.art_history, res.solver_converged, res.final_z):
        assert torch.equal(a, a[:1].expand_as(a))
    v = torch.randn(1, 514, device=cuda).expand(8, 514).contiguous()
    s = lane_sum(v)
    assert torch.equal(s, s[:1].expand_as(s))


def test_fused_solve_wide_routes(cuda, wide):
    """The DMS flagship on pallas_full (2 K1w + 2 K2w a solve) and pallas
    (2 K2w, no GN kernel); no narrow kernel runs. Each kernel route is as
    close to the xla route (K5, an independent implementation of the QP) as
    its plain route is, its applied control c_0 within 5e-2 of the plain
    route's, and conv within 5 % of the lanes here."""
    sc, kw = wide["casadi"]
    args = (sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w)
    common = dict(sqp_iters=2, ipm_iters=(16, 8), alphas=((1.0,), (1.0, 0.5, 0.25)),
                  device=cuda, **kw)
    _, dx, win = _inputs(128, sc.nz, cuda, seed=13)
    dx = dx + torch.as_tensor(np.asarray(sc.cfg.x_init_abs) - np.asarray(sc.cfg.plant.x_wp)
                              - np.array([-0.35, -0.4, 0, 0]), dtype=torch.float32,
                              device=cuda)
    z0 = torch.zeros(128, sc.nz, device=cuda)
    zx, _ = make_lbmpc_solver_fused(*args, qp_kernel="xla", **common)(dx, win, z0)
    ks = (gn_kernel.KERNEL, gn_kernel.KERNEL_WIDE, qp_kernel.KERNEL, qp_kernel.KERNEL_WIDE)
    for route, want in (("pallas_full", [0, 2, 0, 2]), ("pallas", [0, 0, 0, 2])):
        n0 = [k.launches for k in ks]
        zk, ck = make_lbmpc_solver_fused(*args, qp_kernel=route, **common)(dx, win, z0)
        assert [k.launches - c for k, c in zip(ks, n0)] == want
        zp, cp = make_lbmpc_solver_fused(*args, qp_kernel=route, plain=True,
                                         **common)(dx, win, z0)
        assert bool(zk.isfinite().all())
        _as_close(zx, zk, zp, slack=2)
        assert (zk - zp)[:, 0].abs().max().item() < 5e-2
        assert abs(ck.float().mean().item() - cp.float().mean().item()) <= 0.05


@pytest.mark.parametrize("family", ["fmincon", "casadi"])
@pytest.mark.parametrize("nz", [33, 41, 64, 128])
def test_mono_wide_kernel_equals_k1w_k2w(cuda, family, nz):
    """K3w (gn_mehrotra_wide) against K1w -> step_rhs -> K2w cold on the same
    inputs, which run the same device code built the same way: e, g, d and
    mu equal bit for bit, at 16 Mehrotra iterations; e and g within the K1w
    class of the plain version. LBMPC_N40 / the DMS preset at N = nz - 1,
    q=100; where the constraint stack exceeds the kernels' 1024 rows (nz=128
    in both families) the kernel is held on its first 1024 rows."""
    name = "LBMPC_N40" if family == "fmincon" else "DMS_LBMPC_q100"
    cfg = lt.make_preset(name)
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=nz - 1))
    sc = build_scenario(cfg)
    kw = dict(family=family, delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32)[:1024], device=cuda)
    G, h0, Hp = t(sc.qp.G), t(sc.qp.h0), t(sc.qp.Hp)
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    mono = MonoPhase(gn, G, h0, Hp, 16)
    assert mono.wide and not mono.narrow
    z, dx, win = _inputs(96, nz, cuda, seed=21)
    n0 = mono_kernel.KERNEL_WIDE.launches
    e, d, mu, g = mono(z, dx, win)
    assert mono_kernel.KERNEL_WIDE.launches == n0 + 1
    e1, H1, g1 = gn(z, dx, win)
    x2, mu2, _ = mehrotra_h(G, H1, g1, step_rhs(h0, Hp, G, dx, z), 16)
    assert torch.equal(e, e1) and torch.equal(g, g1)
    assert torch.equal(d, x2) and torch.equal(mu, mu2)
    ep, _, _, gp = mono.plain(z, dx, win)
    hmax = H1.abs().max().item()
    assert (e - ep).abs().max().item() <= 1e-5 * hmax
    assert (g - gp).abs().max().item() <= 1e-5 * hmax
    assert bool(d.isfinite().all())


def _bench_qp(cuda, bench, B, seed):
    """The bench QP (nz=21, G (214, 21)) at batch B: H and g from K1, h in
    step_rhs's order; with the GN inputs (z, dx, window)."""
    sc, kw = bench
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    G, h0, Hp = t(sc.qp.G), t(sc.qp.h0), t(sc.qp.Hp)
    z, dx, win = _inputs(B, sc.nz, cuda, seed=seed)
    _, H, g = gn(z, dx, win)
    return gn, G, h0, Hp, H, g, step_rhs(h0, Hp, G, dx, z), (z, dx, win)


def _place(a, src: int, at):
    """a copy of a with lane src's entry copied to the lanes `at`."""
    a = a.clone()
    a[list(at)] = a[src].clone()
    return a


def _window_at(win, src: int, at):
    return DataWindow(*(_place(v, src, at) for v in (win.X, win.Y, win.valid, win.count)))


@pytest.mark.parametrize("B", [1, 24, 300, 2048])
def test_narrow_kernels_give_a_lane_the_same_bits_anywhere(cuda, bench, B):
    """K2 (8 cold, 2 warm) and K3 (16, 8) run a lane on one warp, several
    lanes a block: one QP placed at every position of a batch of real QPs
    (lanes 0, 1, 7, 31, 32, B - 1), and the same QP alone at B = 1, give
    the same x, mu, s and z (K3: e, d, mu, g) bit for bit, whatever B."""
    gn, G, h0, Hp, H, g, h, (z, dx, win) = _bench_qp(cuda, bench, 2048, seed=31)
    src = 5
    at = sorted({0, 1, 7, 31, 32, B - 1} & set(range(B)))
    Hb, gb, hb = (_place(a[:B], src, at) if B > 1 else a[src:src + 1].contiguous()
                  for a in (H, g, h))
    x, mu, st = mehrotra_h(G, Hb, gb, hb, 8, want_state=True)
    xw, muw, stw = mehrotra_h(G, Hb, gb, hb, 2, warm=st, want_state=True)
    x1, mu1, st1 = mehrotra_h(G, H[src:src + 1].contiguous(), g[src:src + 1].contiguous(),
                              h[src:src + 1].contiguous(), 8, want_state=True)
    xw1, muw1, _ = mehrotra_h(G, H[src:src + 1].contiguous(), g[src:src + 1].contiguous(),
                              h[src:src + 1].contiguous(), 2, warm=st1)
    for a, a1 in ((x, x1), (mu, mu1), (st[0], st1[0]), (st[1], st1[1]), (xw, xw1),
                  (muw, muw1)):
        assert torch.equal(a[at], a1.expand_as(a[at]))
    if B > 1:
        zi, dxi, wini = _place(z[:B], src, at), _place(dx[:B], src, at), _window_at(
            win.index(torch.arange(B, device=cuda)), src, at)
    else:
        zi, dxi = z[src:src + 1].contiguous(), dx[src:src + 1].contiguous()
        wini = win.index(torch.tensor([src], device=cuda))
    one = win.index(torch.tensor([src], device=cuda))
    for it in (16, 8):
        mono = MonoPhase(gn, G, h0, Hp, it)
        outs = mono(zi, dxi, wini)
        outs1 = mono(z[src:src + 1].contiguous(), dx[src:src + 1].contiguous(), one)
        for a, a1 in zip(outs, outs1):
            assert torch.equal(a[at], a1.expand_as(a[at]))


def test_narrow_kernels_keep_a_nan_lane(cuda, bench):
    """A lane whose g or h holds a NaN ends with NaN in x and mu (K2), and a
    lane whose dx0 holds one with NaN in d and mu (K3); the other lanes,
    its block neighbours among them (1056 lanes: 8 a block), are bit for
    bit what they are without it."""
    B = 1056
    gn, G, h0, Hp, H, g, h, (z, dx, win) = _bench_qp(cuda, bench, B, seed=32)
    x0, mu0, st0 = mehrotra_h(G, H, g, h, 8, want_state=True)
    g1, h1 = g.clone(), h.clone()
    g1[3, 0] = float("nan")
    h1[9, 100] = float("nan")
    x1, mu1, st1 = mehrotra_h(G, H, g1, h1, 8, want_state=True)
    for lane in (3, 9):
        assert bool(torch.isnan(mu1[lane])) and bool(torch.isnan(x1[lane]).any())
    keep = [i for i in range(B) if i not in (3, 9)]
    for a, b in ((x1, x0), (mu1, mu0), (st1[0], st0[0]), (st1[1], st0[1])):
        assert torch.equal(a[keep], b[keep])
    mono = MonoPhase(gn, G, h0, Hp, 16)
    e0, d0, m0, gg0 = mono(z, dx, win)
    dx1 = dx.clone()
    dx1[5, 1] = float("nan")
    e1, d1, m1, gg1 = mono(z, dx1, win)
    assert bool(torch.isnan(m1[5])) and bool(torch.isnan(d1[5]).any())
    keep = [i for i in range(B) if i != 5]
    for a, b in ((e1, e0), (d1, d0), (m1, m0), (gg1, gg0)):
        assert torch.equal(a[keep], b[keep])


def _random_qp(cuda, mI, nz, B, seed):
    """A strictly feasible random QP batch: G (mI, nz) standard normal over
    sqrt(nz), h in [1, 2] (x = 0 inside), H_b = diag in [1, 2] + a small
    rank-one term, g normal with deviation 0.7 (a few constraints active at
    the optimum of each lane at mI 214 and above)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda).contiguous()
    u = rng.standard_normal((B, nz, 1)) / np.sqrt(nz)
    H = np.eye(nz)[None] * rng.uniform(1.0, 2.0, (B, nz, 1)) + 0.1 * u @ u.transpose(0, 2, 1)
    return (t(rng.standard_normal((mI, nz)) / np.sqrt(nz)), t(H),
            t(0.7 * rng.standard_normal((B, nz))), t(rng.uniform(1.0, 2.0, (B, mI))))


@pytest.mark.parametrize("mI, nz", [(1, 1), (214, 1), (1, 2), (214, 2), (1, 32), (214, 32),
                                    (806, 21), (806, 32), (1024, 1), (1024, 32)])
def test_narrow_kernel_at_the_domain_edges(cuda, mI, nz):
    """K2 at the edges of its domain (nz 1, 2, 32: padded widths 8 and 32;
    mI 1, 806, 1024: the row state in registers and in shared memory)
    against its plain version on random strictly feasible QPs, with
    phase 3's gates at 8 cold iterations: the K2 class (|dx| median < 1e-6,
    max < 5e-2, |dmu| < 1e-3) on every lane that did not stall (mu >= 1e-6)
    on either side, and the stalled shares within 2 pp; cold_state
    reproduces the cold start. (Past convergence, at 16 iterations, these
    QPs' float32 mu drifts back above 1e-6 on a few lanes of either
    computation at random; 96 lanes cannot hold that share to 2 pp.)"""
    G, H, g, h = _random_qp(cuda, mI, nz, 96, seed=mI * 100 + nz)
    x, mu, st = mehrotra_h(G, H, g, h, 8, want_state=True)
    xp, mup, _ = mehrotra_h_plain(G, H, g, h, 8)
    for a, b, ma, mb in ((x, xp, mu, mup),):
        assert bool(a.isfinite().all()) and bool(ma.isfinite().all())
        dd = (a - b).abs()
        assert dd.median().item() < 1e-6
        off = (dd.amax(dim=1) > 5e-2) | ((ma - mb).abs() > 1e-3)
        assert not bool((off & (ma < 1e-6) & (mb < 1e-6)).any())
        sk, sp = ((~(m < 1e-6)).float().mean().item() for m in (ma, mb))
        assert abs(sk - sp) <= 0.02
    xc, muc, _ = mehrotra_h(G, H, g, h, 8, warm=QPSolverH.cold_state(h))
    assert torch.equal(xc, x) and torch.equal(muc, mu)


def test_narrow_shared_memory_is_the_hosts(cuda):
    """The block's shared memory that ops/qp_kernel.narrow_launch sizes the
    launch by is the one K2 and K3 carve (csrc/mehrotra_warp.cuh), over the
    domain's edges, for every lane count."""
    import ctypes

    from lbmpc_tpu_torch.ops.qp_kernel import narrow_smem_bytes

    for k, qs in ((qp_kernel.KERNEL, (0,)), (mono_kernel.KERNEL, (1, 100, 500))):
        k.fn()
        fn = getattr(ctypes.CDLL(str(k.library_path())), f"{k.source.stem}_smem_bytes")
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
        for mI in (1, 7, 214, 256, 257, 806, 1024):
            for nz in (1, 2, 8, 9, 21, 24, 25, 32):
                for q in qs:
                    for warps in range(1, 9):
                        assert fn(mI, nz, q, warps) == narrow_smem_bytes(mI, nz, warps, q)


# ---- K1w and K5 on a warp a lane (the launch shape from the host) -----------

def _gn_at(cuda, family: str, nz: int):
    """GNPhase for LBMPC_N40 / the DMS preset at N = nz - 1, q=100."""
    cfg = lt.make_preset("LBMPC_N40" if family == "fmincon" else "DMS_LBMPC_q100")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=nz - 1))
    sc = build_scenario(cfg)
    return GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family=family, delta=cfg.plant.ts,
                   bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                   dx_ref=np.asarray(cfg.dx_ref), device=cuda)


@pytest.mark.parametrize("family", ["fmincon", "casadi"])
@pytest.mark.parametrize("nz", [33, 41, 64, 65, 101, 128])
def test_gn_wide_kernel_matches_plain_over_widths(cuda, family, nz):
    """K1w at every template width (nz 33-64: two columns a lane, 65-96:
    three, 97-128: four) in both families: e, H, g within phase 19's bound
    of the plain version (1e-5 max|H|), H exactly symmetric, one launch."""
    gn = _gn_at(cuda, family, nz)
    assert gn.wide
    z, dx, win = _inputs(64, nz, cuda, seed=nz)
    n0 = gn_kernel.KERNEL_WIDE.launches
    e, H, g = gn(z, dx, win)
    assert gn_kernel.KERNEL_WIDE.launches == n0 + 1
    e_p, H_p, g_p = gn.plain(z, dx, win)
    torch.cuda.synchronize()
    hmax = H_p.abs().max().item()
    for a, b in ((e, e_p), (H, H_p), (g, g_p)):
        assert bool(a.isfinite().all()) and (a - b).abs().max().item() <= 1e-5 * hmax
    assert torch.equal(H, H.transpose(1, 2))


@pytest.mark.parametrize("family", ["fmincon", "casadi"])
@pytest.mark.parametrize("B", [1, 24, 300, 2048])
def test_gn_wide_kernel_gives_a_lane_the_same_bits_anywhere(cuda, wide, family, B):
    """K1w runs a lane on one warp, 1 to 8 lanes a block: one lane's inputs
    placed at lanes 0, 1, 31, 32 and B - 1 of a batch of other lanes, and
    alone at B = 1, give the same e, H and g bit for bit, whatever B."""
    sc, kw = wide[family]
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    z, dx, win = _inputs(2048, sc.nz, cuda, seed=41)
    src = 5
    at = sorted({0, 1, 31, 32, B - 1} & set(range(B)))
    one = gn(z[src:src + 1].contiguous(), dx[src:src + 1].contiguous(),
             win.index(torch.tensor([src], device=cuda)))
    if B > 1:
        zi, dxi = _place(z[:B], src, at), _place(dx[:B], src, at)
        wini = _window_at(win.index(torch.arange(B, device=cuda)), src, at)
        outs = gn(zi, dxi, wini)
        for a, a1 in zip(outs, one):
            assert torch.equal(a[at], a1.expand_as(a[at]))


def test_gn_wide_kernel_keeps_a_nan_lane(cuda, wide):
    """A lane whose dx0 holds a NaN ends with NaN in e, H and g; the other
    lanes, its block neighbours among them (1056 lanes: 8 a block), are
    bit for bit what they are without it."""
    sc, kw = wide["fmincon"]
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    B = 1056
    z, dx, win = _inputs(B, sc.nz, cuda, seed=42)
    e0, H0, g0 = gn(z, dx, win)
    dx1 = dx.clone()
    dx1[5, 1] = float("nan")
    e1, H1, g1 = gn(z, dx1, win)
    assert all(bool(torch.isnan(a[5]).any()) for a in (e1, H1, g1))
    keep = [i for i in range(B) if i != 5]
    for a, b in ((e1, e0), (H1, H0), (g1, g0)):
        assert torch.equal(a[keep], b[keep])


@pytest.mark.parametrize("B", [1, 24, 8192])
@pytest.mark.parametrize("n", [1, 8, 9, 21, 32, 33, 64, 101, 128])
def test_chol_kernels_equal_plain_over_n(cuda, n, B):
    """K5a, K5b and K5c bit for bit equal to their plain version at the
    edges of the warp form's widths (n 1, 8, 9, 32), the bench's n = 21,
    the block form (n 33-128) and the batches of one lane, the repair's 24
    and the fleet's 8192 (8 lanes a block); L lower with zeros above."""
    gen = torch.Generator(device=cuda).manual_seed(1000 * n + B)
    A = torch.randn(B, n, n, device=cuda, generator=gen)
    M = (A @ A.transpose(1, 2) / n + torch.eye(n, device=cuda)).contiguous()
    b = torch.randn(B, n, device=cuda, generator=gen)
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


def test_wide_and_chol_shared_memory_is_the_hosts(cuda):
    """The block's shared memory that gn_kernel.wide_launch and
    chol_kernel.chol_launch size the launch by is the one K1w and K5 carve,
    for every lane count they take."""
    import ctypes

    from lbmpc_tpu_torch.ops.chol_kernel import chol_smem_bytes
    from lbmpc_tpu_torch.ops.gn_kernel import wide_smem_bytes

    def c_fn(k, name, nargs):
        k.fn()
        fn = getattr(ctypes.CDLL(str(k.library_path())), name)
        fn.argtypes = [ctypes.c_int] * nargs
        fn.restype = ctypes.c_longlong
        return fn

    gw = c_fn(gn_kernel.KERNEL_WIDE, "gn_wide_smem_bytes", 3)
    for nz in (2, 32, 33, 41, 64, 65, 101, 128):
        for q in (1, 7, 100, 1000):
            for lanes in range(1, 9):
                assert gw(nz, q, lanes) == wide_smem_bytes(nz, q, lanes)
    ch = c_fn(chol_kernel.FACTOR_SOLVE, "chol_smem_bytes", 2)
    for n in range(1, 129):
        for lanes in range(1, 9):
            want = chol_smem_bytes(n, lanes) if (n <= 32 or lanes == 1) else -1
            assert ch(n, lanes) == want


# ---- K1 on a warp a lane, K4 on four warps a lane (launch shapes from the host)

@pytest.mark.parametrize("B", [24, 2048, 8192])
def test_gn_kernel_gives_a_lane_the_same_bits_anywhere(cuda, bench, B):
    """K1 runs a lane on one warp, 1 to 8 lanes a block: one lane's inputs
    placed at lanes 0, 1, 7, 31, 32 and B - 1 of a batch of other bench
    lanes, and alone at B = 1, give the same e, H and g bit for bit."""
    sc, kw = bench
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    z, dx, win = _inputs(B, sc.nz, cuda, seed=51)
    src = 5
    at = sorted({0, 1, 7, 31, 32, B - 1} & set(range(B)))
    one = gn(z[src:src + 1].contiguous(), dx[src:src + 1].contiguous(),
             win.index(torch.tensor([src], device=cuda)))
    n0 = gn_kernel.KERNEL.launches
    outs = gn(_place(z, src, at), _place(dx, src, at), _window_at(win, src, at))
    assert gn_kernel.KERNEL.launches == n0 + 1
    for a, a1 in zip(outs, one):
        assert torch.equal(a[at], a1.expand_as(a[at]))
    assert torch.equal(outs[1], outs[1].transpose(1, 2))


def test_gn_kernel_keeps_a_nan_lane(cuda, bench):
    """A lane whose dx0 holds a NaN ends with NaN in e, H and g; the other
    lanes, its block neighbours among them (1056 lanes: 8 a block), are bit
    for bit what they are without it."""
    sc, kw = bench
    gn = GNPhase(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, device=cuda, **kw)
    B = 1056
    z, dx, win = _inputs(B, sc.nz, cuda, seed=52)
    e0, H0, g0 = gn(z, dx, win)
    dx1 = dx.clone()
    dx1[5, 1] = float("nan")
    e1, H1, g1 = gn(z, dx1, win)
    assert all(bool(torch.isnan(a[5]).any()) for a in (e1, H1, g1))
    keep = [i for i in range(B) if i != 5]
    for a, b in ((e1, e0), (H1, H0), (g1, g0)):
        assert torch.equal(a[keep], b[keep])


def _lmpc_lanes(cuda, B, seed):
    """The N=20 LMPC QP of test_shared_qp_kernel_matches_plain (G (806, 21))
    and B lanes of it around the bench operating point."""
    from lbmpc_tpu_torch.controllers.condensed import build_fmincon_lmpc
    from lbmpc_tpu_torch.models.mgcm import mgcm_dlti
    from lbmpc_tpu_torch.sets.terminal import get_cons
    from lbmpc_tpu_torch.synthesis import mat_ocp

    Ad, Bd, C, _ = mgcm_dlti()
    ocp = mat_ocp(Ad, Bd, C)
    cs = get_cons(x_min=[0.0, 1.1875, 0.1547, -20.0], x_max=[1.0, 2.1875, 2.1547, 20.0],
                  u_min=0.1547, u_max=2.1547, x_wp=[0.5, 1.6875, 1.1547, 0.0], u_wp=1.1547,
                  A=Ad, B=Bd, K=ocp.Ks, LAMBDA=ocp.LAMBDA, PSI=ocp.PSI,
                  LAMBDA_0=ocp.LAMBDA_0, PSI_0=ocp.PSI_0)
    qp = build_fmincon_lmpc(Ad, Bd, ocp.Ks, ocp.Q, ocp.R, ocp.P, ocp.T, ocp.LAMBDA,
                            ocp.PSI, cs, 20)
    rng = np.random.default_rng(seed)
    dxs = np.array([-0.35, -0.4, 0.0, 0.0]) + 0.01 * rng.standard_normal((B, 4))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda).contiguous()
    return (t(qp.G), t(qp.H), t((qp.Gg @ dxs.T).T + qp.g0), t(qp.h0 + (qp.Hp @ dxs.T).T))


def test_shared_qp_kernel_keeps_a_nan_lane_and_its_bits(cuda):
    """K4 at the cohort (8192 lanes, 4 a block): a lane whose g or h holds
    a NaN ends with NaN in mu and unconverged, and the other lanes, its
    block neighbours among them, are bit for bit what they are without it;
    one lane's QP placed at lanes 0, 1, 3, 4, 31 and 8191, and alone at
    B = 1, gives the same x, flag and mu."""
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra

    G, H, g, h = _lmpc_lanes(cuda, 8192, seed=61)
    n0 = qp_kernel.KERNEL_SHARED.launches
    x0, c0, mu0 = mehrotra(G, H, g, h, 20)
    assert qp_kernel.KERNEL_SHARED.launches == n0 + 1
    g1, h1 = g.clone(), h.clone()
    g1[3, 0] = float("nan")
    h1[9, 100] = float("nan")
    x1, c1, mu1 = mehrotra(G, H, g1, h1, 20)
    for lane in (3, 9):
        assert bool(torch.isnan(mu1[lane])) and not bool(c1[lane])
    keep = [i for i in range(g.shape[0]) if i not in (3, 9)]
    for a, b in ((x1, x0), (c1, c0), (mu1, mu0)):
        assert torch.equal(a[keep], b[keep])
    src, at = 5, [0, 1, 3, 4, 31, 8191]
    xs, cs_, mus = mehrotra(G, H, _place(g, src, at), _place(h, src, at), 20)
    x1, c1, mu1 = mehrotra(G, H, g[src:src + 1].contiguous(), h[src:src + 1].contiguous(), 20)
    for a, a1 in ((xs, x1), (cs_, c1), (mus, mu1)):
        assert torch.equal(a[at], a1.expand_as(a[at]))
    assert torch.equal(x1, x0[src:src + 1]) and torch.equal(mu1, mu0[src:src + 1])


def _lmpc_edge_qp(cuda, mI: int, nz: int, B: int, seed: int):
    """A QP of K4's shape (mI, nz) cut from the N=20 LMPC QP: its first
    min(mI, 128) rows (the early stages' boxes) on its first min(nz, 21)
    columns, with its H and g there; past nz = 21 decoupled variables (H
    diagonal in [1, 2], g normal), past 128 rows loose ones (|G_r|_1 = 1,
    h = 10, never active)."""
    G0, H0, g0, h0 = (a.cpu().numpy() for a in _lmpc_lanes(cuda, B, seed))
    rng = np.random.default_rng(seed)
    k, m = min(nz, 21), min(mI, 128)
    H = np.diag(rng.uniform(1.0, 2.0, nz))
    H[:k, :k] = H0[:k, :k]
    g = 0.7 * rng.standard_normal((B, nz))
    g[:, :k] = g0[:, :k]
    G = np.zeros((mI, nz))
    G[:m, :k] = G0[:m, :k]
    h = np.full((B, mI), 10.0)
    h[:, :m] = h0[:, :m]
    if mI > m:
        E = rng.standard_normal((mI - m, nz))
        G[m:] = E / np.abs(E).sum(axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda).contiguous()
    return t(G), t(H), t(g), t(h)


@pytest.mark.parametrize("mI", [1, 127, 128, 806, 1024])
@pytest.mark.parametrize("nz", [1, 8, 21, 32])
def test_shared_qp_kernel_at_the_domain_edges(cuda, mI, nz):
    """K4 at the edges of its domain (nz 1 and 8: padded width 8, 21: 24,
    32: 32; mI 1, 127 and 806 with the reference's padded rows, 128 and
    1024 without; 8 rows a thread at 1024) against its plain version on
    LMPC-cut QPs (_lmpc_edge_qp, 1024 lanes, 20 iterations), with phase
    15's gates: |dx| median < 1e-6 over the finite lanes, a lane with a NaN
    flagged unconverged, the share of lanes beyond 5e-2 of the float64
    optimum (60 iterations) at most 0.5 pp above the plain version's, conv
    > 0.95 and within 0.5 pp of the plain version's."""
    from lbmpc_tpu_torch.ops.qp_kernel import mehrotra

    G, H, g, h = _lmpc_edge_qp(cuda, mI, nz, 1024, seed=1000 * mI + nz)
    xk, ck, _ = mehrotra(G, H, g, h, 20)
    xp, cp, _ = mehrotra_plain(G, H, g, h, 20)
    x64 = mehrotra_plain(G.double(), H.double(), g.double(), h.double(), 60)[0]
    fin = (xk - xp).abs().amax(dim=1).isfinite()
    assert (xk - xp)[fin].abs().median().item() < 1e-6
    assert not bool((xk.isnan().any(dim=1) & ck).any())
    far = [(~((a.double() - x64).abs().amax(dim=1) <= 5e-2)).float().mean().item()
           for a in (xk, xp)]
    assert far[0] <= far[1] + 0.005
    fk, fp = ck.float().mean().item(), cp.float().mean().item()
    assert fk > 0.95 and abs(fk - fp) <= 0.005


def test_narrow_gn_and_shared_qp_shared_memory_is_the_hosts(cuda):
    """The block's shared memory that gn_kernel.narrow_gn_launch and
    qp_kernel.shared_launch size the launches by is the one K1 and K4
    carve, for every lane count they take."""
    import ctypes

    from lbmpc_tpu_torch.ops.gn_kernel import narrow_gn_smem_bytes
    from lbmpc_tpu_torch.ops.qp_kernel import shared_smem_bytes

    def c_fn(k, name):
        k.fn()
        fn = getattr(ctypes.CDLL(str(k.library_path())), name)
        fn.argtypes = [ctypes.c_int] * 3
        fn.restype = ctypes.c_longlong
        return fn

    k1 = c_fn(gn_kernel.KERNEL, "gn_phase_smem_bytes")
    for nz in range(4, 33):
        for q in (1, 7, 100, 1000):
            for lanes in range(1, 9):
                assert k1(nz, q, lanes) == narrow_gn_smem_bytes(nz, q, lanes)
    k4 = c_fn(qp_kernel.KERNEL_SHARED, "mehrotra_smem_bytes")
    for mI in (1, 7, 127, 128, 214, 806, 1024):
        for nz in (1, 2, 8, 9, 16, 21, 24, 25, 32):
            for lanes in range(1, qp_kernel.SHARED_MAX_LANES + 1):
                assert k4(mI, nz, lanes) == shared_smem_bytes(mI, nz, lanes)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_per_problem_solve_gives_a_lane_the_same_bits_at_any_batch(cuda, dtype):
    """The per-problem stack (build_scenario's LBMPC_N40 solver at full
    width, N=40, q=100; sqp 2, ipm 10) on the card, in each dtype: every
    lane of a batch of B equals the same lane of a batch of 8192, and lanes
    0 and B-1 their solves alone, bit for bit, at B from 1 to 8192
    (ops/lanes' forms; chip_smoke.py phase 38 runs the same sweep)."""
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, dtype=dtype,
                                                              sqp_iters=2, ipm_iters=10))
    sc = build_scenario(cfg, device=cuda)
    bmax, q = 8192, cfg.oracle.q
    rng = np.random.default_rng(16)
    f = lambda a: torch.as_tensor(a, dtype=getattr(torch, dtype), device=cuda)
    dx = f(np.asarray(cfg.dx_init) + 0.01 * rng.standard_normal((bmax, 4)))
    win = DataWindow(f(0.1 * rng.standard_normal((bmax, q, 3))),
                     f(0.001 * rng.standard_normal((bmax, q, 4))), f(np.ones((bmax, q))),
                     torch.full((bmax,), q, dtype=torch.int32, device=cuda))
    z = f(0.01 * rng.standard_normal((bmax, sc.nz)))
    part = lambda i, j: (dx[i:j], DataWindow(*(a[i:j] for a in win)), z[i:j])
    z_all, c_all = sc.solve(*part(0, bmax))
    assert bool(torch.isfinite(z_all).all())
    for B in (1, 2, 3, 4, 8, 16, 128, 256, 1000, 1024, 2048):
        zb, cb = sc.solve(*part(0, B))
        assert torch.equal(zb, z_all[:B]) and torch.equal(cb, c_all[:B]), B
        for i in {0, B - 1}:
            zs, cs = sc.solve(*part(i, i + 1))
            assert torch.equal(zs[0], z_all[i]) and bool(cs[0] == c_all[i]), (B, i)
