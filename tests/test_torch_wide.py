"""PyTorch port, the kernel routes above nz 32: the GN phase's plain version
(ops/gn_kernel.GNPhase, K1w's twin) for the casadi family at a cut horizon
and the fmincon family at N=40 against lbmpc_tpu's residual, Jacobian and
normal terms; K1w's constant block; the pallas_full and pallas fused solves
at nz=41 (K1w/K2w twins on the CPU) against the reference's
make_lbmpc_solver_fused(qp_kernel="xla") with its XLA Cholesky; and the warm
chain at nz=41."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers import lbmpc as t_lbmpc
from lbmpc_tpu_torch.controllers.sqp_fused import make_lbmpc_solver_fused
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers import condensed as j_cond
from lbmpc_tpu.controllers.lbmpc import LBMPCWeights, make_residual_and_jac
from lbmpc_tpu.oracle import DataWindow as JWindow
from lbmpc_tpu.runtime.scenario import build_scenario

N, Q, B = 40, 8, 16            # nz = 41: above K1/K2's 32, on K1w/K2w
LADDER = ((1.0,), (1.0, 0.5, 0.25))
PRESET = {"fmincon": "LBMPC_N40", "casadi": "DMS_LBMPC_q100"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and torch's default of a thread per core oversubscribes the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(preset, family):
    cfg = preset(PRESET[family])
    return dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
                               oracle=dataclasses.replace(cfg.oracle, q=Q))


@pytest.fixture(scope="module", params=["fmincon", "casadi"])
def wide(request):
    """One family at N=40 on both sides: the reference's setup (condensed QP,
    weights) and the port's; LBMPC_N40 is uncut here, the DMS flagship cut
    from N=100 to 40."""
    family = request.param
    cfg = _cut(make_preset, family)
    sc = build_scenario(cfg)
    o = sc.ocp
    if family == "fmincon":
        qp = j_cond.build_fmincon_lmpc(
            sc.A, sc.B, o.Ks, o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI, sc.cs, N,
            dx_ref=np.asarray(cfg.dx_ref), terminal_at=cfg.ocp.terminal_at,
            tighten_first_step=cfg.ocp.tighten_first_step)
    else:
        qp = j_cond.build_casadi_dms(
            sc.A, sc.B, o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI, sc.cs, N,
            delta=cfg.plant.ts, terminal_at=cfg.ocp.terminal_at,
            tighten_first_step=cfg.ocp.tighten_first_step)
    w = LBMPCWeights.make(o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI)
    ts = t_build(_cut(lt.make_preset, family))
    assert ts.nz == qp.nz == N + 1
    kw = dict(family=family, delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    rng = np.random.default_rng(0)
    x0 = (np.array([-0.35, -0.4, 0.0, 0.0]) if family == "fmincon"
          else np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp))
    data = dict(z=0.02 * rng.standard_normal((B, N + 1)),
                dx=x0 + 0.01 * rng.standard_normal((B, 4)),
                X=0.1 * rng.standard_normal((B, Q, 3)),
                Y=0.001 * rng.standard_normal((B, Q, 4)),
                valid=(rng.uniform(size=(B, Q)) > 0.2).astype(float))
    return family, cfg, sc, qp, w, ts, kw, data


def _windows(data, jdt, tdt, valid=True):
    v = data["valid"] if valid else np.ones((B, Q))
    jw = JWindow(jnp.asarray(data["X"], jdt), jnp.asarray(data["Y"], jdt), jnp.asarray(v, jdt),
                 jnp.full((B,), Q, jnp.int32))
    tw = DataWindow(torch.tensor(data["X"], dtype=tdt), torch.tensor(data["Y"], dtype=tdt),
                    torch.tensor(v, dtype=tdt), torch.full((B,), Q, dtype=torch.int32))
    return jw, tw


@pytest.fixture(scope="module")
def reference_normal_terms(wide):
    """The reference's residual, H = 2 J'J + 1e-6 I and g = 2 J'e in
    float64."""
    family, cfg, sc, qp, w, ts, kw, data = wide
    f64 = jnp.float64
    _, res_jac = make_residual_and_jac(qp, sc.A, sc.B, sc.ocp.Ks, w, dtype=f64, **kw)
    jw, _ = _windows(data, f64, None)
    e, J = jax.vmap(res_jac)(jnp.asarray(data["z"], f64), jnp.asarray(data["dx"], f64), jw)
    H = 2.0 * jnp.einsum("bei,bej->bij", J, J) + 1e-6 * jnp.eye(qp.nz, dtype=f64)[None]
    g = 2.0 * jnp.einsum("bei,be->bi", J, e)
    return np.asarray(e), np.asarray(H), np.asarray(g)


def test_gn_plain_matches_reference_normal_terms_f64(wide, reference_normal_terms):
    """float64: the plain GN phase's computation (the port's residual and
    Jacobian, then 2 J'J + 1e-6 I and 2 J'e) equals the reference's within
    1e-12, with H (B, nz, nz) row-major and symmetric."""
    family, cfg, sc, qp, w, ts, kw, data = wide
    e_r, H_r, g_r = reference_normal_terms
    _, tw = _windows(data, None, torch.float64)
    _, res_jac = t_lbmpc.make_residual_and_jac(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w,
                                               dtype=torch.float64, device="cpu", **kw)
    e, J = res_jac(torch.tensor(data["z"]), torch.tensor(data["dx"]), tw)
    Jt = J.transpose(1, 2)
    H = 2.0 * (Jt @ J) + 1e-6 * torch.eye(ts.nz, dtype=torch.float64)
    g = 2.0 * (Jt @ e[..., None])[..., 0]
    assert H.shape == (B, N + 1, N + 1) and H.is_contiguous()
    np.testing.assert_allclose(e.numpy(), e_r, rtol=0, atol=1e-12)
    np.testing.assert_allclose(H.numpy(), H_r, rtol=0, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_r, rtol=0, atol=1e-12)


def test_gn_plain_matches_reference_normal_terms_f32(wide, reference_normal_terms):
    """float32: GNPhase.plain — what the CPU runs for K1w — against the
    reference's float64 normal terms in the K1 class (e 1e-4; H and g 1e-5
    max|H|, tests/test_pallas_gn.py)."""
    family, cfg, sc, qp, w, ts, kw, data = wide
    e_r, H_r, g_r = reference_normal_terms
    _, tw = _windows(data, None, torch.float32)
    gn = GNPhase(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu", **kw)
    assert gn.wide and not gn.narrow and gn.kernel_ok
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    e, H, g = gn(f(data["z"]), f(data["dx"]), tw)
    assert H.shape == (B, N + 1, N + 1) and torch.equal(H, H.transpose(1, 2))
    hmax = np.abs(H_r).max()
    assert np.abs(e.numpy() - e_r).max() < 1e-4
    assert np.abs(H.numpy() - H_r).max() < 1e-5 * hmax
    assert np.abs(g.numpy() - g_r).max() < 1e-5 * hmax


def test_gn_wide_constant_block_folds_the_constant_rows(wide):
    """K1w's host-side constants: Hconst (read at csrc/gn_wide_body.cuh
    C_HCONST) holds the ridge, the rT rows and, for casadi, the du rows, so
    the rows K1w accumulates (rx and rP; fmincon also ru) complete H exactly
    (float64); C_SQD is sqrt(delta) for casadi and 1 for fmincon."""
    family, cfg, sc, qp, w, ts, kw, data = wide
    gn = GNPhase(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu", **kw)
    nz = ts.nz
    Hc = gn.cst[72:].reshape(nz, nz).double().numpy()
    assert np.array_equal(Hc, Hc.T)
    sqd = np.sqrt(cfg.plant.ts) if family == "casadi" else 1.0
    assert gn.cst[69].item() == pytest.approx(sqd, rel=1e-7)
    _, tw = _windows(data, None, torch.float64)
    _, res_jac = t_lbmpc.make_residual_and_jac(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w,
                                               dtype=torch.float64, device="cpu", **kw)
    _, J = res_jac(torch.tensor(data["z"]), torch.tensor(data["dx"]), tw)
    J = J.numpy()
    n_run = N if family == "casadi" else N - 2
    rows = list(range(n_run * 4)) + list(range(n_run * 5, n_run * 5 + 4))
    if family == "fmincon":
        rows += list(range(n_run * 4, n_run * 5))
    Jd = J[:, sorted(rows)]
    H_full = 2.0 * np.einsum("bri,brj->bij", J, J) + 1e-6 * np.eye(nz)
    H_fold = 2.0 * np.einsum("bri,brj->bij", Jd, Jd) + Hc[None]
    assert np.abs(H_fold - H_full).max() < 1e-6 * np.abs(H_full).max()


@pytest.fixture(scope="module")
def reference_solve(wide):
    """The reference's fused SQP on its XLA route with its XLA Cholesky
    (sqp_iters=2, ipm (16, 8), the per-GN ladder), float32."""
    family, cfg, sc, qp, w, ts, kw, data = wide
    mp = pytest.MonkeyPatch()
    mp.setenv("LBMPC_CHOL", "xla")
    try:
        from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_fused as ref_fused

        f32 = jnp.float32
        jw, _ = _windows(data, f32, None, valid=False)
        ref = ref_fused(qp, sc.A, sc.B, sc.ocp.Ks, w, qp_kernel="xla", sqp_iters=2,
                        ipm_iters=(8, 8), alphas=LADDER, tile=B, **kw)
        z, c = ref(jnp.asarray(data["dx"], f32), jw, jnp.zeros((B, qp.nz), f32))
    finally:
        mp.undo()
    return np.asarray(z), np.asarray(c)


@pytest.mark.parametrize("route", ["pallas_full", "pallas"])
def test_wide_routes_match_reference(wide, reference_solve, route):
    """pallas_full (K1w + K2w twins) and pallas (plain GN + K2w twin) at
    nz=41 against the reference's xla route: median < 1e-6, max < 5e-3,
    conv on every lane (tests/test_torch_sqp.py's class)."""
    family, cfg, sc, qp, w, ts, kw, data = wide
    zx, cx = reference_solve
    _, tw = _windows(data, None, torch.float64, valid=False)
    port = make_lbmpc_solver_fused(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, qp_kernel=route,
                                   sqp_iters=2, ipm_iters=(8, 8), alphas=LADDER,
                                   device="cpu", **kw)
    zt, ct = port(torch.tensor(data["dx"]), tw, torch.zeros(B, ts.nz))
    assert zt.dtype == torch.float32 and zt.shape == (B, N + 1)
    d = np.abs(zt.numpy() - zx)
    assert np.median(d) < 1e-6, np.median(d)
    assert d.max() < 5e-3, d.max()
    assert bool(cx.all()) and bool(ct.all())


def test_raw_qpwarm_from_init_state_equals_the_solve_wide(wide):
    """The warm chain at nz=41 on the fleet's schedule (8, 2): raw_qpwarm
    seeded by init_qp_state (a cold state) reproduces the solve bit for bit,
    hands back a (B, mI) interior, and converges on every lane."""
    family, cfg, sc, qp, w, ts, kw, data = wide
    _, tw = _windows(data, None, torch.float32, valid=False)
    dx = torch.tensor(data["dx"], dtype=torch.float32)
    z0 = torch.zeros(B, ts.nz)
    s = make_lbmpc_solver_fused(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, qp_kernel="pallas_full",
                                sqp_iters=2, ipm_iters=(8, 2), alphas=LADDER, qp_warm=True,
                                device="cpu", **kw)
    z1, c1 = s.raw(dx, tw, z0)
    z2, c2, st = s.raw_qpwarm(dx, tw, z0, s.init_qp_state(dx, z0))
    mI = ts.qp.G.shape[0]
    assert st[0].shape == (B, mI) and st[1].shape == (B, mI)
    assert torch.equal(z2, z1) and torch.equal(c2, c1) and bool(c2.all())
    z3, c3, _ = s.raw_qpwarm(dx, tw, z2, st)
    assert bool(z3.isfinite().all()) and bool(c3.all())
