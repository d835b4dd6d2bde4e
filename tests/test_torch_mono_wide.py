"""PyTorch port, the pallas_mono route above nz 32 and for the casadi family
(K3w, ops/mono_kernel): its plain version at LBMPC_N40's nz=41 and on the
casadi DMS preset cut to N=40 (tests/test_torch_wide.py's shapes) against the reference's XLA composition of its parts, the
pallas_mono solve at nz=41 against the reference's qp_kernel="xla" route
(its XLA Cholesky, no Pallas), and the ported scoped-VMEM predicate of the
reference's fused kernel against the reference's own figures."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers import sqp_fused as t_sqp
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.ops.mono_kernel import MonoPhase
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers import condensed as j_cond
from lbmpc_tpu.controllers.lbmpc import LBMPCWeights, make_residual_and_jac
from lbmpc_tpu.oracle import DataWindow as JWindow
from lbmpc_tpu.runtime.scenario import build_scenario

Q, B = 18, 16
N_OF = {"fmincon": 40, "casadi": 40}     # nz = 41: LBMPC_N40 uncut, the DMS preset cut
PRESET = {"fmincon": "LBMPC_N40", "casadi": "DMS_LBMPC_q100"}
LADDER = ((1.0,), (1.0, 0.5, 0.25))
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(preset, family, q=Q):
    cfg = preset(PRESET[family])
    return dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N_OF[family]),
                               oracle=dataclasses.replace(cfg.oracle, q=q))


@pytest.fixture(scope="module", params=["fmincon", "casadi"])
def wide(request):
    family = request.param
    N = N_OF[family]
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
    assert ts.nz == qp.nz == N + 1 > 32
    kw = dict(family=family, delta=cfg.plant.ts, bandwidth=cfg.oracle.bandwidth,
              ridge=cfg.oracle.ridge, dx_ref=np.asarray(cfg.dx_ref))
    rng = np.random.default_rng(0)
    x0 = (np.array([-0.35, -0.4, 0.0, 0.0]) if family == "fmincon"
          else np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp))
    data = dict(dx=x0 + 0.01 * rng.standard_normal((B, 4)),
                X=0.1 * rng.standard_normal((B, Q, 3)),
                Y=0.001 * rng.standard_normal((B, Q, 4)),
                valid=(rng.uniform(size=(B, Q)) > 0.3).astype(float),
                z=(0.02 * rng.standard_normal((B, N + 1))).astype(np.float32))
    return family, cfg, sc, qp, w, ts, kw, data


def _windows(data, valid=True):
    v = data["valid"] if valid else np.ones((B, Q))
    jw = JWindow(X=jnp.asarray(data["X"], jnp.float32), Y=jnp.asarray(data["Y"], jnp.float32),
                 valid=jnp.asarray(v, jnp.float32), count=jnp.full((B,), Q, jnp.int32))
    tw = DataWindow(torch.tensor(data["X"], dtype=F32), torch.tensor(data["Y"], dtype=F32),
                    torch.tensor(v, dtype=F32), torch.full((B,), Q, dtype=torch.int32))
    return jw, tw


@pytest.mark.parametrize("iters", [8, 16])
def test_mono_wide_plain_matches_reference_composition(wide, monkeypatch, iters):
    """K3w's plain version (GNPhase.plain -> step_rhs -> mehrotra_h_plain,
    cold) against the reference's XLA parts (make_residual_and_jac for e and
    g: the class of tests/test_pallas_gn.py, e 1e-4, g 1e-5 of max|g|; then
    ipm_fused.build_fused_qp_solver(None, G, scale=True, d_cap=1e6)
    .raw_with_H on h - G z). Above nz 32 two float32 computations of the
    same QP leave the K2 class where Mehrotra stalls (mu >= 1e-6): d's
    median within 1e-6 on the lanes where neither side stalls, and every
    lane beyond 5e-2 stalled on a side."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.ops.ipm_fused import build_fused_qp_solver

    family, cfg, sc, qp, w, ts, kw, data = wide
    z = data["z"]
    jw, tw = _windows(data)
    f32 = jnp.float32
    dx = jnp.asarray(data["dx"], f32)
    _, res_jac = make_residual_and_jac(qp, sc.A, sc.B, sc.ocp.Ks, w, dtype=f32, **kw)
    with jax.default_matmul_precision("highest"):
        e_r, J = jax.vmap(res_jac)(jnp.asarray(z), dx, jw)
        H = (2.0 * jnp.einsum("bei,bej->bij", J, J, precision=jax.lax.Precision.HIGHEST)
             + 1e-6 * jnp.eye(qp.nz, dtype=f32)[None])
        g_r = 2.0 * jnp.einsum("bei,be->bi", J, e_r, precision=jax.lax.Precision.HIGHEST)
        h = (jnp.asarray(qp.h0, f32)[None] + dx @ jnp.asarray(qp.Hp, f32).T
             - jnp.asarray(z) @ jnp.asarray(qp.G, f32).T)
        sub = build_fused_qp_solver(None, qp.G, iters=iters, tile=B, scale=True,
                                    d_cap=1e6).raw_with_H(H, g_r, h)
    gn = GNPhase(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w, device="cpu", **kw)
    t = lambda a: torch.tensor(np.asarray(a), dtype=F32)
    mono = MonoPhase(gn, t(ts.qp.G), t(ts.qp.h0), t(ts.qp.Hp), iters)
    assert mono.wide and not mono.narrow and mono.kernel_ok
    e, d, mu, g = mono(torch.tensor(z), torch.tensor(data["dx"], dtype=F32), tw)
    gmax = np.abs(np.asarray(g_r)).max()
    assert np.abs(e.numpy() - np.asarray(e_r)).max() < 1e-4
    assert np.abs(g.numpy() - np.asarray(g_r)).max() < 1e-5 * gmax
    mu_r = np.asarray(sub.mu)
    held = (mu.numpy() < 1e-6) & (mu_r < 1e-6)
    dd = np.abs(d.numpy() - np.asarray(sub.x))
    assert held.sum() >= B // 4, held.sum()
    assert np.median(dd[held]) < 1e-6, np.median(dd[held])
    assert (~held | (dd.max(axis=1) <= 5e-2)).all()


def test_mono_wide_solve_matches_reference(wide, monkeypatch):
    """pallas_mono (K3w's plain version) at nz > 32 against the reference's
    xla route at ipm (8, 8) and the two-stage ladder: median < 1e-6, max <
    5e-3 (tests/test_torch_wide.py's class; at 16 IPM iterations two float32
    computations leave it, as there), the same conv flags (one casadi lane
    of these 16 is unconverged on both sides)."""
    monkeypatch.setenv("LBMPC_CHOL", "xla")
    from lbmpc_tpu.controllers.sqp_fused import make_lbmpc_solver_fused

    family, cfg, sc, qp, w, ts, kw, data = wide
    jw, tw = _windows(data, valid=False)
    ref = make_lbmpc_solver_fused(qp, sc.A, sc.B, sc.ocp.Ks, w, qp_kernel="xla", sqp_iters=2,
                                  ipm_iters=(8, 8), alphas=LADDER, tile=B, **kw)
    zx, cx = ref(jnp.asarray(data["dx"], jnp.float32), jw, jnp.zeros((B, qp.nz), jnp.float32))
    monkeypatch.delenv("LBMPC_CHOL")
    port = t_sqp.make_lbmpc_solver_fused(ts.qp, ts.A, ts.B, ts.ocp.Ks, ts.w,
                                         qp_kernel="pallas_mono", sqp_iters=2, ipm_iters=(8, 8),
                                         alphas=LADDER, device="cpu", **kw)
    zt, ct = port(torch.tensor(data["dx"]), tw, torch.zeros(B, ts.nz))
    assert zt.dtype == F32 and zt.shape == (B, ts.nz)
    d = np.abs(zt.numpy() - np.asarray(zx))
    assert np.median(d) < 1e-6, np.median(d)
    assert d.max() < 5e-3, d.max()
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cx))
    assert ct.float().mean().item() >= 0.9


def test_vmem_predicate_matches_reference():
    """The ported scoped-VMEM model of the reference's fused kernel at its
    mono tile (128): the DMS flagship (nz_p=104, q_p=104) needs 59.3M and is
    refused with the reference's own message, raised by the reference's
    build_pallas_gn_kernel when called; LBMPC_N40 (19.0 MB), LBMPC_N50 (24.1 MB)
    and the DMS preset cut to N=60 (28.4 MB) fit the 60M grant budget."""
    from lbmpc_tpu.ops.pallas_gn import build_pallas_gn_kernel

    cfg = make_preset("DMS_LBMPC_q100")
    sc = build_scenario(cfg)
    o = sc.ocp
    qp = j_cond.build_casadi_dms(sc.A, sc.B, o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI, sc.cs,
                                 cfg.ocp.N, delta=cfg.plant.ts,
                                 terminal_at=cfg.ocp.terminal_at,
                                 tighten_first_step=cfg.ocp.tighten_first_step)
    w = LBMPCWeights.make(o.Q, o.R, o.P, o.T, o.LAMBDA, o.PSI)
    raw = build_pallas_gn_kernel(qp, sc.A, sc.B, o.Ks, w, delta=cfg.plant.ts,
                                 bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                                 dx_ref=np.asarray(cfg.dx_ref), q=cfg.oracle.q, tile=128,
                                 interpret=True, family="casadi", ipm=dict(iters=8, d_cap=1e6))
    q = cfg.oracle.q
    jw = JWindow(X=jnp.zeros((2, q, 3), jnp.float32), Y=jnp.zeros((2, q, 4), jnp.float32),
                 valid=jnp.ones((2, q), jnp.float32), count=jnp.full((2,), q, jnp.int32))
    with pytest.raises(ValueError) as ref_err:
        raw(jnp.zeros((2, qp.nz), jnp.float32), jnp.zeros((2, 4), jnp.float32), jw)
    ts = t_build("DMS_LBMPC_q100")
    with pytest.raises(ValueError) as port_err:
        t_sqp.check_mono_vmem(ts.qp, "casadi", q, t_sqp.MONO_TILE)
    assert str(port_err.value) == str(ref_err.value)
    assert "59.3M" in str(port_err.value)
    for name, N, family, mb in (("LBMPC_N40", 40, "fmincon", 19.0), ("LBMPC_N50", 50,
                                                                     "fmincon", 24.1),
                                ("DMS_LBMPC_q100", 60, "casadi", 28.4)):
        c = lt.make_preset(name)
        s = t_build(dataclasses.replace(c, ocp=dataclasses.replace(c.ocp, N=N)))
        need = t_sqp.mono_vmem_need(s.qp, family, c.oracle.q, t_sqp.MONO_TILE)
        assert abs(need / 1e6 - mb) < 0.05, (name, need)
        t_sqp.check_mono_vmem(s.qp, family, c.oracle.q, t_sqp.MONO_TILE)
