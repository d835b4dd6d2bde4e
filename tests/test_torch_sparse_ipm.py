"""PyTorch port, ops/sparse_ipm and the sparse LMPC scenario, against the
JAX package and against the port's condensed backend.

The JAX side runs jitted on the CPU in float64 (tests/conftest.py); the port
gets the reference's own stage data through interop.from_reference. The
reference's N=100 and N=300 cases and its 40-step episodes run with
RUN_SLOW=1.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu.config import make_preset
from lbmpc_tpu.controllers.condensed import build_casadi_dms
from lbmpc_tpu.models.mgcm import TS, mgcm_dlti
from lbmpc_tpu.ops.ipm import solve_qp
from lbmpc_tpu.ops import sparse_ipm as j_sp
from lbmpc_tpu.runtime.scenario import build_scenario as j_build_scenario
from lbmpc_tpu.sets.terminal import get_cons
from lbmpc_tpu.synthesis import mat_ocp
from lbmpc_tpu_torch import interop
from lbmpc_tpu_torch.ops import sparse_ipm as t_sp
from lbmpc_tpu_torch.runtime.scenario import build_scenario

SLOW = bool(os.environ.get("RUN_SLOW"))
DX0 = np.array([-0.35, -0.4, 0.0, 0.0])
F64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    A, B, C, _ = mgcm_dlti()
    ocp = mat_ocp(A, B, C)
    cs = get_cons(
        x_min=[0.0, 1.1875, 0.1547, -20.0], x_max=[1.0, 2.1875, 2.1547, 20.0],
        u_min=0.1547, u_max=2.1547, x_wp=[0.5, 1.6875, 1.1547, 0.0], u_wp=1.1547,
        A=A, B=B, K=ocp.Ks, LAMBDA=ocp.LAMBDA, PSI=ocp.PSI,
        LAMBDA_0=ocp.LAMBDA_0, PSI_0=ocp.PSI_0, cache=True,
    )
    return A, B, ocp, cs


def _stage(problem, N):
    A, B, ocp, cs = problem
    ref = j_sp.make_stage_qp(A, B, ocp.Q, ocp.R, ocp.P, ocp.T, ocp.LAMBDA, ocp.PSI,
                             cs, N, delta=TS)
    return ref, interop.from_reference(ref, device="cpu")


def test_make_stage_qp_matches_reference(problem):
    A, B, ocp, cs = problem
    ref, carried = _stage(problem, 12)
    mine = t_sp.make_stage_qp(A, B, ocp.Q, ocp.R, ocp.P, ocp.T, ocp.LAMBDA, ocp.PSI,
                              cs, 12, delta=TS, device="cpu")
    assert carried.N == mine.N == 12 and isinstance(carried.N, int)
    for f in t_sp.StageQP._fields[:-1]:
        np.testing.assert_array_equal(getattr(mine, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
        assert getattr(carried, f).dtype == F64


@pytest.mark.parametrize("parallel", [False, True])
def test_solve_sparse_matches_reference(problem, parallel):
    """U, theta, mu and the flag at N=30, to 1e-9 (the reference's own
    stage solve, from the same StageQP)."""
    ref_qp, qp = _stage(problem, 30)
    ref = jax.jit(lambda x: j_sp.solve_sparse(ref_qp, x, iters=30, parallel=parallel))(
        jnp.asarray(DX0))
    got = t_sp.solve_sparse(qp, torch.tensor(DX0)[None], iters=30, parallel=parallel)
    assert bool(ref.converged) and bool(got.converged[0])
    np.testing.assert_allclose(got.U[0].numpy(), np.asarray(ref.U), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.theta[0].numpy(), np.asarray(ref.theta), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got.X[0].numpy(), np.asarray(ref.X), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(got.mu[0]), float(ref.mu), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(got.max_violation[0]), float(ref.max_violation),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("N,tol", [(30, 1e-9)] + ([(100, 1e-5)] if SLOW else []))
def test_sparse_matches_condensed(problem, N, tol):
    """After tests/test_sparse_ipm.py:30-50: the stage solve equals the
    dense condensed IPM's on the same OCP."""
    A, B, ocp, cs = problem
    qpc = build_casadi_dms(A, B, ocp.Q, ocp.R, ocp.P, ocp.T, ocp.LAMBDA, ocp.PSI,
                           cs, N, delta=TS, terminal_at="last", tighten_first_step=False)
    dx0 = jnp.asarray(DX0)
    g = jnp.asarray(qpc.Gg) @ dx0 + jnp.asarray(qpc.g0)
    h = jnp.asarray(qpc.h0) + jnp.asarray(qpc.Hp) @ dx0
    dense = jax.jit(lambda H, g, G, h: solve_qp(H, g, G, h, iters=40))(
        jnp.asarray(qpc.H), g, jnp.asarray(qpc.G), h)
    _, qp = _stage(problem, N)
    sp = t_sp.solve_sparse(qp, torch.tensor(DX0)[None], iters=30)
    assert bool(sp.converged[0]) and float(sp.max_violation[0]) < 1e-8
    np.testing.assert_allclose(sp.U[0].numpy().ravel(), np.asarray(dense.x)[:N], atol=tol)
    np.testing.assert_allclose(sp.theta[0].numpy(), np.asarray(dense.x)[N:], atol=tol)


def test_sparse_parallel_matches_sequential(problem):
    _, qp = _stage(problem, 100 if SLOW else 40)
    x0 = torch.tensor(DX0)[None]
    seq = t_sp.solve_sparse(qp, x0, iters=25, parallel=False)
    par = t_sp.solve_sparse(qp, x0, iters=25, parallel=True)
    assert bool(par.converged.all())
    np.testing.assert_allclose(par.U.numpy(), seq.U.numpy(), atol=1e-9)
    np.testing.assert_allclose(par.theta.numpy(), seq.theta.numpy(), atol=1e-9)


@pytest.mark.skipif(not SLOW, reason="N=300 runs with RUN_SLOW=1")
def test_sparse_long_horizon(problem):
    _, qp = _stage(problem, 300)
    sp = t_sp.solve_sparse(qp, torch.tensor(DX0)[None], iters=30)
    assert bool(sp.converged[0]) and float(sp.max_violation[0]) < 1e-8


def test_sparse_dynamics_consistency(problem):
    A, B = problem[0], problem[1]
    N = 40
    _, qp = _stage(problem, N)
    dx0 = np.array([-0.2, -0.3, 0.0, 0.0])
    sp = t_sp.solve_sparse(qp, torch.tensor(dx0)[None], iters=25)
    X, U = sp.X[0].numpy(), sp.U[0].numpy()
    for k in range(N):
        np.testing.assert_allclose(X[k + 1], A @ X[k] + B @ U[k], atol=1e-10)
    np.testing.assert_allclose(X[0], dx0)


def test_sparse_float32_converges(problem):
    """After tests/test_sparse_ipm.py:88-107 at N=20: the dtype-aware guards
    (tiny floor, d-cap, converged-freeze) keep the float32 solve NaN-free
    and within 2e-4 of float64 in U[0]."""
    _, qp = _stage(problem, 20)
    x0 = torch.tensor(DX0)[None]
    ref = t_sp.solve_sparse(qp, x0, iters=25)
    qp32 = t_sp.StageQP(*(a.float() if torch.is_tensor(a) else a for a in qp))
    sol = t_sp.solve_sparse(qp32, x0.float(), iters=25)
    assert sol.U.dtype == torch.float32
    assert bool(sol.converged[0]), (float(sol.mu[0]), float(sol.max_violation[0]))
    assert torch.isfinite(sol.U).all()
    np.testing.assert_allclose(sol.U[0, 0].double().numpy(), ref.U[0, 0].numpy(), atol=2e-4)


@pytest.mark.parametrize("parallel", [False, True])
def test_lanes_are_independent(problem, parallel):
    """A batch of lanes with different x0, one of them far from the others
    (its constraints active for longer, so it converges, freezes and takes
    its step lengths on its own schedule), equals each lane's solo solve:
    mu, mu_aff, sigma, the step lengths, the violation and the freeze stay
    inside a lane."""
    _, qp = _stage(problem, 16)
    x0 = torch.tensor([[-0.35, -0.4, 0.0, 0.0], [-0.05, 0.02, 0.0, 0.0],
                       [0.3, 0.35, 0.4, 2.0], [0.0, 0.0, 0.0, 0.0]], dtype=F64)
    batch = t_sp.solve_sparse(qp, x0, iters=20, parallel=parallel)
    assert not bool((batch.mu == batch.mu[0]).all())
    for i in range(x0.shape[0]):
        solo = t_sp.solve_sparse(qp, x0[i:i + 1], iters=20, parallel=parallel)
        for f in t_sp.SparseIPMSolution._fields:
            np.testing.assert_allclose(getattr(batch, f)[i].double().numpy(),
                                       getattr(solo, f)[0].double().numpy(),
                                       rtol=0, atol=1e-12, err_msg=f)


def test_peak_bytes_model_bounds_the_live_tensors(problem):
    """The model behind run_batch's sparse_parallel guard is an upper bound
    on what the solve holds at once: counted here by the bytes of the
    tensors alive after each operation (on the card chip_smoke.py holds it
    to torch.cuda.max_memory_allocated)."""
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    class Live(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.refs, self.size, self.live, self.peak = {}, {}, 0, 0

        def _drop(self, ptr):
            self.refs[ptr] -= 1
            if not self.refs[ptr]:
                self.live -= self.size.pop(ptr)
                del self.refs[ptr]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr():
                    ptr = t.untyped_storage().data_ptr()
                    if ptr not in self.refs:
                        self.refs[ptr] = 0
                        self.size[ptr] = t.untyped_storage().nbytes()
                        self.live += self.size[ptr]
                        self.peak = max(self.peak, self.live)
                    self.refs[ptr] += 1
                    weakref.finalize(t, self._drop, ptr)
            return out

    N, lanes = 20, 8
    _, qp = _stage(problem, N)
    rows = (qp.h_x.shape[0], qp.h_u.shape[0], qp.h_w.shape[0])
    x0 = torch.tensor(DX0)[None].repeat(lanes, 1)
    for parallel in (False, True):
        with Live() as live:
            t_sp.solve_sparse(qp, x0, iters=2, parallel=parallel)
        model = t_sp.peak_bytes(lanes, N, 4, 1, 1, rows, 8, parallel=parallel)
        assert 0.5 * model < live.peak <= model, (parallel, live.peak, model)


def _dms_lmpc(pkg_make_preset, N, steps, backend="condensed"):
    cfg = pkg_make_preset("DMS_LMPC")
    return dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N), iterations=steps,
                               solver=dataclasses.replace(cfg.solver, qp_backend=backend))


def test_scenario_sparse_backends_match_condensed_and_reference():
    """After tests/test_sparse_ipm.py:110-129 (DMS_LMPC cut to N=30; 40
    steps with RUN_SLOW=1, 8 here): both stage-wise backends run the
    casadi-family tracking LMPC closed loop, converge at every step and
    reproduce the port's condensed episode (1e-6, the reference's bound) and
    the reference's sparse episode (1e-9)."""
    steps = 40 if SLOW else 8
    ref_c = build_scenario(_dms_lmpc(lt.make_preset, 30, steps), device="cpu").run()
    for backend in ("sparse", "sparse_parallel"):
        sc = build_scenario(_dms_lmpc(lt.make_preset, 30, steps, backend), device="cpu")
        got = sc.run()
        assert bool(got.solver_converged.all())
        np.testing.assert_allclose(got.sys_history.numpy(), ref_c.sys_history.numpy(),
                                   atol=1e-6)
        ref = j_build_scenario(_dms_lmpc(make_preset, 30, steps, backend)).run()
        np.testing.assert_allclose(got.sys_history.numpy(), np.asarray(ref.sys_history),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(got.art_history.numpy(), np.asarray(ref.art_history),
                                   rtol=0, atol=1e-9)


def test_run_batch_lanes_equal_single_runs():
    """run_batch on the sparse backend: each lane's episode equals its own."""
    sc = build_scenario(_dms_lmpc(lt.make_preset, 20, 3, "sparse"), device="cpu")
    dx = np.array([[-0.35, -0.4, 0.0, 0.0], [-0.1, 0.05, 0.0, 0.0]])
    batch = sc.run_batch(dx)
    for i in range(2):
        solo = sc.run(dx[i])
        np.testing.assert_allclose(batch.sys_history[i].numpy(), solo.sys_history.numpy(),
                                   rtol=0, atol=1e-12)


def test_parallel_scan_turns_on_roundoff_where_the_barrier_caps_as_in_the_reference():
    """ROADMAP §3, not a fault of the port. DMS_LMPC (N=50) from a state
    (lane 611 of chip_smoke.py's phase-34 states) where the barrier weights
    D = z/s reach their 1e30 cap: the associative-scan Riccati returns a
    point flagged converged about 1e-3 from the optimum in U[0], in the
    reference as in the port (where it lands turns on roundoff: a lane alone
    or in a batch lands elsewhere), while the sequential sweep reaches the
    optimum in both, to 1e-9 of each other."""
    cfg = make_preset("DMS_LMPC")
    sc = j_build_scenario(cfg)
    ref_qp = j_sp.make_stage_qp(sc.A, sc.B, sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T,
                                sc.ocp.LAMBDA, sc.ocp.PSI, sc.cs, cfg.ocp.N, delta=cfg.plant.ts)
    qp = interop.from_reference(ref_qp, device="cpu")
    x0 = np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp)
    dx = (x0 + np.array([0.01, 0.01, 0.01, 0.1])
          * np.random.default_rng(21).standard_normal((1024, 4)))[611]
    u0 = {}
    for par in (False, True):
        ref = jax.jit(lambda x: j_sp.solve_sparse(ref_qp, x, iters=25, parallel=par))(
            jnp.asarray(dx))
        got = t_sp.solve_sparse(qp, torch.tensor(dx)[None], iters=25, parallel=par)
        assert bool(ref.converged) and bool(got.converged[0])
        u0[par] = (float(ref.U[0, 0]), float(got.U[0, 0, 0]))
    (ref_seq, got_seq), (ref_par, got_par) = u0[False], u0[True]
    assert abs(got_seq - ref_seq) < 1e-9
    assert abs(ref_par - ref_seq) > 1e-4 and abs(got_par - got_seq) > 1e-5
