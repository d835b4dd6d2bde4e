"""PyTorch port, runtime/sharding: the scenario mesh on CPU shards, the
split runners against the unsplit calls and the JAX package, the hybrid's
repair picked over the whole batch, resume over a mesh, and the fleet
budget model with the reference's constants.

Eight shards sit on "cpu" (the reference's tests use 8 virtual CPU devices,
tests/conftest.py). The JAX side runs on that 8-device mesh in float64.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch.controllers import sqp_fused as t_sqp
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops.lanes import exact_rows
from lbmpc_tpu_torch.runtime import checkpoint as t_ck
from lbmpc_tpu_torch.runtime import sharding as t_sh
from lbmpc_tpu_torch.runtime.scenario import build_fleet_episode as t_fleet
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.runtime import sharding as j_sh
from lbmpc_tpu.runtime.scenario import build_scenario

DX0 = np.array([-0.35, -0.4, 0.0, 0.0])


def _small(make, **kw):
    """The reference's _small_cfg (tests/test_runtime.py:23-30)."""
    cfg = make("LBMPC_N40", iterations=3, **kw)
    return dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
        solver=dataclasses.replace(cfg.solver, sqp_iters=1, ipm_iters=10),
        oracle=dataclasses.replace(cfg.oracle, q=16))


def _cpu_mesh(n=8):
    return t_sh.scenario_mesh(devices=["cpu"] * n)


def test_split_episode_matches_unsplit_and_the_reference():
    """The reference's test_sharded_episode_matches_unsharded: 16 scenarios
    over 8 shards; the split episode equals the unsplit one, and the JAX
    package's split runner on its 8-device mesh, within 1e-9."""
    dx0 = (np.tile(DX0, (16, 1))
           + 0.002 * np.random.default_rng(0).standard_normal((16, 4)))
    sc = t_build(_small(lt.make_preset), device="cpu")
    mesh = _cpu_mesh()
    split = t_sh.sharded_episode_runner(sc.run_batch, mesh)(
        t_sh.shard_scenarios(mesh, torch.tensor(dx0)))
    whole = sc.run_batch(dx0)
    assert split.sys_history.shape == (16, 4, 5)
    np.testing.assert_allclose(split.sys_history.numpy(), whole.sys_history.numpy(),
                               rtol=0, atol=1e-9)
    jsc = build_scenario(_small(make_preset))
    jmesh = j_sh.scenario_mesh(8)
    ref = j_sh.sharded_episode_runner(jsc.episode, jmesh)(
        j_sh.shard_scenarios(jmesh, jnp.asarray(dx0)))
    np.testing.assert_allclose(split.sys_history.numpy(), np.asarray(ref.sys_history),
                               rtol=0, atol=1e-9)


def test_global_solve_stats_sums_every_shard():
    mesh = _cpu_mesh()
    conv = torch.tensor([True] * 13 + [False] * 3)
    assert t_sh.global_solve_stats(mesh, t_sh.shard_scenarios(mesh, conv)) == (13, 16)
    assert t_sh.global_solve_stats(mesh, conv) == (13, 16)


def test_mesh_shards_and_refusals():
    """Shards in order on their devices; a batch they do not divide, and a
    mesh with no CUDA device and no devices=, raise."""
    mesh = _cpu_mesh(4)
    assert mesh.size == 4 and mesh.axis == "scenario" and list(mesh.local) == [0, 1, 2, 3]
    sh = t_sh.shard_scenarios(mesh, (torch.arange(8), torch.arange(16).reshape(8, 2)))
    assert sh.index == (0, 1, 2, 3)
    assert [p[0].tolist() for p in sh.parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="multiple"):
        t_sh.shard_scenarios(mesh, torch.zeros(6, 4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_sh.scenario_mesh()


def _fleet_case():
    cfg = lt.make_preset("LBMPC_N40", iterations=3)
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
        solver=dataclasses.replace(cfg.solver, dtype="float32", sqp_iters=1, ipm_iters=10),
        oracle=dataclasses.replace(cfg.oracle, q=8))
    dx0 = DX0 + np.random.default_rng(0).uniform(-0.02, 0.02, (64, 4))
    return t_build(cfg, device="cpu"), torch.tensor(dx0)


@pytest.fixture(scope="module")
def fleet_runs():
    """_fleet_case's direct call and its split over 8 shards in cohorts of
    16 (shared by the two tests below)."""
    sc, dx0 = _fleet_case()
    return sc, dx0, sc.run_batch(dx0), t_sh.fleet_runner(sc.run_batch, _cpu_mesh(8),
                                                         chunk=16)(dx0)


def test_fleet_runner_chunked_matches_direct(fleet_runs):
    """The reference's test_fleet_runner_chunked_matches_direct: F=64 in
    cohorts of 16 over 8 shards (2 lanes a shard), float32, against the
    direct call within 1e-6; F=50 raises. The per-problem stack's products
    take ops/lanes' forms, so the split equals the direct call bit for bit."""
    sc, dx0, direct, res = fleet_runs
    assert res.sys_history.shape[0] == 64
    np.testing.assert_allclose(res.sys_history.numpy(), direct.sys_history.numpy(),
                               rtol=0, atol=1e-6)
    assert torch.equal(res.sys_history, direct.sys_history)
    mesh = _cpu_mesh(8)
    n_conv, n_tot = t_sh.global_solve_stats(mesh, res.solver_converged.all(dim=-1))
    assert n_tot == 64 and n_conv > 0
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        t_sh.fleet_runner(sc.run_batch, mesh, chunk=16)(dx0[:50])


def test_float32_lanes_below_four_round_apart_on_the_cpu(fleet_runs):
    """Once the pin of a fault: on 8 shards a cohort of 16 gives 2 lanes a
    shard, and a float32 matrix product of fewer than 4 rows (dx @ Ks' in
    the residual, (B, 4) x (4, 1)) rounded apart on the CPU from the same
    rows in a longer one, 1.9e-6 over the episode. ops/lanes.lane_mm now
    gives every row the same bits at any row count, so the split equals the
    direct call bit for bit at 2 lanes a shard and at 4 (4 shards), and a
    shard's lanes equal the direct call on those lanes alone."""
    sc, dx0, direct, res = fleet_runs
    assert torch.equal(res.sys_history, direct.sys_history)
    res4 = t_sh.fleet_runner(sc.run_batch, _cpu_mesh(4), chunk=16)(dx0)
    assert torch.equal(res4.sys_history, direct.sys_history)
    for i in (0, 30, 62):
        assert torch.equal(direct.sys_history[i:i + 2], sc.run_batch(dx0[i:i + 2]).sys_history)


def _solver_case(factory, hard_lanes: int, **kw):
    """The reference's hybrid test's scenario (N=12, q=16) and 16 lanes: a
    solver from `factory` and its inputs."""
    N, q, B = 12, 16, 16
    cfg = lt.make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
                              oracle=dataclasses.replace(cfg.oracle, q=q))
    sc = t_build(cfg, device="cpu")
    solver = factory(sc.qp, sc.A, sc.B, sc.ocp.Ks, sc.w, family="fmincon", delta=cfg.plant.ts,
                     bandwidth=cfg.oracle.bandwidth, ridge=cfg.oracle.ridge,
                     dx_ref=np.asarray(cfg.dx_ref), device="cpu", **kw)
    rng = np.random.default_rng(7)
    f32 = torch.float32
    dx = torch.tensor(DX0 + 0.01 * rng.standard_normal((B, 4)), dtype=f32)
    # lanes far from the operating point, which the fused solve flags
    dx[:hard_lanes] += torch.tensor([0.0, 0.0, 1.0, 10.0])
    win = DataWindow(torch.tensor(0.1 * rng.standard_normal((B, q, 3)), dtype=f32),
                     torch.tensor(0.001 * rng.standard_normal((B, q, 4)), dtype=f32),
                     torch.ones(B, q, dtype=f32), torch.full((B,), q, dtype=torch.int32))
    return solver, dx, win, torch.zeros(B, sc.nz)


def _hybrid_case(hard_lanes: int):
    return _solver_case(t_sqp.make_lbmpc_solver_hybrid, hard_lanes, sqp_iters=2,
                        ipm_iters=12, repair_frac=2.0 / 16, repair_sqp_iters=1,
                        repair_ipm_iters=8, repair_warm="fused")


@pytest.mark.parametrize("hard_lanes", [0, 2])
def test_split_hybrid_matches_unsplit(hard_lanes):
    """The reference's test_sharded_fused_hybrid_solve_matches_unsharded
    (N=12, q=16, B=16, repair_frac=2/B) over 8 shards, within its 2e-2;
    with 2 hard lanes both flagged lanes sit in shard 0, and the repair
    takes both (K=2 over the whole batch, not K/8 a shard)."""
    hyb, dx, win, z0 = _hybrid_case(hard_lanes)
    z_f, conv_f = hyb.fused.raw(dx, win, z0)
    assert (~conv_f).nonzero().flatten().tolist() == list(range(hard_lanes))
    z_un, conv_un = hyb(dx, win, z0)
    split = t_sh.split_solver(_cpu_mesh(), hyb)
    picked = []
    repair = hyb.repair
    hyb.repair = lambda dx_r, *a: picked.append(dx_r.shape[0]) or repair(dx_r, *a)
    z_sh, conv_sh = split(dx, win, z0)
    hyb.repair = repair
    assert np.abs(z_sh.numpy() - z_un.numpy()).max() < 2e-2
    assert torch.equal(conv_sh, conv_un)
    assert sum(picked) == hard_lanes
    if hard_lanes:
        assert not torch.equal(z_sh[:hard_lanes], z_f[:hard_lanes])   # repaired


def test_split_fleet_episode_hands_its_lanes_whole():
    """A hybrid fleet episode built on the mesh splits its own solver; the
    runner passes it the cohort whole and the episode equals the unsplit
    one to the float32 class of the split solve."""
    cfg = lt.make_preset("LBMPC_N40", iterations=2)
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=12),
                              oracle=dataclasses.replace(cfg.oracle, q=16))
    mesh = _cpu_mesh(4)
    _, run_split = t_fleet(cfg, backend="hybrid", qp_kernel="pallas_full", device="cpu",
                           repair_frac=2 / 16, mesh=mesh)
    _, run = t_fleet(cfg, backend="hybrid", qp_kernel="pallas_full", device="cpu",
                     repair_frac=2 / 16)
    assert run_split.mesh is mesh and run.mesh is None
    dx0 = torch.tensor(DX0 + np.random.default_rng(2).uniform(-0.02, 0.02, (32, 4)))
    a = t_sh.fleet_runner(run_split, mesh, chunk=16)(dx0)
    b = torch.cat([run(dx0[:16]).sys_history, run(dx0[16:]).sys_history])
    assert (a.sys_history - b).abs().max().item() < 2e-2


def test_resume_over_a_mesh_matches_uninterrupted(tmp_path):
    """The reference's test_sharded_fleet_checkpoint_resume (B=16, 12 + 12
    steps, N=8, q=8): a batched checkpoint re-sharded over 8 shards resumes
    equal to the uninterrupted run within 1e-12."""
    cfg = lt.make_preset("LBMPC_N40", iterations=24)
    cfg = dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
        solver=dataclasses.replace(cfg.solver, sqp_iters=1, ipm_iters=12),
        oracle=dataclasses.replace(cfg.oracle, q=8))
    sc = t_build(cfg, device="cpu")
    dx0 = DX0 + np.random.default_rng(3).uniform(-0.02, 0.02, (16, 4))
    full = sc.run_batch(dx0)
    part1 = t_build(dataclasses.replace(cfg, iterations=12), device="cpu").run_batch(dx0)
    p = tmp_path / "fleet_ck.npz"
    t_ck.save(p, t_ck.capture(part1, step=12), meta={"fleet": 16})
    state, meta = t_ck.load(p)
    part2 = t_ck.resume(sc, state, steps=12, mesh=_cpu_mesh())
    assert torch.equal(part1.sys_history, full.sys_history[:, :13])
    for a, b in ((part2.sys_history[:, 1:], full.sys_history[:, 13:]),
                 (part2.final_x, full.final_x), (part2.final_window.Y, full.final_window.Y)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    one = t_ck.EpisodeState(**{k: (v[0] if isinstance(v, np.ndarray) else v)
                               for k, v in vars(state).items()})
    with pytest.raises(ValueError, match="mesh resume requires a batched checkpoint"):
        t_ck.resume(sc, one, steps=1, mesh=_cpu_mesh())


V5E = {"fused_xla": dict(kkt_copies=33.0, validated_to=8192),
       "pallas_full": dict(staging=1.3, chain=0.1, validated_to=1048576)}


@pytest.mark.parametrize("kw", [
    dict(fleet=131072, mI=214),
    dict(fleet=131072, mI=214, history_bytes=8, work_bytes=8),
    dict(fleet=131072, N=100),
    dict(fleet=131072, mI=214, backend="pallas_full"),
    dict(fleet=1 << 20, mI=214, backend="pallas_full"),
    dict(fleet=1 << 21, mI=214, backend="pallas_full", warm_chain=True),
])
def test_fleet_budget_formula_matches_reference(kw, monkeypatch):
    """With the constant table set to the reference's v5e calibration and
    its 16 GiB, the port's model returns the reference's dicts for the
    calls of tests/test_runtime.py:433-455 (and the warm chain)."""
    monkeypatch.setattr(t_sh, "FLEET_BUDGET", V5E)
    args = dict(n=4, m=1, nth=1, N=20, q=32, iterations=10)
    args.update(kw)
    ref = j_sh.estimate_fleet_budget(**args)
    got = t_sh.estimate_fleet_budget(hbm_bytes=16 << 30, **args)
    assert got == ref


def test_fleet_budget_defaults_to_the_card():
    """No TPU constant carries over: without a card, hbm_bytes must be
    given; the table's pallas_full model needs less a lane than fused_xla."""
    args = dict(n=4, m=1, nth=1, N=20, q=32, iterations=10, fleet=131072, mI=214)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass hbm_bytes"):
            t_sh.estimate_fleet_budget(**args)
    x = t_sh.estimate_fleet_budget(hbm_bytes=80 << 30, **args)
    p = t_sh.estimate_fleet_budget(hbm_bytes=80 << 30, backend="pallas_full", **args)
    assert x["fits"] and p["fits"] and p["per_lane_work"] < x["per_lane_work"]
    assert set(x) == {"per_instance_out", "per_lane_work", "fleet_out", "max_chunk", "fits",
                      "validated_to"}


@pytest.mark.parametrize("shards", [2, 4])
def test_split_lane_exact_fused_solve_is_bit_for_bit(shards):
    """The kernel route's fused solve over 2 and 4 shards (8 and 4 lanes a
    shard). Its products with G and Hp take ops/lanes.exact_rows, whose
    rows do not depend on the batch's size, so the split equals the whole
    solve bit for bit; exact_rows is v @ M.T to roundoff. Below 4 lanes a
    shard the CPU's (B, 4) products in the residual (K1's plain version)
    round apart, as the per-problem stack's do (the test above); on the
    card K1 and those products keep a lane's bits at any B."""
    kw = dict(sqp_iters=2, ipm_iters=(8, 2), alphas=((1.0,), (1.0, 0.5, 0.25)),
              qp_warm=True, qp_kernel="pallas_full")
    fused, dx, win, z0 = _solver_case(t_sqp.make_lbmpc_solver_fused, 0, **kw)
    z, conv = fused(dx, win, z0)
    zs, cs = t_sh.split_solver(_cpu_mesh(shards), fused)(dx, win, z0)
    assert torch.equal(conv, cs) and torch.equal(z, zs)
    v = torch.randn(5, 21, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    M = torch.randn(214, 21, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(exact_rows(v, M), v @ M.T, rtol=0, atol=1e-12)
