"""PyTorch port, analysis layer: response metrics, solve statistics,
comparison tables, plots and the roofline's counts, against the JAX package
on the same seeded numpy inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lbmpc_tpu_torch.analysis import compare as t_compare
from lbmpc_tpu_torch.analysis import metrics as t_metrics
from lbmpc_tpu_torch.analysis import roofline as t_roofline
from lbmpc_tpu_torch.analysis.solve_stats import SolveStats as TSolveStats

from lbmpc_tpu.analysis import compare as j_compare
from lbmpc_tpu.analysis import metrics as j_metrics
from lbmpc_tpu.analysis import roofline as j_roofline
from lbmpc_tpu.analysis.solve_stats import SolveStats as JSolveStats

TS = 0.01


def _responses(B=6, T=120, seed=0):
    """(B, T) step-like responses: decaying, oscillating, one flat lane."""
    rng = np.random.default_rng(seed)
    t = TS * np.arange(T)
    tau = rng.uniform(0.05, 0.3, (B, 1))
    w = rng.uniform(5.0, 30.0, (B, 1))
    x = 1.0 - np.exp(-t / tau) * np.cos(w * t) + 1e-3 * rng.standard_normal((B, T))
    x[-1] = 1.0
    u = rng.standard_normal((B, T))
    ref = np.ones((B, T)) + 0.1 * rng.standard_normal((B, 1))
    return x, u, ref


@pytest.mark.parametrize("part", ["response_info", "ctrl_error", "ctrl_energy",
                                  "overshoot_pct", "settling_time"])
def test_metrics_match_reference(part):
    """Each metric on (B, T) float64 data within 1e-12 of the reference; the
    result keeps the input's dtype and batch shape."""
    x, u, ref = _responses()
    tx, tu, tr = (torch.as_tensor(a) for a in (x, u, ref))
    jx, ju, jr = (jnp.asarray(a) for a in (x, u, ref))
    args = {"response_info": ((tx, tu, tr, TS), (jx, ju, jr, TS)),
            "ctrl_error": ((tx, tr, TS), (jx, jr, TS)),
            "ctrl_energy": ((tu, TS), (ju, TS)),
            "overshoot_pct": ((tx, tr[:, -1]), (jx, jr[:, -1])),
            "settling_time": ((tx, tr[:, -1], TS), (jx, jr[:, -1], TS))}[part]
    got = getattr(t_metrics, part)(*args[0])
    want = getattr(j_metrics, part)(*args[1])
    got = got if part == "response_info" else (got,)
    want = want if part == "response_info" else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == (x.shape[0],)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-12)


def test_settling_time_batches_over_leading_axes():
    """A (2, 3, T) batch equals its lanes one by one (the reference's own
    batched case, tests/test_analysis.py:36-43, on two leading axes)."""
    x, _, ref = _responses(B=6)
    tx = torch.as_tensor(x).reshape(2, 3, -1)
    rf = torch.as_tensor(ref[:, -1]).reshape(2, 3)
    st = t_metrics.settling_time(tx, rf, TS)
    assert st.shape == (2, 3)
    for i in range(2):
        for j in range(3):
            assert st[i, j] == t_metrics.settling_time(tx[i, j], rf[i, j], TS)


def test_solve_stats_reproduce_reference_baseline(golden):
    """The reference's test_solve_stats_reproduce_reference_baseline
    (tests/test_parity_sweep.py:372-404) on the port's SolveStats: the
    reference's own raw solve-time samples (tracking-NMPC and -LMPC on the
    AMD and Intel CPUs, regular-NMPC on the AMD CPU) give the published
    baseline table with the reference test's tolerances, and every
    configuration misses the 10 ms real-time budget."""
    nmpc = TSolveStats.from_samples(golden("solve_sample_full"))
    assert nmpc.n == 2500
    assert abs(nmpc.mean_ms - 429.7) < 0.5
    assert abs(nmpc.median_ms - 340.6) < 0.5
    assert abs(nmpc.p99_ms - 777.3) < 0.5
    assert abs(nmpc.max_ms - 908.0) < 1.0
    lmpc = TSolveStats.from_samples(golden("intelCPU_solve_sample_fullLMPC"))
    assert abs(lmpc.mean_ms - 115.0) < 0.5
    assert abs(lmpc.median_ms - 95.6) < 0.5
    assert abs(lmpc.p99_ms - 228.0) < 0.5
    nmpc_i = TSolveStats.from_samples(golden("intelCPU_solve_sample_full"))
    assert abs(nmpc_i.mean_ms - 257.7) < 0.5
    assert abs(nmpc_i.median_ms - 192.2) < 0.5
    assert abs(nmpc_i.p99_ms - 471.0) < 0.5
    reg = TSolveStats.from_samples(golden("solve_sample_reg"))
    assert abs(reg.mean_ms - 343.3) < 0.5
    assert abs(reg.median_ms - 280.2) < 0.5
    assert abs(reg.p99_ms - 555.9) < 0.5
    assert all(s.violates_budget(10.0) for s in (nmpc, lmpc, nmpc_i, reg))


def test_solve_stats_equal_on_the_same_samples():
    rng = np.random.default_rng(0)
    samples = np.abs(rng.normal(0.115, 0.02, (5, 500)))
    got, want = TSolveStats.from_samples(samples), JSolveStats.from_samples(samples)
    assert got.__dict__ == want.__dict__
    assert got.violates_budget(10.0) == want.violates_budget(10.0)
    assert got.violates_budget(1000.0) == want.violates_budget(1000.0)


def _history(T=200, seed=0, n=4):
    rng = np.random.default_rng(seed)
    t = np.arange(T)[:, None]
    x = np.exp(-t / 40.0) * (0.3 + 0.1 * rng.standard_normal((1, n)))
    u = 1.0 + np.exp(-t / 30.0) * 0.2
    return np.concatenate([x, u[:, :1]], axis=1)


def test_comparison_and_sweep_tables_equal():
    """comparison_table and sweep_table equal the reference's, within 1e-12
    (float64); the port also takes tensors and its ClosedLoopResult."""
    hists = {"LBMPC": _history(seed=0), "LMPC": _history(seed=1).T}
    for ch in (0, 2):
        got = t_compare.comparison_table(hists, TS, channel=ch, ref_value=0.01)
        want = j_compare.comparison_table(hists, TS, channel=ch, ref_value=0.01)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(list(got[k].values()), list(want[k].values()),
                                       rtol=0, atol=1e-12)
    sweep = {50: _history(seed=2), 60: _history(seed=3), 80: _history(seed=4)}
    got, want = t_compare.sweep_table(sweep, TS), j_compare.sweep_table(sweep, TS)
    assert list(got) == list(want) == ["50", "60", "80"]
    for k in got:
        np.testing.assert_allclose(list(got[k].values()), list(want[k].values()),
                                   rtol=0, atol=1e-12)
    from lbmpc_tpu_torch.runtime.closed_loop import ClosedLoopResult

    h = _history(seed=0)
    res = ClosedLoopResult(torch.as_tensor(h), None, None, None)
    assert t_compare.comparison_table({"a": res}, TS) == t_compare.comparison_table(
        {"a": torch.as_tensor(h)}, TS) == t_compare.comparison_table({"a": h}, TS)


def test_plots_render_to_files(tmp_path):
    """plot_response, plot_state_space, overlay_histories and
    solve_stats_figure draw and save (matplotlib, imported by the call)."""
    from lbmpc_tpu_torch.analysis.plots import plot_response, plot_state_space
    from lbmpc_tpu_torch.sets.polytope import box

    h = _history(seed=0)
    plot_response(torch.as_tensor(h), art_ref=h[:, 0] * 0.5, save_path=tmp_path / "r.png")
    plot_state_space(h[:, 0], h[:, 1], sets=[(box([-1, -1], [1, 1]), "X")],
                     save_path=tmp_path / "ss.png")
    fig = t_compare.overlay_histories({"a": h, "b": _history(seed=1)}, TS, refs=np.zeros(5),
                                      save_path=tmp_path / "o.png")
    assert len(fig.axes) == 5 and all(len(ax.lines) == 3 for ax in fig.axes)
    samples = np.abs(np.random.default_rng(1).normal(0.115, 0.02, (5, 100)))
    _, st = t_compare.solve_stats_figure(samples, save_path=tmp_path / "s.png")
    assert st == TSolveStats.from_samples(samples)
    for name in ("r", "ss", "o", "s"):
        assert (tmp_path / f"{name}.png").stat().st_size > 1000


def test_roofline_counts_equal_at_the_bench_shape():
    """assembly_mac_ratio, fused_sqp_flops_per_solve and fused_sqp_op_split
    equal the reference's numbers exactly at the bench shape (the port's op
    classes are the reference's mxu and vpu under the card's names)."""
    from lbmpc_tpu.ops.pallas_ipm import assembly_mac_ratio
    from lbmpc_tpu_torch import make_preset
    from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

    cfg = make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=20),
                              oracle=dataclasses.replace(cfg.oracle, q=100))
    G = t_build(cfg, device="cpu").qp.G
    assert G.shape == (214, 21)
    ratio = t_roofline.assembly_mac_ratio(G)
    assert ratio == assembly_mac_ratio(G)
    kw = dict(sqp_iters=2, ipm_iters=5, n_merit=2, N=20, n=4, m=1, q=100, mc=214, ne=98,
              nz=21, kkt_mac_ratio=ratio)
    assert t_roofline.fused_sqp_flops_per_solve(**kw) == j_roofline.fused_sqp_flops_per_solve(**kw)
    got, want = t_roofline.fused_sqp_op_split(**kw), j_roofline.fused_sqp_op_split(**kw)
    assert (got["matmul"], got["elementwise"]) == (want["mxu"], want["vpu"])
    rng = np.random.default_rng(0)
    Gr = rng.standard_normal((300, 40)) * (rng.uniform(size=(300, 40)) > 0.5)
    assert t_roofline.assembly_mac_ratio(Gr) == assembly_mac_ratio(Gr)


def test_roofline_in_h100_units():
    """The peaks are the H100's, the bound names the card's resources, and
    program_costs counts torch's matrix products and the call's bytes."""
    r = t_roofline.Roofline(flops_per_call=6.7e10, bytes_per_call=3.35e6, call_s=1.25e-3,
                            solves_per_call=1000, matmul_flops_per_call=6e10,
                            elementwise_flops_per_call=0.7e10)
    assert (r.peak_flops, r.peak_bytes_s) == (67e12, 3.35e12)
    assert r.flop_util == pytest.approx(0.8) and r.bound == "FP32"
    assert r.sol_s == pytest.approx(1e-3 + 1e-6)
    d = r.as_dict()
    assert not any(k for k in d if any(w in k.lower() for w in ("mxu", "vpu", "bf16", "tpu")))
    assert t_roofline.Roofline(1e6, 1e6, 1.0, 1).bound == "issue/overhead"
    assert t_roofline.Roofline(1e6, 3e12, 1.0, 1).bound == "HBM"
    a, b = torch.ones(8, 16, 32), torch.ones(8, 32, 4)
    flops, byts = t_roofline.program_costs(lambda x, y: torch.bmm(x, y) + 1.0, a, b)
    assert flops == 2 * 8 * 16 * 32 * 4
    assert byts == 4 * (a.numel() + b.numel() + 8 * 16 * 4)
    rl = t_roofline.measure_roofline(torch.bmm, (a, b), call_s=1e-3, solves_per_call=8)
    assert rl.flops_per_solve == 2 * 16 * 32 * 4
