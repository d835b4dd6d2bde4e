"""PyTorch port, runtime/checkpoint: the npz round trip, files crossing
between the two packages, resumed-equals-uninterrupted for one lane and a
batch (1e-12, float64), and a JAX-captured checkpoint resumed in the port
against the JAX package's own resume from it.

Small scenarios, as tests/test_runtime.py:23-30: LBMPC_N40 cut to N=8,
q=16, sqp 1, ipm 10; the casadi family (DMS_LBMPC_q100 cut the same way)
for its warm start, which reads dx_used and dx_next."""

import dataclasses

import numpy as np
import pytest
import torch

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch import interop
from lbmpc_tpu_torch.runtime import checkpoint as t_ck
from lbmpc_tpu_torch.runtime.scenario import build_scenario as t_build

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.runtime import checkpoint as j_ck
from lbmpc_tpu.runtime.scenario import build_scenario as j_build

PRESETS = {"fmincon": "LBMPC_N40", "casadi": "DMS_LBMPC_q100"}
FIRST, REST = 3, 3


def _small(preset, family, iterations):
    cfg = preset(PRESETS[family], iterations=iterations)
    return dataclasses.replace(
        cfg, ocp=dataclasses.replace(cfg.ocp, N=8),
        solver=dataclasses.replace(cfg.solver, sqp_iters=1, ipm_iters=10, dtype="float64"),
        oracle=dataclasses.replace(cfg.oracle, q=16))


def _states(cfg, B, seed=0):
    x0 = (np.asarray(cfg.x_init_abs) - np.asarray(cfg.plant.x_wp) if cfg.family == "casadi"
          else np.asarray(cfg.dx_init))
    return x0 + 0.005 * np.random.default_rng(seed).standard_normal((B, 4))


def _state(rng, B=4):
    return dict(step=42, x_abs=rng.standard_normal((B, 4)),
                window_X=rng.standard_normal((B, 16, 3)),
                window_Y=rng.standard_normal((B, 16, 4)),
                window_valid=np.ones((B, 16)), window_count=np.full(B, 16, np.int32),
                z_warm=rng.standard_normal((B, 9)))


def test_checkpoint_roundtrip(tmp_path):
    st = t_ck.EpisodeState(**_state(np.random.default_rng(0)),
                           rng_key=np.array([0, 7], np.uint32))
    p = tmp_path / "sub" / "ck.npz"
    t_ck.save(p, st, meta={"preset": "LBMPC_N40"})
    st2, meta = t_ck.load(p)
    assert st2.step == 42 and meta == {"preset": "LBMPC_N40"}
    for f in ("x_abs", "window_X", "window_Y", "window_valid", "window_count", "z_warm",
              "rng_key"):
        np.testing.assert_array_equal(getattr(st, f), getattr(st2, f))
    assert st2.rng_key.dtype == np.uint32
    t_ck.save(p, dataclasses.replace(st, rng_key=None))
    assert t_ck.load(p)[0].rng_key is None
    np.savez(p, format_version=2)
    with pytest.raises(ValueError, match="format"):
        t_ck.load(p)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_cross_between_packages(tmp_path, writer):
    """A file written by either package's save loads in the other's load,
    every array and the meta equal."""
    fields = _state(np.random.default_rng(1))
    p = tmp_path / "ck.npz"
    (j_ck if writer == "jax" else t_ck).save(
        p, (j_ck if writer == "jax" else t_ck).EpisodeState(**fields), meta={"fleet": 4})
    st, meta = (t_ck if writer == "jax" else j_ck).load(p)
    assert meta == {"fleet": 4} and st.step == 42 and st.rng_key is None
    for k, v in fields.items():
        np.testing.assert_array_equal(getattr(st, k), v)


@pytest.mark.parametrize("family", ["fmincon", "casadi"])
@pytest.mark.parametrize("B", [None, 4])
def test_resume_equals_uninterrupted(tmp_path, family, B):
    """FIRST steps, capture, save and load through disk, resume REST more:
    the concatenated histories, final_x, final_z and the final window equal
    the uninterrupted run to 1e-12, the histories bit for bit (one lane
    through episode_from, B lanes through episode_from_batch), and the
    window's count and valid carry across."""
    cfg = _small(lt.make_preset, family, FIRST + REST)
    sc = t_build(cfg, device="cpu")
    short = t_build(dataclasses.replace(cfg, iterations=FIRST), device="cpu")
    dx = _states(cfg, B or 1)
    if B is None:
        dx = dx[0]
        full, part1 = sc.run(dx), short.run(dx)
    else:
        full, part1 = sc.run_batch(dx), short.run_batch(dx)
    p = tmp_path / "ck.npz"
    t_ck.save(p, t_ck.capture(part1, step=FIRST), meta={"preset": cfg.name})
    state, meta = t_ck.load(p)
    assert state.step == FIRST and meta["preset"] == cfg.name
    assert state.x_abs.shape == ((4,) if B is None else (B, 4))
    part2 = t_ck.resume(sc, state, steps=REST)
    h_full, h1, h2 = (r.sys_history.numpy() for r in (full, part1, part2))
    np.testing.assert_array_equal(h1, h_full[..., :FIRST + 1, :])
    np.testing.assert_allclose(h2[..., 1:, :], h_full[..., FIRST + 1:, :], rtol=0, atol=1e-12)
    # resume starts from the checkpoint's x_abs itself, so the resumed
    # steps repeat the uninterrupted computation bit for bit
    np.testing.assert_array_equal(h2[..., 1:, :], h_full[..., FIRST + 1:, :])
    for a, b in ((part2.final_x, full.final_x), (part2.final_z, full.final_z),
                 (part2.final_window.X, full.final_window.X),
                 (part2.final_window.Y, full.final_window.Y),
                 (part2.art_history, full.art_history[..., FIRST:, :])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(part2.final_window.valid, full.final_window.valid)
    assert torch.equal(part2.final_window.count, full.final_window.count)
    assert int(full.final_window.count.reshape(-1)[0]) == 1 + FIRST + REST
    assert bool(full.solver_converged.all())


def test_resume_from_a_jax_checkpoint_matches_the_reference(tmp_path):
    """A checkpoint the JAX package captured and saved, resumed in the port,
    against the JAX package's own resume from it: histories, final_x and the
    final window within 1e-7, the port's scenario episodes' tolerance
    against the reference (tests/test_torch_nmpc.py); interop carries the
    JAX EpisodeState across equal."""
    cfg = _small(make_preset, "fmincon", FIRST)
    part1 = j_build(cfg).run()
    jstate = j_ck.capture(part1, step=FIRST)
    p = tmp_path / "jax_ck.npz"
    j_ck.save(p, jstate, meta={"preset": cfg.name})
    ref = j_ck.resume(j_build(_small(make_preset, "fmincon", FIRST + REST)), jstate,
                      steps=REST)
    state, _ = t_ck.load(p)
    carried = interop.from_reference(jstate)
    for f in ("x_abs", "window_X", "window_Y", "window_valid", "window_count", "z_warm"):
        np.testing.assert_array_equal(getattr(carried, f), getattr(state, f))
    port = t_ck.resume(t_build(_small(lt.make_preset, "fmincon", FIRST + REST), device="cpu"),
                       state, steps=REST)
    for a, b in ((port.sys_history, ref.sys_history), (port.final_x, ref.final_x),
                 (port.final_window.Y, ref.final_window.Y), (port.final_z, ref.final_z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
    assert int(port.final_window.count) == int(np.asarray(ref.final_window.count))
    np.testing.assert_array_equal(port.solver_converged.numpy(),
                                  np.asarray(ref.solver_converged))


def test_resume_on_a_mesh_belongs_to_the_multi_device_slice():
    """resume(mesh=) re-shards a batched checkpoint over a scenario mesh
    (runtime/sharding; tests/test_torch_sharding.py); an unbatched one
    raises, with the reference's message."""
    from lbmpc_tpu_torch.runtime.sharding import scenario_mesh

    st = t_ck.EpisodeState(**{k: v[0] if isinstance(v, np.ndarray) else v
                              for k, v in _state(np.random.default_rng(2)).items()})
    with pytest.raises(ValueError, match="mesh resume requires a batched checkpoint"):
        t_ck.resume(None, st, steps=1, mesh=scenario_mesh(devices=["cpu"] * 2))


def test_batched_resume_keeps_the_sparse_parallel_guard(monkeypatch):
    """A batched checkpoint resumes through Scenario.episode_from_batch,
    which keeps run_batch's sparse_parallel memory guard (here a card of
    64 MiB)."""
    from lbmpc_tpu_torch.runtime import scenario as t_scenario

    cfg = lt.make_preset("DMS_LMPC", iterations=1)
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=10),
                              solver=dataclasses.replace(cfg.solver,
                                                         qp_backend="sparse_parallel"))
    sc = t_build(cfg, device="cpu")
    monkeypatch.setattr(t_scenario, "_device_memory", lambda dev: 64 << 20)
    lanes = t_scenario.sparse_parallel_limit(sc, torch.device("cpu"), torch.float64) // 10 + 1
    q, nz = cfg.oracle.q, sc.nz
    st = t_ck.EpisodeState(step=0, x_abs=np.tile(np.asarray(cfg.plant.x_wp), (lanes, 1)),
                           window_X=np.zeros((lanes, q, 3)), window_Y=np.zeros((lanes, q, 4)),
                           window_valid=np.zeros((lanes, q)),
                           window_count=np.zeros(lanes, np.int32), z_warm=np.zeros((lanes, nz)))
    with pytest.raises(ValueError, match="sparse_parallel"):
        t_ck.resume(sc, st, steps=1)
