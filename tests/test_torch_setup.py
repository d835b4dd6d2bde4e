"""PyTorch port, host setup: presets, plant, synthesis, sets, condensed QP.

The port (lbmpc_tpu_torch) and the JAX reference (lbmpc_tpu) get the same
inputs; host-side float64 code must agree to roundoff.
"""

import dataclasses
import subprocess
import sys
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lbmpc_tpu_torch as lt
from lbmpc_tpu_torch import config as t_config
from lbmpc_tpu_torch import interop
from lbmpc_tpu_torch.models import mgcm as t_mgcm
from lbmpc_tpu_torch.runtime import scenario as t_scenario

from lbmpc_tpu.config import make_preset
from lbmpc_tpu.models import mgcm as j_mgcm
from lbmpc_tpu.runtime.scenario import build_scenario
from lbmpc_tpu.controllers.condensed import build_fmincon_lmpc
from lbmpc_tpu.controllers.lbmpc import LBMPCWeights
from lbmpc_tpu.oracle import init_window

ROOT = pathlib.Path(__file__).resolve().parent.parent

lt.make_preset("LBMPC_N20")  # fills the preset table
PRESETS = sorted(t_config._PRESETS)


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal_field_by_field(name):
    assert dataclasses.asdict(lt.make_preset(name)) == dataclasses.asdict(make_preset(name))


def test_preset_table_matches_reference():
    from lbmpc_tpu import config as j_config

    make_preset("LMPC_N20")
    assert PRESETS == sorted(j_config._PRESETS)


@pytest.mark.parametrize("which", ["mgcm", "mg2"])
def test_dlti_matches_reference(which):
    t = getattr(t_mgcm, f"{which}_dlti")(0.01)
    j = getattr(j_mgcm, f"{which}_dlti")(0.01)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-13)


def _plant_batch(B=16, seed=0):
    rng = np.random.default_rng(seed)
    x = np.asarray(j_mgcm.MGCM_EQ_X) + np.array([0.2, 0.2, 0.3, 1.0]) * rng.uniform(-1, 1, (B, 4))
    u = j_mgcm.MGCM_EQ_U + 0.4 * rng.uniform(-1, 1, B)
    return x, u


def test_rk23_batched_matches_reference_f64():
    """Batched adaptive RK23: every lane keeps its own step sequence."""
    x, u = _plant_batch()
    ref = jax.vmap(lambda xx, uu: j_mgcm.rk23_step(xx, uu, 0.01))(
        jnp.asarray(x), jnp.asarray(u))
    got = t_mgcm.rk23_step(torch.tensor(x), torch.tensor(u), 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_rk4_matches_reference_f64():
    x, u = _plant_batch(seed=1)
    ref = j_mgcm.rk4_step(jnp.asarray(x), jnp.asarray(u), 0.01, substeps=3)
    got = t_mgcm.rk4_step(torch.tensor(x), torch.tensor(u), 0.01, substeps=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def _bench_pair(N=20, q=100):
    cfg = make_preset("LBMPC_N40")
    cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=N),
                              oracle=dataclasses.replace(cfg.oracle, q=q))
    tcfg = lt.make_preset("LBMPC_N40")
    tcfg = dataclasses.replace(tcfg, ocp=dataclasses.replace(tcfg.ocp, N=N),
                               oracle=dataclasses.replace(tcfg.oracle, q=q))
    sc = build_scenario(cfg)
    qp = build_fmincon_lmpc(
        sc.A, sc.B, sc.ocp.Ks, sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T,
        sc.ocp.LAMBDA, sc.ocp.PSI, sc.cs, N, dx_ref=np.asarray(cfg.dx_ref),
        terminal_at=cfg.ocp.terminal_at,
        tighten_first_step=cfg.ocp.tighten_first_step)
    w = LBMPCWeights.make(sc.ocp.Q, sc.ocp.R, sc.ocp.P, sc.ocp.T,
                          sc.ocp.LAMBDA, sc.ocp.PSI)
    return sc, qp, w, t_scenario.build_scenario(tcfg)


def _assert_fields_close(a, b, fields, atol):
    for f in fields:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
            continue
        np.testing.assert_allclose(np.asarray(va), np.asarray(vb), rtol=0,
                                   atol=atol, err_msg=f)


def test_bench_host_setup_matches_reference():
    """OCPMatrices, ConstraintSet and CondensedQP at LBMPC_N40 cut to N=20
    (the bench shape: G (214, 21), no split-G block)."""
    sc, qp, w, ts = _bench_pair()
    _assert_fields_close(ts.ocp, sc.ocp, [f.name for f in dataclasses.fields(ts.ocp)], 1e-12)
    _assert_fields_close(ts.cs, sc.cs, [f.name for f in dataclasses.fields(ts.cs)], 1e-12)
    _assert_fields_close(ts.qp, qp, ["H", "Gg", "g0", "G", "h0", "Hp", "Sx", "Sc"], 1e-12)
    _assert_fields_close(ts.w, w, ["Lq", "Lr", "Lp", "sqrtT", "LAMBDA", "PSI"], 1e-12)
    assert ts.qp.G.shape == (214, 21) and ts.nz == 21


def test_interop_from_reference_round_trip():
    sc, qp, w, ts = _bench_pair(N=8, q=8)
    for ref, mine in ((sc.ocp, ts.ocp), (sc.cs, ts.cs), (qp, ts.qp), (w, ts.w)):
        got = interop.from_reference(ref)
        assert type(got) is type(mine)
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(mine, f.name)
            if a is None or b is None:
                assert a is None and b is None
            else:
                np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-12)
    win = init_window(8)
    win = win._replace(X=win.X.at[3].set(jnp.asarray([1.0, 2.0, 3.0])), count=win.count + 3)
    tw = interop.from_reference(win, device="cpu")
    assert tw.X.dtype == torch.float64 and tw.count.dtype == torch.int32
    for a, b in zip(tw, win):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(TypeError):
        interop.from_reference(object())


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import sys, pkgutil, importlib\n"
        "import lbmpc_tpu_torch\n"
        "for m in pkgutil.walk_packages(lbmpc_tpu_torch.__path__, 'lbmpc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'lbmpc_tpu' or m.startswith('lbmpc_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('lbmpc_tpu_torch')]), bad)\n"
        "assert not bad, bad\n"
        "from lbmpc_tpu_torch.runtime.scenario import build_scenario\n"
        "assert build_scenario('DMS_LMPC_K').nz == 101\n"
        "import torch\n"
        "z, conv = build_scenario('LMPC_N20', device='cpu').solve(\n"
        "    torch.tensor([[-0.35, -0.4, 0.0, 0.0]]), None, None)\n"
        "assert bool(conv.all()) and z.dtype == torch.float64\n"
        "z, conv = build_scenario('REG_LMPC', device='cpu').solve(\n"
        "    torch.tensor([[-0.02, -0.016, 0.0, 0.0]]), None, torch.zeros(1, 101))\n"
        "assert bool(conv.all()) and z.dtype == torch.float64\n"
        "from lbmpc_tpu_torch.oracle import window_from_arrays\n"
        "assert int(window_from_arrays([[0.0] * 5] * 3, [[0.0] * 5] * 4, device='cpu').count) == 5\n"
        "import dataclasses\n"
        "cfg = lbmpc_tpu_torch.make_preset('DMS_LMPC')\n"
        "cfg = dataclasses.replace(cfg, ocp=dataclasses.replace(cfg.ocp, N=8),\n"
        "    solver=dataclasses.replace(cfg.solver, qp_backend='sparse_parallel'))\n"
        "z, conv = build_scenario(cfg, device='cpu').solve(\n"
        "    torch.tensor([[-0.35, -0.4, 0.0, 0.0]]), None, None)\n"
        "assert bool(conv.all()) and z.shape == (1, 9)\n"
        "for m in ('ops.chol_kernel', 'ops.ipm_fused', 'runtime.scenario', 'ops.ipm',\n"
        "          'ops.chol', 'ops.mono_kernel', 'controllers.sqp', 'controllers.lmpc',\n"
        "          'controllers.nmpc', 'models.collocation', 'models.linear',\n"
        "          'ops.riccati', 'ops.sparse_ipm', 'ops.sparse_gn', 'runtime.sharding',\n"
        "          'ops.riccati_sharded', 'entry', 'examples.fleet_100k',\n"
        "          'examples.scenario_sweep'):\n"
        "    assert 'lbmpc_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'lbmpc_tpu' or m.startswith('lbmpc_tpu.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 24


def test_tf32_is_off():
    """Full-precision float32 products for every module of the port, the
    stage-wise Riccati solvers included (the reference runs them at
    Precision.HIGHEST)."""
    import importlib
    import pkgutil

    for m in pkgutil.walk_packages(lt.__path__, "lbmpc_tpu_torch."):
        importlib.import_module(m.name)
    from lbmpc_tpu_torch.ops import sparse_gn, sparse_ipm  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_points_default_to_cuda():
    """No silent CPU path: without a card, an entry point given no device
    raises; device='cpu' is explicit."""
    if torch.cuda.is_available():
        assert lt.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lt.resolve_device()
    assert lt.resolve_device("cpu").type == "cpu"
