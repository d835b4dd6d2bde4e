"""PyTorch port, the oracle and model leftovers against the JAX reference:
oracle.window_from_arrays (equal exactly) and oracle.learned_step,
models/mgcm.nominal_step (<= 1e-13), models/linear.py (DLTIModel,
double_integrator, mgcm_dlti_model), the models package's exports, and
interop.from_reference carrying a DLTIModel and a pre-trained window."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lbmpc_tpu_torch import interop, models as t_models, oracle as t_or
from lbmpc_tpu_torch.models import linear as t_lin, mgcm as t_mgcm

from lbmpc_tpu import models as j_models, oracle as j_or
from lbmpc_tpu.models import linear as j_lin, mgcm as j_mgcm

ATOL = 1e-13


def _assert_window_equal(tw, ref):
    for a, b in zip(tw, ref):
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == (torch.int32 if b.dtype == np.int32 else torch.float64)
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("layout", ["rows", "columns"])
@pytest.mark.parametrize("k,q", [(7, 12), (30, 12), (12, 12), (9, None)])
def test_window_from_arrays_equals_reference(layout, k, q):
    """Row layout (3, k) / (4, k) as in train_data, and (k, 3) / (k, 4);
    k < q leaves the rest invalid, k > q keeps the most recent q points."""
    rng = np.random.default_rng(k)
    X, Y = rng.standard_normal((k, 3)), rng.standard_normal((k, 4))
    if layout == "rows":
        X, Y = X.T, Y.T
    tw = t_or.window_from_arrays(X, Y, q=q, device="cpu")
    _assert_window_equal(tw, j_or.window_from_arrays(X, Y, q=q))
    keep = min(k, q or k)
    assert int(tw.count) == keep and tw.count.ndim == 0
    np.testing.assert_array_equal(tw.X[:keep].numpy(), (X.T if layout == "rows" else X)[-keep:])


def test_window_from_golden_train_data_equals_reference(golden):
    data = golden("train_data")                     # (7, 500)
    for q in (64, 500, 600):
        _assert_window_equal(t_or.window_from_arrays(data[:3], data[3:7], q=q, device="cpu"),
                             j_or.window_from_arrays(data[:3], data[3:7], q=q))


def test_window_from_arrays_dtype_and_entry_device():
    w = t_or.window_from_arrays(np.ones((3, 5)), np.ones((4, 5)), q=8, dtype=torch.float32,
                                device="cpu")
    assert w.X.dtype == torch.float32 and w.count.dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_or.window_from_arrays(np.ones((3, 5)), np.ones((4, 5)))


def _seeded(B=5, q=9, seed=0):
    rng = np.random.default_rng(seed)
    dx = 0.2 * rng.standard_normal((B, 4))
    du = 0.2 * rng.standard_normal((B, 1))
    X = 0.2 * rng.standard_normal((q, 3))
    Y = 0.01 * rng.standard_normal((q, 4))
    return dx, du, X, Y


@pytest.mark.parametrize("seed", [0, 1])
def test_learned_step_matches_reference(seed):
    dx, du, X, Y = _seeded(seed=seed)
    Ad, Bd, _, _ = j_mgcm.mgcm_dlti()
    jw = j_or.window_from_arrays(X, Y)
    ref = jax.jit(jax.vmap(lambda a, b: j_or.learned_step(a, b, jnp.asarray(Ad),
                                                          jnp.asarray(Bd), jw)))(dx, du)
    tw = t_or.window_from_arrays(X, Y, device="cpu")
    got = t_or.learned_step(torch.tensor(dx), torch.tensor(du), torch.tensor(Ad),
                            torch.tensor(Bd), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    # one lane, no lane axis, as the reference calls it
    one = t_or.learned_step(torch.tensor(dx[0]), torch.tensor(du[0]), torch.tensor(Ad),
                            torch.tensor(Bd), tw)
    np.testing.assert_allclose(one.numpy(), np.asarray(ref)[0], rtol=0, atol=ATOL)


def test_learned_step_batched_windows():
    """A window per lane (the fleet's layout)."""
    B = 4
    dx, du, _, _ = _seeded(B=B, seed=3)
    rng = np.random.default_rng(3)
    X = 0.2 * rng.standard_normal((B, 9, 3))
    Y = 0.01 * rng.standard_normal((B, 9, 4))
    Ad, Bd, _, _ = j_mgcm.mgcm_dlti()
    ref = [np.asarray(j_or.learned_step(jnp.asarray(dx[i]), jnp.asarray(du[i]), jnp.asarray(Ad),
                                        jnp.asarray(Bd), j_or.window_from_arrays(X[i], Y[i])))
           for i in range(B)]
    tw = t_or.DataWindow(torch.tensor(X), torch.tensor(Y), torch.ones(B, 9),
                         torch.full((B,), 9, dtype=torch.int32))
    got = t_or.learned_step(torch.tensor(dx), torch.tensor(du), torch.tensor(Ad),
                            torch.tensor(Bd), tw)
    np.testing.assert_allclose(got.numpy(), np.stack(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("batch", [(), (6,), (2, 3)])
def test_nominal_step_matches_reference(batch):
    rng = np.random.default_rng(len(batch))
    Ad, Bd, _, _ = j_mgcm.mgcm_dlti()
    dx = rng.standard_normal(batch + (4,))
    du = rng.standard_normal(batch + (1,))
    ref = j_mgcm.nominal_step(jnp.asarray(dx), jnp.asarray(du), jnp.asarray(Ad), jnp.asarray(Bd))
    got = t_mgcm.nominal_step(torch.tensor(dx), torch.tensor(du), torch.tensor(Ad),
                              torch.tensor(Bd))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    # the reference's own check (tests/test_models.py:84)
    np.testing.assert_allclose(got.numpy(), dx @ Ad.T + du @ Bd.T, rtol=0, atol=ATOL)


@pytest.mark.parametrize("factory", ["double_integrator", "mgcm_dlti_model"])
def test_dlti_models_equal_reference(factory):
    t, j = getattr(t_lin, factory)(), getattr(j_lin, factory)()
    assert dataclasses.fields(t_lin.DLTIModel) and (t.n, t.m, t.o, t.ts) == (j.n, j.m, j.o, j.ts)
    for f in ("A", "B", "C", "D"):
        np.testing.assert_allclose(getattr(t, f), getattr(j, f), rtol=0, atol=1e-13)


def test_models_package_exports_match_reference():
    names = ("MGCM_EQ_X", "MGCM_EQ_U", "mgcm_ode", "rk4_step", "rk23_step", "mgcm_dlti",
             "nominal_step", "DLTIModel", "double_integrator")
    for name in names:
        assert hasattr(t_models, name) and hasattr(j_models, name), name
    np.testing.assert_array_equal(t_models.MGCM_EQ_X, j_models.MGCM_EQ_X)
    assert t_models.MGCM_EQ_U == j_models.MGCM_EQ_U


@pytest.mark.parametrize("factory", ["double_integrator", "mgcm_dlti_model"])
def test_from_reference_carries_a_dlti_model(factory):
    j = getattr(j_lin, factory)()
    t = interop.from_reference(j)
    assert isinstance(t, t_lin.DLTIModel)
    for f in ("A", "B", "C", "D"):
        got = getattr(t, f)
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_array_equal(got, np.asarray(getattr(j, f)))
    assert t.ts == j.ts and (t.n, t.m, t.o) == (j.n, j.m, j.o)


def test_from_reference_carries_a_pretrained_window(golden):
    data = golden("train_data")
    jw = j_or.window_from_arrays(data[:3], data[3:7], q=64)
    tw = interop.from_reference(jw, device="cpu")
    _assert_window_equal(tw, jw)
    _assert_window_equal(tw, t_or.window_from_arrays(data[:3], data[3:7], q=64, device="cpu"))
