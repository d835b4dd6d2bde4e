"""PyTorch port, ops/riccati_sharded: the stage-sharded Riccati sweep on 8
CPU shards against the JAX package's on its 8-device mesh, against both
packages' single-device cross-term sweep (_riccati_cross), and
solve_sparse_gn(mesh=) against mesh=None. The reference's N=300 gate runs
with RUN_SLOW=1."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lbmpc_tpu_torch import interop
from lbmpc_tpu_torch.ops import riccati_sharded as t_rs
from lbmpc_tpu_torch.ops import sparse_gn as t_gn

from lbmpc_tpu.ops import riccati_sharded as j_rs
from lbmpc_tpu.ops import sparse_gn as j_gn

from test_torch_sparse_gn import _gn_case, _lanes

SLOW = bool(os.environ.get("RUN_SLOW"))


def _problem(N, nw, m, K, rng):
    """tests/test_riccati_sharded.py's problem, float64."""
    As = 0.95 * rng.standard_normal((N, nw, nw)) / np.sqrt(nw)
    Bs = rng.standard_normal((N, nw, m))
    Mq = rng.standard_normal((N, nw, nw)) / np.sqrt(nw)
    Qs = Mq @ Mq.transpose(0, 2, 1) + 0.1 * np.eye(nw)
    Rs = (np.broadcast_to(np.eye(m), (N, m, m)).copy()
          + 0.1 * np.abs(rng.standard_normal((N, 1, 1))) * np.eye(m))
    Ss = 0.05 * rng.standard_normal((N, nw, m))
    qs = rng.standard_normal((N, nw, K))
    rs = rng.standard_normal((N, m, K))
    Mp = rng.standard_normal((nw, nw)) / np.sqrt(nw)
    return As, Bs, Qs, Ss, Rs, qs, rs, Mp @ Mp.T + 0.1 * np.eye(nw), rng.standard_normal((nw, K))


@pytest.mark.parametrize("N,nw,m,K", [(64, 4, 2, 1), (61, 8, 1, 3)])
def test_split_sweep_matches_both_packages(N, nw, m, K):
    """Float64 at (64, 4, 2, 1) and (61, 8, 1, 3), the latter padded to 64
    with identity stages: the port's split sweep against the JAX package's
    and against both packages' _riccati_cross, within 1e-10 * scale."""
    args = _problem(N, nw, m, K, np.random.default_rng(0))
    W, C = t_rs.lqr_cross_sharded(t_rs.stage_mesh(devices=["cpu"] * 8),
                                  *(torch.tensor(a) for a in args))
    assert W.shape == (N + 1, nw, K) and C.shape == (N, m, K)
    Wj, Cj = jax.jit(lambda *a: j_rs.lqr_cross_sharded(j_rs.stage_mesh(8), *a))(
        *(jnp.asarray(a) for a in args))
    sw, sc = np.abs(np.asarray(Wj)).max() + 1.0, np.abs(np.asarray(Cj)).max() + 1.0
    assert np.abs(W.numpy() - np.asarray(Wj)).max() < 1e-10 * sw
    assert np.abs(C.numpy() - np.asarray(Cj)).max() < 1e-10 * sc
    As, Bs, Qs, Ss, Rs, qs, rs, PN, pN = args
    for k in range(K):
        Wr, Cr = j_gn._riccati_cross(As, Bs, Qs, Ss, Rs, qs[..., k], rs[..., k], PN, pN[..., k])
        Wt, Ct = t_gn._riccati_cross(*(torch.tensor(a)[None] for a in (
            As, Bs, Qs, Ss, Rs, qs[..., k], rs[..., k], PN, pN[..., k])))
        for got in (W[..., k].numpy(), Wt[0].numpy()):
            assert np.abs(got - np.asarray(Wr)).max() < 1e-10 * sw
        for got in (C[..., k].numpy(), Ct[0].numpy()):
            assert np.abs(got - np.asarray(Cr)).max() < 1e-10 * sc


def test_split_sweep_float32_class():
    """Float32 stays within 1e-3 * scale of the float64 split sweep
    (tests/test_riccati_sharded.py::test_sharded_f32_class); lanes on a
    leading axis split alike."""
    args = _problem(96, 8, 1, 2, np.random.default_rng(1))
    mesh = t_rs.stage_mesh(devices=["cpu"] * 8)
    W32, _ = t_rs.lqr_cross_sharded(mesh, *(torch.tensor(a, dtype=torch.float32)
                                            for a in args))
    W64, _ = t_rs.lqr_cross_sharded(mesh, *(torch.tensor(a) for a in args))
    assert W32.dtype == torch.float32
    assert (W32.double() - W64).abs().max().item() < 1e-3 * (W64.abs().max().item() + 1.0)
    lanes = [torch.tensor(a)[None].repeat((3,) + (1,) * np.ndim(a)) for a in args]
    Wl, _ = t_rs.lqr_cross_sharded(mesh, *lanes)
    assert Wl.shape == (3,) + tuple(W64.shape) and torch.equal(Wl[2], W64)


def _mesh_solve(N):
    _, _, _, sg, _, _, args = _gn_case("casadi", "first", True, N=N)
    qp = interop.from_reference(sg, device="cpu")
    lanes = _lanes(args)
    un = t_gn.solve_sparse_gn(qp, *lanes, iters=25)
    sh = t_gn.solve_sparse_gn(qp, *lanes, iters=25, mesh=t_rs.stage_mesh(devices=["cpu"] * 8))
    assert bool(un.converged[0]) and bool(sh.converged[0])
    scale = un.dC.abs().max().item() + 1.0
    assert (sh.dC - un.dC).abs().max().item() < 1e-7 * scale
    assert (sh.dth - un.dth).abs().max().item() < 1e-7 * scale


def test_stage_sharded_gn_matches_unsharded():
    """The stage-form GN subproblem (casadi family, tightened first step,
    terminal at x_1) at N=12 over 8 stage shards (12 is not a multiple of
    8: the padding) against mesh=None within 1e-7 * scale."""
    _mesh_solve(12)


@pytest.mark.skipif(not SLOW, reason="RUN_SLOW: the reference's N=300 gate (minutes)")
def test_stage_sharded_gn_matches_unsharded_N300():
    """tests/test_sparse_gn.py::test_stage_sharded_gn_matches_unsharded_N300."""
    _mesh_solve(300)
