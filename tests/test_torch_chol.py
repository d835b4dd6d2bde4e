"""PyTorch port, the K5 batched Cholesky kernels' plain versions
(ops/chol_kernel on the CPU) against the reference's Pallas kernels
(ops/pallas_chol in interpret mode), the factor-store and refactor routes at
the DMS flagship's n=101, the pivot floor, and the K5a -> K5c layout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lbmpc_tpu_torch.ops import chol_kernel as ck

from lbmpc_tpu.ops.pallas_chol import chol_factor_solve, chol_resolve, chol_solve


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    M = (A @ np.swapaxes(A, 1, 2) + n * np.eye(n)).astype(np.float32)
    return M, rng.standard_normal((B, n)).astype(np.float32)


def _unpack(L_flat, n):
    """The reference's L_flat: row j*n_p + i holds L[i, j]."""
    B, n2 = L_flat.shape
    n_p = int(round(np.sqrt(n2)))
    return np.swapaxes(np.asarray(L_flat).reshape(B, n_p, n_p), 1, 2)[:, :n, :n]


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_plain_versions_match_the_pallas_kernels():
    """n=21, B=128, one 128-lane tile (tests/test_ipm_fused.py:13-25):
    K5a, K5b and K5c against chol_factor_solve, chol_solve and chol_resolve
    in interpret mode, to float32 roundoff (relative 1e-5)."""
    B, n = 128, 21
    M, b = _spd(B, n, 0)
    b2 = np.random.default_rng(1).standard_normal((B, n)).astype(np.float32)
    L_flat, x_ref = chol_factor_solve(jnp.asarray(M), jnp.asarray(b), tile=128,
                                      interpret=True)
    x2_ref = chol_resolve(L_flat, jnp.asarray(b2), n, tile=128, interpret=True)
    xs_ref = chol_solve(jnp.asarray(M), jnp.asarray(b), tile=128, interpret=True)
    Mt, bt, b2t = torch.tensor(M), torch.tensor(b), torch.tensor(b2)
    L, x = ck.chol_factor_solve(Mt, bt)
    assert _rel(L.numpy(), _unpack(L_flat, n)) < 1e-5
    assert _rel(x.numpy(), x_ref) < 1e-5
    assert _rel(ck.chol_resolve(L, b2t).numpy(), x2_ref) < 1e-5
    assert _rel(ck.chol_solve(Mt, bt).numpy(), xs_ref) < 1e-5


def test_store_and_refactor_routes_agree_at_the_dms_shape():
    """n=101 (the DMS flagship's nz): K5a + K5c and K5b twice give the same
    x, and both solve M x = b (no interpret run at n_p=104: too slow)."""
    B, n = 16, 101
    M, b = _spd(B, n, 2)
    b2 = np.random.default_rng(3).standard_normal((B, n)).astype(np.float32)
    Mt, bt, b2t = torch.tensor(M), torch.tensor(b), torch.tensor(b2)
    L, x = ck.chol_factor_solve(Mt, bt)
    x2 = ck.chol_resolve(L, b2t)
    assert torch.equal(x, ck.chol_solve(Mt, bt))
    assert torch.equal(x2, ck.chol_solve(Mt, b2t))
    for xt, rhs in ((x, b), (x2, b2)):
        ref = np.linalg.solve(M.astype(np.float64), rhs.astype(np.float64)[..., None])[..., 0]
        assert _rel(xt.numpy(), ref) < 1e-4


def test_pivot_floor_matches_the_pallas_kernel():
    """A singular and an indefinite pivot: acc_jj = 0 gives L_jj = 0 and
    acc_jj < 0 gives acc_jj / sqrt(1e-30), as in _chol_cols — no NaN in L."""
    B, n = 128, 8       # one full tile: a Pallas grid of B // 128 programs
    M = np.diag([4.0, 0.0, -1.0, 9.0, 1.0, 2.0, 3.0, 5.0]).astype(np.float32)
    M = np.broadcast_to(M, (B, n, n)).copy()
    L_flat, _ = chol_factor_solve(jnp.asarray(M), jnp.ones((B, n), jnp.float32),
                                  tile=128, interpret=True)
    L, _ = ck.chol_factor_solve(torch.tensor(M), torch.ones(B, n))
    diag = torch.diagonal(L[0]).numpy()
    np.testing.assert_allclose(diag, np.diagonal(_unpack(L_flat, n)[0]), rtol=1e-6)
    np.testing.assert_allclose(diag[:4], [2.0, 0.0, -1e15, 3.0], rtol=1e-6)
    assert bool(torch.isfinite(L).all())


def test_factor_to_resolve_layout_is_pinned():
    """K5a emits L as (B, n, n) row-major float32, lower triangle with the
    diagonal and exact zeros above, and K5c reads it as it is: L L' = M, lane
    b's re-solve depends on lane b's L only, and nothing above the diagonal
    is read (NaN there changes nothing)."""
    B, n = 32, 21
    M, b = _spd(B, n, 4)
    Mt, bt = torch.tensor(M), torch.tensor(b)
    L, x = ck.chol_factor_solve(Mt, bt)
    assert L.shape == (B, n, n) and L.dtype == torch.float32 and L.is_contiguous()
    assert torch.equal(torch.triu(L, diagonal=1), torch.zeros_like(L))
    assert _rel((L @ L.transpose(1, 2)).numpy(), M) < 1e-5
    perm = torch.randperm(B, generator=torch.Generator().manual_seed(0))
    xp = ck.chol_resolve(L[perm].contiguous(), bt[perm])
    assert (xp - x[perm]).abs().max() < 1e-6
    poisoned = L + torch.triu(torch.full((n, n), float("nan")), diagonal=1)
    assert torch.equal(ck.chol_resolve(poisoned, bt), ck.chol_resolve(L, bt))


def test_store_switch_and_cpu_routing(monkeypatch):
    assert ck.factor_store_feasible()
    monkeypatch.setenv("LBMPC_CHOL_STORE", "0")
    assert not ck.factor_store_feasible()
    M, b = _spd(4, 5, 5)
    Mt, bt = torch.tensor(M), torch.tensor(b)
    n0 = [k.launches for k in ck.KERNELS]
    L, x = ck.chol_factor_solve(Mt, bt)
    Lp, xp = ck.chol_factor_solve_plain(Mt, bt)
    assert torch.equal(L, Lp) and torch.equal(x, xp)
    assert [k.launches for k in ck.KERNELS] == n0
    with pytest.raises(ValueError, match="cuda or cpu"):
        ck.chol_solve(Mt.to("meta"), bt.to("meta"))
