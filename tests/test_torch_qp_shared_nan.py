"""K4's plain version (ops/qp_kernel.mehrotra_plain) on seeded random
strictly feasible QPs (tools/k4_reference.py --random): it summed each
Cholesky column's updates in one matrix product, and at these shapes that
rounding sent 24 of 256 lanes (mI=806, nz=8) and 12 of 256 (mI=1024, nz=8)
to NaN in float32, where the reference's kernel (build_pallas_qp_solver,
interpret mode, the same QPs) gives 2 and 0 and converges 0.988 and 0.996
of them. Taking the updates one column at a time, in the reference's order,
gives 2 and 0 NaN lanes and converges 0.977 and 0.984. The reference's
numbers are the tool's (a minute of interpret mode each, too slow here)."""

import numpy as np
import pytest
import torch

from lbmpc_tpu_torch.ops import qp_kernel

# (mI, nz): the reference's converged share and NaN lanes on the tool's QPs
REFERENCE = {(806, 8): (0.98828125, 2), (1024, 8): (0.99609375, 0)}


def _random_qp(mI, nz, lanes):
    """tools/k4_reference.random_inputs: G normal over sqrt(nz), h in [1, 2],
    one H = diag in [1, 2] + a small rank-one term, g normal (0.7)."""
    rng = np.random.default_rng(mI * 100 + nz)
    u = rng.standard_normal((nz, 1)) / np.sqrt(nz)
    H = np.eye(nz) * rng.uniform(1.0, 2.0, (nz, 1)) + 0.1 * u @ u.T
    f = lambda a: torch.tensor(np.asarray(a, np.float32))
    return (f(rng.standard_normal((mI, nz)) / np.sqrt(nz)), f(H),
            f(0.7 * rng.standard_normal((lanes, nz))), f(rng.uniform(1.0, 2.0, (lanes, mI))))


@pytest.mark.parametrize("shape", sorted(REFERENCE))
def test_shared_plain_nan_lanes_within_the_reference_class(shape):
    conv_ref, nan_ref = REFERENCE[shape]
    G, H, g, h = _random_qp(*shape, 256)
    x, conv, mu = qp_kernel.mehrotra_plain(G, H, g, h, 20)
    nan = int(torch.isnan(x).any(dim=1).sum())
    assert nan <= nan_ref + 2, nan
    assert conv.float().mean().item() >= conv_ref - 0.02


def _reference_loop(M):
    """pallas_ipm.py's chol_cols: acc = M_j - L[j, 0] L_0 - L[j, 1] L_1 ...,
    one column at a time, then the floored pivot."""
    nz = M.shape[-1]
    rows = torch.arange(nz)
    Ls = []
    for j in range(nz):
        acc = M[:, :, j]
        for k in range(j):
            acc = acc - Ls[k][:, j:j + 1] * Ls[k]
        djj = torch.sqrt(torch.clamp(acc[:, j:j + 1], min=1e-30))
        Ls.append(torch.where(rows >= j, acc / djj, 0.0))
    return torch.stack(Ls, dim=2)


@pytest.mark.parametrize("nz", [1, 8, 21, 32])
def test_column_order_cholesky_is_the_reference_loop(nz):
    """The column-order factorization equals the reference's loop bit for
    bit in float32 (a rank-one lane included: floored pivots, and past them
    the same infinities and NaNs)."""
    rng = np.random.default_rng(nz)
    A = rng.standard_normal((5, nz, nz))
    M = torch.tensor(A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(nz), dtype=torch.float32)
    M[4] = torch.tensor(np.outer(A[4, 0], A[4, 0]), dtype=torch.float32)   # rank one
    torch.testing.assert_close(qp_kernel._cholesky_floor(M, column_order=True),
                               _reference_loop(M), rtol=0, atol=0, equal_nan=True)
