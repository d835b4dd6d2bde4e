"""Batched small-matrix Cholesky and triangular solves (plain PyTorch).

Port of lbmpc_tpu/ops/chol.py, which hand-rolls the factorization as a
column loop (n rank-1 updates, each pivot floored at 1e-300) because XLA's
blocked Cholesky lowers badly for tiny systems on the TPU. Here the batched
library routines take its place (`torch.linalg.cholesky_ex`,
`torch.linalg.solve_triangular`): a few device launches per call instead of
n, the same factor to roundoff. Where the library gives up on a lane (a
pivot at or below 0, which late float32 IPM iterations can produce), that
lane is factored again by the reference's column loop with its floor, so it
carries on as the reference does. Every function is batched over the
leading axes: (..., n, n) matrices, (..., n) vectors.

Looking for such a lane reads one flag from the device. A caller that
captures its solve in a CUDA graph, where no read may happen, passes a
`failed` flag tensor instead: the lanes the library gave up on are marked
there and not refactored, and the caller redoes the solve without the graph
when any is marked (controllers/nmpc).
"""

from __future__ import annotations

import torch


def chol_columns(M: torch.Tensor) -> torch.Tensor:
    """The reference's column loop: for j = 0..n-1, d = sqrt(max(A_jj,
    1e-300)), column j of L = A[:, j] / d from row j down, and the trailing
    matrix takes the rank-1 update of the part below row j. (..., n, n)."""
    n = M.shape[-1]
    A = M.clone()
    L = torch.zeros_like(M)
    rows = torch.arange(n, device=M.device)
    for j in range(n):
        d = torch.sqrt(torch.clamp(A[..., j, j], min=1e-300))
        col = A[..., :, j] / d[..., None]
        L[..., :, j] = torch.where(rows >= j, col, 0.0)
        below = torch.where(rows > j, col, 0.0)
        A = A - below[..., :, None] * below[..., None, :]
    return L


def chol_batched(M: torch.Tensor, failed: torch.Tensor | None = None) -> torch.Tensor:
    """Lower Cholesky factor L of a batch of SPD matrices (..., n, n); a lane
    the library cannot factor takes the reference's column loop, or, when a
    bool tensor `failed` (...) is given, is marked in it and left as the
    library returned it."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = info > 0
    if failed is not None:
        failed |= bad
        return L
    if bool(bad.any()):
        L = L.clone()
        L[bad] = chol_columns(M[bad])
    return L


def solve_tri_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b, L lower-triangular: (..., n, n), (..., n)."""
    return torch.linalg.solve_triangular(L, b[..., None], upper=False)[..., 0]


def solve_tri_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L' x = y for the same lower-triangular L."""
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y[..., None],
                                         upper=True)[..., 0]


def cholesky_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = M^-1 b for batched SPD M via the factor above."""
    L = chol_batched(M)
    return solve_tri_upper_t(L, solve_tri_lower(L, b))
