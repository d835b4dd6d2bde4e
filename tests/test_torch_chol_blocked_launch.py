"""K6's launch shape and its order of operations, on the CPU.

K6 (csrc/chol_blocked.cu) runs a lane on 1, 2 or 4 warps and several lanes
a block; the host picks both (ops/chol_kernel.blocked_launch). These tests
hold that choice to the card's limits over the kernel's domain and the
host's shared-memory formula and constants to the source's, and hold a
float32 emulation of the kernel's order — the padded lower triangle, a
slab's panel factored with the forward sweep inside it, the next slab
looked ahead (slab s's terms subtracted from it before the trailing
update's), the trailing update, and the back sweep by blocks of 32 columns
(rows of L) — to the plain version (ops/chol_kernel.cholesky_floor and
_tri_solves) bit for bit. The kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from lbmpc_tpu_torch.ops import chol_kernel
from lbmpc_tpu_torch.ops.chol_kernel import (BLOCKED_MAX_LANES, BLOCKED_MAX_THREADS, SLAB,
                                             blocked_launch, blocked_smem_bytes, blocked_warps)
from lbmpc_tpu_torch.ops.qp_kernel import SMEM_OPTIN

SMS = 132
BATCHES = (0, 1, 3, 24, 1024, 8192)
CSRC = pathlib.Path(chol_kernel.__file__).resolve().parent.parent / "csrc"


def _consts(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", text)}


@pytest.mark.parametrize("n0", [25, 33, 49, 65, 81, 97, 113])
def test_blocked_launch_fits_the_card(n0):
    """Every n of 25..128 and every batch: the warps a lane, a power of two
    lanes a block within BLOCKED_MAX_LANES and BLOCKED_MAX_THREADS, a grid
    that covers B, a block for every SM where B allows, and the block's
    shared memory blocked_smem_bytes and within the opt-in limit."""
    for n in range(n0, min(n0 + 16, 129)):
        for B in BATCHES:
            warps, lanes, blocks, smem = blocked_launch(n, B, sms=SMS)
            assert warps == blocked_warps(n) and warps in (1, 2, 4)
            assert lanes & (lanes - 1) == 0 and 1 <= lanes <= BLOCKED_MAX_LANES
            assert warps * lanes * 32 <= BLOCKED_MAX_THREADS
            assert blocks == -(-B // lanes) and blocks * lanes >= B > (blocks - 1) * lanes
            assert blocks >= min(B, SMS)
            assert smem == blocked_smem_bytes(n, lanes) <= SMEM_OPTIN


def test_blocked_launch_at_the_main_shapes():
    """The DMS flagship (n=101, B=1024): four warps a lane, four lanes a
    block (256 blocks: eight lanes an SM in two blocks), 22.9 KB a lane; the
    uncut LBMPC_N40 (n=41, B=2048): two warps a lane, four lanes a block."""
    assert blocked_launch(101, 1024, sms=SMS) == (4, 4, 256, 4 * 4 * (5512 + 2 * 104))
    assert blocked_smem_bytes(101, 1) == 22880
    assert blocked_launch(41, 2048, sms=SMS)[:3] == (2, 4, 512)
    assert blocked_launch(25, 1, sms=SMS)[:3] == (1, 1, 1)
    assert blocked_launch(128, 8192, sms=SMS)[:3] == (4, 4, 2048)


@pytest.mark.parametrize("n, B", [(0, 1), (129, 1), (101, -1), (-3, 4)])
def test_blocked_launch_rejects_what_the_kernels_do_not_take(n, B):
    with pytest.raises(ValueError, match="1 <= n <= 128"):
        blocked_launch(n, B, sms=SMS)


def test_blocked_host_constants_are_the_kernels():
    """The host's constants are chol_blocked.cu's and chol_body.cuh's, and
    blocked_smem_bytes is the source's lane_floats: rows padded to 8 floats
    (row i starts at 8(q+1)(4q+t), i = 8q+t) and two vectors rounded to 4."""
    cb, body = _consts("chol_blocked.cu"), _consts("chol_body.cuh")
    assert cb["kSlab"] == SLAB and cb["kMaxLanes"] == BLOCKED_MAX_LANES
    assert cb["kMaxThreads"] == BLOCKED_MAX_THREADS and body["kNMax"] == chol_kernel.N_MAX
    for n in range(1, 129):
        padded = sum(-(-(i + 1) // SLAB) * SLAB for i in range(n))
        assert blocked_smem_bytes(n, 3) == 3 * 4 * (padded + 2 * (-(-n // 4) * 4))


# ---- the kernel's order, emulated in float32 --------------------------------

def _tri_row(i: int) -> int:
    """csrc/chol_blocked.cu tri_row: where row i of a lane's triangle starts."""
    q, t = divmod(i, SLAB)
    return SLAB * (q + 1) * (4 * q + t)


def blocked_emulation(M: torch.Tensor, b: torch.Tensor):
    """K6's arithmetic in its order, one float32 operation at a time (B lanes
    at once): (L, x). The triangle T holds row i at _tri_row(i), padded; a
    slab's panel is its 8 columns of rows c0..n-1 (8 floats a row, read and
    written whole, as the kernel's float4 pairs do); the right-hand side runs
    through the panels as their ninth column."""
    Bn, n, _ = M.shape
    T = torch.zeros(Bn, _tri_row(n) + SLAB, dtype=torch.float32)
    for i in range(n):
        T[:, _tri_row(i):_tri_row(i) + i + 1] = M[:, i, :i + 1]
    v, y = b.clone(), torch.zeros_like(b)
    floor = torch.tensor(chol_kernel.PIVOT_FLOOR, dtype=torch.float32)

    def cols(rows, c):  # (B, len(rows), 8): columns c..c+7 of `rows`
        idx = torch.tensor([[_tri_row(i) + c + k for k in range(SLAB)] for i in rows])
        return idx, T[:, idx]

    def panel(c0: int, p0: int) -> None:
        w, rows = min(SLAB, n - c0), list(range(c0, n))
        idx, a = cols(rows, c0)
        r = v[:, c0:].clone()
        if p0 >= 0:  # the look-ahead: slab p0's terms, j = p0..p0+7 in order
            _, pi = cols(rows, p0)
            _, pk = cols(range(c0, c0 + w), p0)
            for kk in range(w):
                for jj in range(SLAB):
                    a[:, :, kk] = a[:, :, kk] - pi[:, :, jj] * pk[:, kk, jj, None]
        for jj in range(w):
            acc = a[:, jj, jj]
            piv = torch.sqrt(torch.where(acc < floor, floor, acc))  # NaN passes
            lij = a[:, :, jj] / piv[:, None]
            lij[:, :jj] = 1.0 / piv[:, None]  # rows above the diagonal divide 1
            yj = r[:, jj] / lij[:, jj]
            y[:, c0 + jj] = yj
            r = r - lij * yj[:, None]
            a[:, :, jj] = lij
            for kk in range(jj + 1, w):
                a[:, :, kk] = a[:, :, kk] - lij * lij[:, kk, None]
        T[:, idx] = a
        v[:, c0 + SLAB:] = r[:, SLAB:]

    def trailing(j0: int, k0: int) -> None:
        pairs = [(i, k) for k in range(k0, n) for i in range(k, n)]
        if not pairs:
            return
        ent = torch.tensor([_tri_row(i) + k for i, k in pairs])
        pi = torch.tensor([_tri_row(i) + j0 for i, _ in pairs])
        pk = torch.tensor([_tri_row(k) + j0 for _, k in pairs])
        e = T[:, ent]
        for jj in range(SLAB):
            e = e - T[:, pi + jj] * T[:, pk + jj]
        T[:, ent] = e

    panel(0, -1)
    for j0 in range(0, n - SLAB, SLAB):
        panel(j0 + SLAB, j0)
        trailing(j0, j0 + 2 * SLAB)
    L = torch.zeros_like(M)
    for i in range(n):
        L[:, i, :i + 1] = T[:, _tri_row(i):_tri_row(i) + i + 1]
    yv, x = y.clone(), torch.zeros_like(b)
    dg = torch.diagonal(L, dim1=1, dim2=2)
    for c1 in range(n, 0, -32):  # the back sweep by blocks of 32 columns, rows j of L
        c0 = max(0, c1 - 32)
        for j in range(c1 - 1, c0 - 1, -1):  # the block's diagonal part
            x[:, j] = yv[:, j] / dg[:, j]
            yv[:, c0:j] = yv[:, c0:j] - L[:, j, c0:j] * x[:, j, None]
        for j in range(c1 - 1, c0 - 1, -1):  # the rows above it
            yv[:, :c0] = yv[:, :c0] - L[:, j, :c0] * x[:, j, None]
    return L, x


def _spd(n: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    M = A @ np.swapaxes(A, 1, 2) / n + np.eye(n)
    dg = 1.0 / np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    M = M * dg[:, :, None] * dg[:, None, :]
    return (torch.tensor(M, dtype=torch.float32),
            torch.tensor(rng.standard_normal((B, n)), dtype=torch.float32))


@pytest.mark.parametrize("n", [25, 32, 33, 101, 128])
def test_emulated_order_equals_the_plain_version_bit_for_bit(n):
    """The kernel's order — the slab in registers, the look-ahead, the
    forward sweep inside the panels, the trailing update from the padded
    triangle and the back sweep — gives cholesky_floor's L and _tri_solves'
    x bit for bit (B=2, seeded SPD systems)."""
    M, b = _spd(n, 2, 10 + n)
    L, x = blocked_emulation(M, b)
    Lp, xp = chol_kernel.chol_factor_solve_plain(M, b)
    assert torch.equal(L, Lp) and torch.equal(x, xp)


def test_emulated_order_keeps_a_nan_lane_and_a_floored_lane_apart():
    """A NaN below the diagonal of one lane and a lane whose pivots all hit
    the floor: the emulation matches the plain version lane by lane (NaN
    where it has NaN) and the healthy lane is untouched."""
    n = 33
    M, b = _spd(n, 3, 5)
    M[0, n - 1, 4] = float("nan")
    M[1] = -M[1]
    L, x = blocked_emulation(M, b)
    Lp, xp = chol_kernel.chol_factor_solve_plain(M, b)
    same = lambda a, c: bool(((a == c) | (torch.isnan(a) & torch.isnan(c))).all())
    assert same(L, Lp) and same(x, xp)
    assert torch.isnan(x[0]).any() and not torch.isnan(x[2]).any()
