"""K5 and K6 — batched Cholesky factor + solve for the IPM's KKT normal
matrices. K5 (csrc/chol.cu): K5a factors and solves and stores L, K5b
factors and solves without storing L, K5c re-solves with a stored L. K6
(csrc/chol_blocked.cu): K6a and K6b compute K5a's and K5b's function by a
factorization in slabs of 8 columns (a slab's panel in one warp's
registers, the next slab looked ahead beside the trailing update, the
forward sweep inside the panels), bit for bit the same.

Port of lbmpc_tpu/ops/pallas_chol.py (chol_factor_solve, chol_solve,
chol_resolve); LBMPC_CHOL_BLOCKED=1 selects the blocked kernels where the
reference does (`blocked_switch`). Each wrapper routes by device: a CUDA
tensor always launches its kernel, a CPU tensor takes the plain version
below (K6's is K5's: the same function), and `plain=True` asks for the
plain version on any device (the comparisons on the card).

L is (B, n, n) row-major: its lower triangle with the diagonal, zeros above.
K5a writes it and K5c reads it as it is. The reference's column-major
(n_p^2, B) pack and its identity padding to n_p = 8k exist for the TPU's
lane tiles and have no counterpart. Neither has its scoped-VMEM model
(_chol_vmem_need, _tile_cap, _vlim_raise): a lane's n^2 floats (40.8 KB at
the DMS flagship's n=101) fit one block's shared memory on this card up to
n = 128, so storing L always fits and only LBMPC_CHOL_STORE=0 turns it off.

K5 runs one warp a lane and several lanes a block up to n = 32, one
256-thread block a lane above (csrc/chol.cu); `chol_launch` is the host's
choice of that shape, which the wrappers pass to the kernel. K6 runs a lane
on 1, 2 or 4 warps and several lanes a block (csrc/chol_blocked.cu);
`blocked_launch` is the host's choice of both.
"""

from __future__ import annotations

import os

import torch

from lbmpc_tpu_torch.ops._cuda import I, P, CudaKernel, check, ptr
from lbmpc_tpu_torch.ops.qp_kernel import H100_SMS, lanes_a_block, sm_count

FACTOR_SOLVE = CudaKernel("chol_factor_solve", [P] * 4 + [I, I, I, P], source="chol")
SOLVE = CudaKernel("chol_solve", [P] * 3 + [I, I, I, P], source="chol")
RESOLVE = CudaKernel("chol_resolve", [P] * 3 + [I, I, I, P], source="chol")
KERNELS = (FACTOR_SOLVE, SOLVE, RESOLVE)
FACTOR_SOLVE_BLOCKED = CudaKernel("chol_factor_solve_blocked", [P] * 4 + [I] * 4 + [P],
                                  source="chol_blocked")
SOLVE_BLOCKED = CudaKernel("chol_solve_blocked", [P] * 3 + [I] * 4 + [P], source="chol_blocked")
BLOCKED_KERNELS = (FACTOR_SOLVE_BLOCKED, SOLVE_BLOCKED)
N_MAX = 128          # csrc/chol_body.cuh kNMax
PIVOT_FLOOR = 1e-30  # sqrt(max(acc_jj, 1e-30)), pallas_chol.py:417
# K5's launch shape (csrc/chol.cu): a warp a lane up to WARP_N_MAX, at most
# MAX_LANES lanes a block; above it a block of BLOCK_THREADS a lane, with the
# factorization's panel of PANEL columns (csrc/chol_body.cuh)
WARP_N_MAX, MAX_LANES, BLOCK_THREADS, PANEL = 32, 8, 256, 8
# K6's launch shape (csrc/chol_blocked.cu): at most BLOCKED_MAX_LANES lanes
# and BLOCKED_MAX_THREADS threads a block; slabs of SLAB columns
BLOCKED_MAX_LANES, BLOCKED_MAX_THREADS, SLAB = 4, 512, 8


def chol_smem_bytes(n: int, lanes: int) -> int:
    """K5's dynamic shared memory for a block of `lanes` lanes (csrc/chol.cu
    lane_floats): a lane's copy of L, n rows of stride 8 ceil(n / 8) + 1, up
    to WARP_N_MAX; above it the n x n matrix, the right-hand side and the
    panel's 2 PANEL floats."""
    per = (n * (-(-n // 8) * 8 + 1) if n <= WARP_N_MAX else n * n + n + 2 * PANEL)
    return 4 * lanes * per


def chol_launch(n: int, B: int, sms: int = H100_SMS) -> tuple:
    """K5's launch shape for B lanes of n x n systems on a card of `sms`
    SMs: (lanes a block, blocks, the block's shared memory in bytes). Up to
    WARP_N_MAX a warp runs a lane and a block holds the most lanes, a power
    of two up to MAX_LANES, that still give every SM a block (up to `sms`
    lanes each has a block of its own); above it a block runs one lane.
    Raises where the kernels do not take the shape."""
    if not (1 <= n <= N_MAX and B >= 0):
        raise ValueError(f"the chol kernels take 1 <= n <= {N_MAX} and a batch B >= 0 "
                         f"(got n={n}, B={B})")
    lanes = MAX_LANES if n <= WARP_N_MAX else 1
    while lanes > 1 and -(-B // lanes) < sms:
        lanes //= 2
    return lanes, -(-B // lanes), chol_smem_bytes(n, lanes)


def blocked_smem_bytes(n: int, lanes: int) -> int:
    """K6's dynamic shared memory for a block of `lanes` lanes
    (csrc/chol_blocked.cu lane_floats): a lane's lower triangle of L, row i
    padded to a multiple of SLAB floats (rows 8q..8q+7 hold 8(q+1) each),
    and two vectors of n floats rounded up to 4."""
    q, t = divmod(n, SLAB)
    return 4 * lanes * (SLAB * (q + 1) * (4 * q + t) + 2 * (-(-n // 4) * 4))


def blocked_warps(n: int) -> int:
    """K6's warps a lane at n: the panel warp factors each slab's panel and
    runs the back sweep, the others subtract the look-ahead terms from a
    slab's rows past its first 32 and update the trailing triangle, whose
    work grows as n^3 — one warp up to n = 32, two up to 64, four above."""
    return 1 if n <= 32 else 2 if n <= 64 else 4


def blocked_launch(n: int, B: int, sms: int = H100_SMS) -> tuple:
    """K6's launch shape for B lanes of n x n systems on a card of `sms`
    SMs: (warps a lane, lanes a block, blocks, the block's shared memory in
    bytes). A block holds the most lanes, a power of two up to
    BLOCKED_MAX_LANES within BLOCKED_MAX_THREADS threads, that still give
    every SM a block (up to `sms` lanes each has a block of its own) and fit
    the opt-in shared memory (qp_kernel.lanes_a_block). Raises where the
    kernels do not take the shape."""
    if not (1 <= n <= N_MAX and B >= 0):
        raise ValueError(f"the chol kernels take 1 <= n <= {N_MAX} and a batch B >= 0 "
                         f"(got n={n}, B={B})")
    warps = blocked_warps(n)
    most = min(BLOCKED_MAX_LANES, BLOCKED_MAX_THREADS // (32 * warps))
    lanes, blocks, smem = lanes_a_block(B, most, sms, lambda k: blocked_smem_bytes(n, k),
                                        f"K6 at n={n}")
    return warps, lanes, blocks, smem


def factor_store_feasible() -> bool:
    """Whether the IPM stores L (K5a + K5c) or refactors per solve (K5b).
    On this card storing L always fits up to n = 128 (module docstring), so
    only LBMPC_CHOL_STORE=0 forces the refactor route, as in the
    reference."""
    return os.environ.get("LBMPC_CHOL_STORE") != "0"


def blocked_switch(n: int) -> bool:
    """Whether the IPM factors n x n systems on K6 (slab-blocked) instead of
    K5: LBMPC_CHOL_BLOCKED=1 at n_p = 8 ceil(n / 8) >= 32, as the reference
    reads it (pallas_chol.py:138, :226). Read when a solver is built."""
    return os.environ.get("LBMPC_CHOL_BLOCKED") == "1" and -(-n // 8) * 8 >= 32


def cholesky_floor(M: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky with the pivot floor sqrt(max(., 1e-30)); reads M's
    lower triangle, returns L with zeros above the diagonal.

    The reference's column recurrence (_chol_cols, pallas_chol.py:410-419)
    gives entry (i, j) the terms L[i, k] L[j, k] for k = 0..j-1 in that
    order. This runs it right-looking, as the kernel does: once column j is
    final, the trailing block subtracts its outer product. Each product and
    each difference is rounded on its own, as the kernel's __fmul_rn /
    __fsub_rn are, so kernel and plain version agree bit for bit."""
    n = M.shape[-1]
    A = M.clone()
    for j in range(n):
        djj = torch.sqrt(torch.clamp(A[:, j, j], min=PIVOT_FLOOR))
        col = A[:, j:, j] / djj[:, None]
        A[:, j:, j] = col
        c = col[:, 1:]
        A[:, j + 1:, j + 1:] -= c[:, :, None] * c[:, None, :]
    return torch.tril(A)


def _tri_solves(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L L' x = b by two column sweeps (the kernel's): forward on L
    (_tri_lower, pallas_chol.py:422-432), then back on L' reading row j of
    L. Only the lower triangle of L is read."""
    n = L.shape[-1]
    v = b.clone()
    y = torch.empty_like(b)
    for j in range(n):
        y[:, j] = v[:, j] / L[:, j, j]
        v[:, j + 1:] -= L[:, j + 1:, j] * y[:, j, None]
    x = torch.empty_like(b)
    for j in range(n - 1, -1, -1):
        x[:, j] = y[:, j] / L[:, j, j]
        y[:, :j] -= L[:, j, :j] * x[:, j, None]
    return x


def chol_factor_solve_plain(M, b):
    """K5a's plain version: (L (B, n, n), x (B, n))."""
    L = cholesky_floor(M)
    return L, _tri_solves(L, b)


def chol_solve_plain(M, b):
    """K5b's plain version: x (B, n)."""
    return _tri_solves(cholesky_floor(M), b)


def chol_resolve_plain(L, b):
    """K5c's plain version: x (B, n) from a stored L."""
    return _tri_solves(L, b)


def _device_of(A: torch.Tensor, plain: bool) -> torch.device | None:
    """None for the plain version, else the CUDA device to launch on."""
    if plain or A.device.type == "cpu":
        return None
    if A.device.type != "cuda":
        raise ValueError(f"the chol kernels run on cuda or cpu, not {A.device}")
    return A.device


def _checked(A, b):
    Bsz, n = b.shape
    if n > N_MAX:
        raise ValueError(f"the chol kernels take n <= {N_MAX} (got n={n})")
    check("matrix", A, (Bsz, n, n), A.device)
    check("rhs", b, (Bsz, n), A.device)
    return Bsz, n


def _lanes(dev, Bsz: int, n: int) -> I:
    return I(chol_launch(n, Bsz, sms=sm_count(dev))[0])


def _blocked_shape(dev, Bsz: int, n: int) -> tuple:
    warps, lanes = blocked_launch(n, Bsz, sms=sm_count(dev))[:2]
    return I(warps), I(lanes)


def chol_factor_solve(M, b, plain: bool = False):
    """Factor SPD M (B, n, n) and solve M x = b (B, n): (L, x)."""
    dev = _device_of(M, plain)
    if dev is None:
        return chol_factor_solve_plain(M, b)
    Bsz, n = _checked(M, b)
    L = torch.empty_like(M)
    x = torch.empty_like(b)
    FACTOR_SOLVE.launch(dev, ptr(M), ptr(b), ptr(L), ptr(x), I(Bsz), I(n),
                        _lanes(dev, Bsz, n))
    return L, x


def chol_solve(M, b, plain: bool = False):
    """Factor SPD M (B, n, n) and solve M x = b without storing L: x."""
    dev = _device_of(M, plain)
    if dev is None:
        return chol_solve_plain(M, b)
    Bsz, n = _checked(M, b)
    x = torch.empty_like(b)
    SOLVE.launch(dev, ptr(M), ptr(b), ptr(x), I(Bsz), I(n), _lanes(dev, Bsz, n))
    return x


def chol_resolve(L, b, plain: bool = False):
    """Solve M x = b with the factor L from chol_factor_solve: x."""
    dev = _device_of(L, plain)
    if dev is None:
        return chol_resolve_plain(L, b)
    Bsz, n = _checked(L, b)
    x = torch.empty_like(b)
    RESOLVE.launch(dev, ptr(L), ptr(b), ptr(x), I(Bsz), I(n), _lanes(dev, Bsz, n))
    return x


def chol_factor_solve_blocked(M, b, plain: bool = False):
    """K6a: chol_factor_solve's function by the slab-blocked kernel: (L, x),
    bit for bit K5a's. Its plain version is K5a's."""
    dev = _device_of(M, plain)
    if dev is None:
        return chol_factor_solve_plain(M, b)
    Bsz, n = _checked(M, b)
    L = torch.empty_like(M)
    x = torch.empty_like(b)
    FACTOR_SOLVE_BLOCKED.launch(dev, ptr(M), ptr(b), ptr(L), ptr(x), I(Bsz), I(n),
                                *_blocked_shape(dev, Bsz, n))
    return L, x


def chol_solve_blocked(M, b, plain: bool = False):
    """K6b: chol_solve's function by the slab-blocked kernel: x, bit for bit
    K5b's. Its plain version is K5b's."""
    dev = _device_of(M, plain)
    if dev is None:
        return chol_solve_plain(M, b)
    Bsz, n = _checked(M, b)
    x = torch.empty_like(b)
    SOLVE_BLOCKED.launch(dev, ptr(M), ptr(b), ptr(x), I(Bsz), I(n), *_blocked_shape(dev, Bsz, n))
    return x
