"""Reductions that give identical lanes identical results on the card.

CUDA's reduction kernel reads a long row (PyTorch reads rows longer than
128 entries in aligned vectors) from its first 16-byte (float32) or 32-byte
(float64) boundary on, and adds the entries before that boundary on their
own. Rows whose start addresses differ in alignment therefore sum in
different orders: in a (B, 514) float32 tensor every other row starts 8
bytes past a boundary, so two identical lanes come out a rounding apart
(tools/lane_determinism.py found this in ops/ipm's mu on the card; the CPU
sums rows alike). lane_sum starts every row on a boundary; ops/ipm,
ops/ipm_fused and the SQP merits sum their rows of mI entries with it.

That a lane's bits do not depend on the batch's size either needs more
(measured on the card): the reduction kernel splits a long row over more
threads when there are few rows, and cuBLAS picks its batched
matrix-vector product's kernel by the batch count, while sums of rows of
at most 128 entries and its two-column product keep one order. exact_sum
and exact_mv take those forms; the NMPC's solves use them, on at least two
lanes, which keeps cuSOLVER on its batched paths. exact_rows gives a
matrix product's rows the same bits at any B; the fused SQP's merit and
flag use it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F_

ALIGN = 8           # entries: 32 bytes of float32, 64 of float64
VECTOR_ROWS = 128   # longer rows are read in vectors (aten Reduce.cuh)


def lane_sum(v: torch.Tensor) -> torch.Tensor:
    """v.sum(dim=-1), each row added in the same order wherever it lies in
    the batch: a row longer than VECTOR_ROWS entries is summed from a fresh
    copy whose rows start ALIGN entries apart (padded with zeros that the
    sum does not reach), so every row sums as a row starting on a boundary
    does — as the batch's first row of a fresh tensor always did. Shorter
    rows, which the kernel reads entry by entry, sum as v.sum(dim=-1)
    does."""
    n = v.shape[-1]
    if n > VECTOR_ROWS and (n % ALIGN or not v.is_contiguous()):
        v = F_.pad(v, (0, -n % ALIGN))[..., :n]
    return v.sum(dim=-1)


EXACT_CHUNK = 128


def exact_sum(v: torch.Tensor) -> torch.Tensor:
    """v.sum(dim=-1) in chunks of EXACT_CHUNK entries, then over the chunks:
    a row sums in the same order whatever the batch's size and the row's
    place in it."""
    n = v.shape[-1]
    if n <= EXACT_CHUNK:
        return F_.pad(v, (0, -n % ALIGN)).sum(dim=-1)
    return F_.pad(v, (0, -n % EXACT_CHUNK)).unflatten(-1, (-1, EXACT_CHUNK)).sum(-1).sum(-1)


ROWS_CHUNK = 2048


def exact_rows(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """v @ M.T, v (B, c), M (r, c), in zero-padded chunks of ROWS_CHUNK rows:
    every product is the same (ROWS_CHUNK, c) x (c, r) matrix product, on
    operands that start on the same alignment, so its kernel, and a row's
    bits, do not depend on B. A plain (B, 21) x (21, 214) product's do:
    cuBLAS picks its kernel by B (tools/lane_exact_forms.py)."""
    B = v.shape[0]
    vp = F_.pad(v, (0, 0, 0, -B % ROWS_CHUNK))
    out = vp.new_empty(vp.shape[0], M.shape[0])
    for i in range(0, vp.shape[0], ROWS_CHUNK):
        torch.mm(vp[i:i + ROWS_CHUNK], M.T, out=out[i:i + ROWS_CHUNK])
    return out[:B]


def exact_mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A v per lane, A (B, r, c), v (B, c), as a two-column matrix product
    (the second column zero): its kernel does not depend on B."""
    return (A @ F_.pad(v[..., None], (0, 1)))[..., 0]
