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
128 entries or fewer than 64 and its two-column product keep one order. exact_sum
and exact_mv take those forms; the per-problem and NMPC solves use them, on
at least MIN_LANES lanes, which keeps cuSOLVER on its batched paths.
exact_rows gives a matrix product's rows the same bits at any B; the fused
SQP's merit and flag use it.

The per-problem stack (its LBMPC and LMPC solvers, the closed loop and the
oracle) takes the lane_* forms below, one set a device: on the card a
contraction of at most CHAIN_TERMS terms in order, as a product and then
one FMA a term (a matrix product's inner loop), or in the GN phase's
products (fused=False) each product and sum rounded on its own, as the
wide kernels compute them; exact_rows over a longer one, exact_mv,
exact_sum, split_sum over the NW window's axis (a reduction over an inner
axis splits it by the number of outputs), and a solve of at least
MIN_LANES lanes (on_min_lanes); on the CPU one MKL
product of at least CPU_ROWS rows and two columns (a product of fewer
rows, or of one column, takes paths that round apart by the count), a
row's own (1, c) product over a short float32 contraction, and the
batched products and the window's sums as they are
(tools/split_lane_bits.py --per-problem and tests/test_torch_lane_bits.py
sweep them). Float32 and float64 take the same forms.
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
    place in it. On the card a row of 64 to 127 entries is read by 64
    threads when there are fewer than 16 rows and by 32 otherwise (aten
    Reduce.cuh's block shape), so it is padded to EXACT_CHUNK, which is
    read in vectors by 32 threads at any number of rows, as are rows of
    fewer than 64 entries."""
    n = v.shape[-1]
    if n <= EXACT_CHUNK:
        pad = -n % ALIGN
        if v.is_cuda and n + pad >= 64:
            pad = EXACT_CHUNK - n
        return F_.pad(v, (0, pad)).sum(dim=-1)
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


# On the card a solve runs at least this many lanes: with one, cuSOLVER and
# cuBLAS take their unbatched paths, which round apart from the batched ones
# (the Cholesky factor, a batched matrix-vector product).
MIN_LANES = 2


def pad_lanes(a: torch.Tensor, n: int) -> torch.Tensor:
    """a with its last lane copied onto the leading axis up to n lanes."""
    return torch.cat([a, a[-1:].expand(n - a.shape[0], *a.shape[1:])])


def on_lanes(fn, n: int, *args):
    """fn(*args) on n lanes: each tensor of args (or of a tuple in args, a
    DataWindow) padded with copies of its last lane up to n, and of fn's
    outputs (tensors, or tuples of them) the batch's own lanes."""
    B = next(a for a in args if isinstance(a, torch.Tensor)).shape[0]

    def pad(a):
        if isinstance(a, tuple):
            return type(a)(*map(pad, a)) if hasattr(a, "_fields") else tuple(map(pad, a))
        return pad_lanes(a, n) if isinstance(a, torch.Tensor) else a

    def cut(a):
        if isinstance(a, tuple):
            return type(a)(*map(cut, a)) if hasattr(a, "_fields") else tuple(map(cut, a))
        return a[:B] if isinstance(a, torch.Tensor) else a

    return cut(fn(*map(pad, args)))


def on_min_lanes(fn, *args):
    """fn(*args), a solve whose arguments and outputs hold a lane each on
    their leading axis, on at least MIN_LANES lanes on the card (on_lanes)."""
    x = next(a for a in args if isinstance(a, torch.Tensor))
    if x.is_cuda and x.shape[0] < MIN_LANES:
        return on_lanes(fn, MIN_LANES, *args)
    return fn(*args)


SPLIT_CHUNK = 32


def split_sum(v: torch.Tensor) -> torch.Tensor:
    """v.sum(dim=-1), a row of 64 entries or more first summed in
    zero-padded rows of SPLIT_CHUNK entries, level by level: aten's
    reduction reads a row of fewer than 64 entries with 32 threads at any
    number of rows (Reduce.cuh's block shape), so a row's bits do not
    depend on the number of rows; a strided row is copied first (a sum
    over a strided axis is split by the number of outputs)."""
    while v.shape[-1] >= 64:
        v = F_.pad(v, (0, -v.shape[-1] % SPLIT_CHUNK)).unflatten(-1, (-1, SPLIT_CHUNK)).sum(-1)
    return v.contiguous().sum(dim=-1)


def lane_sum_dim(v: torch.Tensor, dim: int) -> torch.Tensor:
    """v.sum(dim): on the card in split_sum's form, the summed axis moved
    last; on the CPU, whose sums keep one order at any B, v.sum(dim)
    itself."""
    if v.is_cuda:
        return split_sum(v.movedim(dim, -1))
    return v.sum(dim)


# MKL: a product of fewer rows takes paths that round apart by the row
# count (float32 below 16 rows, float64 below 4; tests/test_torch_lane_bits.py)
CPU_ROWS = {torch.float32: 16, torch.float64: 4}
CHAIN_TERMS = 8     # on the card, contractions up to this long run as _term_chain


def _term_chain(a, b, c: int, fused: bool) -> torch.Tensor:
    """sum_j a(j) * b(j) over j < c in the order of j: the first product,
    then one FMA a term (torch.addcmul), or with fused=False each product
    and each sum rounded on its own, as the wide kernels (K1w, K3w, built
    with -fmad=false) compute a short contraction. Elementwise, so no
    kernel is picked by the batch's size."""
    out = a(0) * b(0)
    for j in range(1, c):
        out = torch.addcmul(out, a(j), b(j)) if fused else out + a(j) * b(j)
    return out


def lane_mm(v: torch.Tensor, M: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """v @ M.T, v (..., c), M (r, c) shared, with every row of v (a lane, or
    one of a lane's rows) given the same bits whatever the number of rows
    and the row's place among them. On the card a contraction of at most
    CHAIN_TERMS entries runs as _term_chain (fused=False: unfused, the GN
    phase's products, K1w's twin), a longer one as exact_rows. On the CPU
    it is lane_gemm's product, except that a float32 contraction of at most
    CHAIN_TERMS entries, which would pad a few rows to 16, is a batched
    product of (1, c) x (c, r) matrices, a row each; fused has no effect
    there."""
    lead, c, r = v.shape[:-1], v.shape[-1], M.shape[0]
    if v.is_cuda:
        if c <= CHAIN_TERMS:
            return _term_chain(lambda j: v[..., j:j + 1], lambda j: M[:, j], c, fused)
        return exact_rows(v.reshape(-1, c).contiguous(), M).view(*lead, r)
    if c > CHAIN_TERMS or v.dtype != torch.float32:
        return lane_gemm(v, M)
    w = v.reshape(-1, 1, c)
    return torch.bmm(w, M.T.expand(w.shape[0], c, r)).view(*lead, r)


def lane_gemm(v: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """lane_mm for a long contraction, or many rows a lane (the IPM's
    G' diag(d) G, whatever its columns): on the CPU one product of at least
    CPU_ROWS[dtype] rows (zero-padded) and two columns, which MKL computes
    alike at any row count."""
    if v.is_cuda:
        return lane_mm(v, M)
    lead, c, r = v.shape[:-1], v.shape[-1], M.shape[0]
    w = v.reshape(-1, c)
    n, rows = w.shape[0], CPU_ROWS.get(v.dtype, 16)
    if n < rows:
        w = F_.pad(w, (0, 0, 0, rows - n))
    out = w @ (M.T if r > 1 else F_.pad(M, (0, 0, 0, 1)).T)
    return out[:n, :r].reshape(*lead, r)


def lane_left(M: torch.Tensor, S: torch.Tensor, fused: bool = True) -> torch.Tensor:
    """M @ S for a shared M (r, c) and S (..., c, k): on the card lane_mm
    (with `fused`) with the rows of S' (each of a lane's k columns) in its
    rows; on the CPU, whose batched product computes each lane on its own,
    M @ S itself."""
    return lane_mm(S.mT, M, fused).mT if S.is_cuda else M @ S
