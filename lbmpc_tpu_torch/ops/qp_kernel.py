"""K2, K2w and K4 — fixed-iteration Mehrotra predictor-corrector QPs, the
whole loop in one launch: K2 with a Hessian per lane at nz <= 32
(csrc/mehrotra_h.cu: one warp a lane, several lanes a block, the launch
shape from narrow_launch), K2w the same at 32 < nz <= 128
(csrc/mehrotra_h_wide.cu: G stays in device memory, the factorization is
block-wide), K4 with one H shared by the batch (csrc/mehrotra.cu: four
warps a lane, several lanes a block, the launch shape from shared_launch).
K2 runs the loop of csrc/mehrotra_warp.cuh, which K3 (ops/mono_kernel) runs
too; K2w the same iteration from csrc/mehrotra_wide.cuh; K4 its own loop
(no equilibration, d capped at 1e7, the reference's padded rows).
mehrotra_h picks K2 or K2w by nz, with one wrapper contract.

Ports of lbmpc_tpu/ops/pallas_ipm.py: build_pallas_qp_solver_h (K2) and
build_pallas_qp_solver (K4). Each lane solves min 1/2 x'H x + g'x s.t.
G x <= h with G shared by the batch. The wrappers route by device: a CUDA
tensor always launches the kernel; a CPU tensor takes the plain version
below (the same iteration on batched tensor ops). K2's warm state is the
port's own layout: a tuple (s, z) of (B, mI) float32 tensors in G's row
order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F_

from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.ops._cuda import WIDE_FLAGS, F, I, P, CudaKernel, check, ptr

KERNEL = CudaKernel("mehrotra_h", [P] * 10 + [I, I, I, I, F, F, F, I, P])
KERNEL_WIDE = CudaKernel("mehrotra_h_wide", [P] * 12 + [I, I, I, I, F, F, F, P],
                         flags=WIDE_FLAGS)
KERNEL_SHARED = CudaKernel("mehrotra", [P] * 7 + [I, I, I, I, F, F, I, P])

BIG = 1e6           # ratio-test sentinel (pallas_ipm.py:34)
RIDGE = 1e-6        # KKT ridge
SHARED_D_CAP = 1e7  # build_pallas_qp_solver's d cap (pallas_ipm.py:723)
NZ_MAX, MI_MAX = 32, 1024   # csrc/mehrotra_warp.cuh kNzMax, kMaxRows (K2, K3; K4 the same)
NZ_MAX_WIDE = 128           # csrc/mehrotra_wide.cuh kNzMax (K2w)
# K2's and K3's launch shape (csrc/mehrotra_warp.cuh): lanes a block at most,
# the widths of x and dx in a warp's memory, the rows up to which a lane's
# per-row state stays in registers, and its vectors in shared memory above
NARROW_MAX_WARPS, NARROW_VEC, NARROW_REG_ROWS, NARROW_STATE_VECS = 8, 36, 256, 7
SMEM_OPTIN = 232448         # shared memory a block may use on an H100 (227 KB)
H100_SMS = 132
# K4's launch shape (csrc/mehrotra.cu): lanes a block at most, a lane's
# threads and the assembly's, G'v's row partials, the reduction slots a lane
SHARED_MAX_LANES, SHARED_GROUP, SHARED_ASM, SHARED_PARTS, SHARED_RED = 4, 128, 96, 8, 48


def narrow_padded_nz(nz: int) -> int:
    """The width K2 and K3 are built for: 8 ceil(nz / 8) (csrc/mehrotra_warp.cuh
    padded_nz)."""
    return -(-nz // 8) * 8


def narrow_g_stride(nz: int) -> int:
    """G's row stride in K2's and K3's shared memory: the padded width + 4,
    4 mod 8 (csrc/mehrotra_warp.cuh g_stride)."""
    return narrow_padded_nz(nz) + 4


def narrow_warp_floats(mI: int, nz: int, q: int = 0) -> int:
    """Floats of one lane's (warp's) shared memory in K2 (q = 0) or K3 (q:
    its window of q points and its Jacobian rows): x and dx, H and M (rows
    of the padded width, odd stride), one mI-vector, and above
    NARROW_REG_ROWS rows the per-row state (csrc/mehrotra_warp.cuh
    warp_floats)."""
    r4 = lambda n: (n + 3) & ~3
    # K3: the lane's constants before Hconst (72), window and Jacobian rows
    # (csrc/gn_body.cuh work_floats)
    extra = 72 + q * 8 + 5 * 32 if q else 0
    kn = narrow_padded_nz(nz)
    return (2 * NARROW_VEC + 2 * r4(kn * (kn + 1)) + r4(mI)
            + (NARROW_STATE_VECS * r4(mI) if mI > NARROW_REG_ROWS else 0) + extra)


def narrow_smem_bytes(mI: int, nz: int, warps: int, q: int = 0) -> int:
    """A block's dynamic shared memory: G once (rows of narrow_g_stride)
    and each of its warps' own region."""
    return 4 * (mI * narrow_g_stride(nz) + warps * narrow_warp_floats(mI, nz, q))


def narrow_launch(mI: int, nz: int, B: int, q: int = 0, sms: int = H100_SMS) -> tuple:
    """K2's (q = 0) and K3's (q = the window's points) launch shape for a
    batch of B lanes on a card of `sms` SMs: (warps a block, blocks, the
    block's shared memory in bytes). A warp runs one lane. A block holds the
    most lanes, a power of two up to NARROW_MAX_WARPS, that still give every
    SM a block: up to `sms` lanes each lane has a block of its own (a small
    batch, such as the repair's, sees one lane's latency, so it spreads as
    wide as it can), and a large one shares each staged copy of G among 8
    lanes. Fewer lanes where the block's shared memory would pass
    SMEM_OPTIN (at mI = 1024, nz = 32: two). Raises where the kernels do not
    take the shape or one lane does not fit."""
    if not (1 <= nz <= NZ_MAX and 1 <= mI <= MI_MAX and B >= 0 and q >= 0):
        raise ValueError(f"K2 and K3 take 1 <= nz <= {NZ_MAX}, 1 <= mI <= {MI_MAX} and a "
                         f"batch B >= 0 (got nz={nz}, mI={mI}, B={B}, q={q})")
    return lanes_a_block(B, NARROW_MAX_WARPS, sms, lambda n: narrow_smem_bytes(mI, nz, n, q),
                         f"K2/K3 at mI={mI}, nz={nz}, q={q}")


def lanes_a_block(B: int, most: int, sms: int, smem, what: str) -> tuple:
    """The launch shape of a kernel that runs several lanes a block: the
    most lanes, a power of two up to `most`, that still give every SM a
    block (up to `sms` lanes each has a block of its own; a small batch
    sees one lane's latency, so it spreads as wide as it can) and fit the
    opt-in shared memory, `smem(lanes)` bytes. Returns (lanes, blocks,
    bytes); raises where one lane of `what` does not fit."""
    lanes = most
    while lanes > 1 and -(-B // lanes) < sms:
        lanes //= 2
    while lanes > 1 and smem(lanes) > SMEM_OPTIN:
        lanes //= 2
    if smem(lanes) > SMEM_OPTIN:
        raise ValueError(f"one lane of {what} needs {smem(lanes)} bytes of shared memory, "
                         f"more than the {SMEM_OPTIN} a block may use")
    return lanes, -(-B // lanes), smem(lanes)


def shared_smem_bytes(mI: int, nz: int, lanes: int) -> int:
    """K4's dynamic shared memory for a block of `lanes` lanes
    (csrc/mehrotra.cu block_floats): G once (rows of narrow_g_stride), H
    once (rows of the padded width, odd stride), and each lane's x, dx and
    L's reciprocal pivots, M, three mI-vectors, the assembly's partials (a 4 x 4 block of M's
    lower block triangle over each of SHARED_ASM // tasks row ranges), G'v's
    row partials and the reduction slots."""
    r4 = lambda n: (n + 3) & ~3
    kn = narrow_padded_nz(nz)
    tasks = (kn // 4) * (kn // 4 + 1) // 2
    lane = (3 * NARROW_VEC + r4(kn * (kn + 1)) + 3 * r4(mI) + SHARED_ASM // tasks * tasks * 16
            + SHARED_PARTS * kn + SHARED_RED)
    return 4 * (mI * narrow_g_stride(nz) + r4(kn * (kn + 1)) + lanes * lane)


def shared_launch(mI: int, nz: int, B: int, sms: int = H100_SMS) -> tuple:
    """K4's launch shape for B lanes on a card of `sms` SMs: (lanes a block,
    blocks, the block's shared memory in bytes). Four warps run a lane; a
    block holds the most lanes, a power of two up to SHARED_MAX_LANES, that
    still give every SM a block (up to `sms` lanes each has a block of its
    own) and fit the opt-in shared memory (at mI = 1024, nz = 32 two do).
    Raises where the kernel does not take the shape."""
    if not (1 <= nz <= NZ_MAX and 1 <= mI <= MI_MAX and B >= 0):
        raise ValueError(f"K4 takes 1 <= nz <= {NZ_MAX}, 1 <= mI <= {MI_MAX} and a batch "
                         f"B >= 0 (got nz={nz}, mI={mI}, B={B})")
    return lanes_a_block(B, SHARED_MAX_LANES, sms, lambda n: shared_smem_bytes(mI, nz, n),
                         f"K4 at mI={mI}, nz={nz}")


_SMS: dict = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device (read once per device)."""
    key = torch.device(device).index or 0
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(key).multi_processor_count
    return _SMS[key]


def analyze_constraint_rows(G: np.ndarray) -> dict:
    """Host-side constraint-row analysis (the reference's, kept for the
    shapes it reports): the dominant 2-column-support group ("split-G", mS
    rows; >= 64 rows sharing one {ca, cb} support) and the remaining dense
    rows sorted by their last nonzero column. The bench shape and the wide
    shapes have mS = 0."""
    Gn = np.asarray(G, np.float32)
    mI, nz = Gn.shape
    supports = [np.nonzero(Gn[i])[0] for i in range(mI)]
    groups: dict = {}
    for i, s in enumerate(supports):
        if 0 < len(s) <= 2:
            groups.setdefault((int(s[0]), int(s[-1])), []).append(i)
    best = max(groups.items(), key=lambda kv: len(kv[1]), default=None)
    if best is not None and len(best[1]) >= 64 and best[0][0] != best[0][1]:
        (ca, cb), sp_rows = best
        sp_rows = list(sp_rows)
    else:
        ca = cb = 0
        sp_rows = []
    sp_set = set(sp_rows)
    d_rows = [i for i in range(mI) if i not in sp_set]
    maxc = {i: (int(supports[i][-1]) if len(supports[i]) else 0) for i in d_rows}
    d_rows = sorted(d_rows, key=lambda i: maxc[i])
    return dict(ca=ca, cb=cb, sp_rows=sp_rows, d_rows=d_rows, mD=len(d_rows),
                mS=len(sp_rows))


class WidePlan:
    """K2w's and K3w's host plan for one G (mI, nz), computed once: the
    extents by which the kernels skip G's structural zeros (the reference's
    r5 causal-suffix analysis, pallas_ipm.py:84-92, kept in G's row order):
    - row_lo[r], row_hi[r]: the first and one past the last nonzero column
      of row r (the reference's convention: an all-zero row reaches column
      0); G x and G dx run over them;
    - col_start[c]: the first row from which on lies every row that reaches
      column c (the reference's lo, in G's order); G'v sums column c from
      there;
    - chunk_tiles[k]: for the k-th chunk of `chunk` rows (chunk_rows(nz)),
      how many 16-column tiles its rows reach; the assembly adds the chunk
      into the lower tiles (a, b), b <= a < chunk_tiles[k], and skips every
      other tile, which holds no nonzero of the chunk.
    `meta` packs row_lo, row_hi, col_start and chunk_tiles into one int32
    tensor on G's device, in that order (csrc/mehrotra_wide.cuh Plan); `Gp`
    is G zero-padded to a multiple of `chunk` rows and of TILE columns (the
    kernels copy whole 16-byte pieces of it), `GpT` is G transposed. The
    reference also sorts the rows by their last column; the kernels do not
    (it saves no tile at the DMS shape, 6 % of them at N40, and would
    reorder every sum over the rows)."""

    TILE = 16    # csrc/mehrotra_wide.cuh kTile

    @staticmethod
    def chunk_rows(nz: int) -> int:
        """Rows a staged chunk (csrc/mehrotra_wide.cuh chunk_rows)."""
        return 32 if nz <= 64 else 16

    def __init__(self, G):
        Gt = torch.as_tensor(G, dtype=torch.float32) if not isinstance(G, torch.Tensor) else G
        dev = Gt.device
        Gn = Gt.detach().to("cpu", torch.float32).numpy()
        mI, nz = Gn.shape
        nonzero = Gn != 0
        reach = nonzero.any(axis=1)
        row_hi = np.where(reach, nz - np.argmax(nonzero[:, ::-1], axis=1), 1)
        row_lo = np.where(reach, np.argmax(nonzero, axis=1), 0)
        # rows before col_start[c] all end at or before column c
        col_start = np.searchsorted(np.maximum.accumulate(row_hi), np.arange(nz),
                                    side="right")
        self.chunk = chunk = self.chunk_rows(nz)
        n_chunks = -(-mI // chunk)
        hi_pad = np.zeros(n_chunks * chunk, np.int64)
        hi_pad[:mI] = row_hi
        chunk_tiles = -(-hi_pad.reshape(n_chunks, chunk).max(axis=1) // self.TILE)
        self.mI, self.nz = mI, nz
        self.row_lo, self.row_hi = row_lo, row_hi
        self.col_start, self.chunk_tiles = col_start, chunk_tiles
        self.meta = torch.as_tensor(
            np.concatenate([row_lo, row_hi, col_start, chunk_tiles]).astype(np.int32),
            device=dev)
        Gp = torch.zeros(n_chunks * chunk, -(-nz // self.TILE) * self.TILE,
                         dtype=torch.float32, device=dev)
        Gp[:mI, :nz] = Gt.to(torch.float32)
        self.Gp = Gp
        self.GpT = Gp[:mI, :nz].T.contiguous()

    def assemble_plain(self, d):
        """The kernels' assembly replayed in plain torch: the lower triangle
        of G' diag(d) G (d (B, mI)) summed chunk by chunk over the tiles the
        plan keeps; (B, nz, nz), the upper triangle mirrored."""
        G = self.Gp[:self.mI, :self.nz].to(d.device, d.dtype)
        M = torch.zeros(d.shape[0], self.nz, self.nz, dtype=d.dtype, device=d.device)
        for k, tiles in enumerate(self.chunk_tiles.tolist()):
            r = slice(k * self.chunk, min((k + 1) * self.chunk, self.mI))
            w = min(int(tiles) * self.TILE, self.nz)
            Gc = G[r, :w]
            M[:, :w, :w] += Gc.T @ (d[:, r, None] * Gc)
        return torch.tril(M) + torch.tril(M, -1).transpose(1, 2)


def step_rhs(h0, Hp, G, dx0, z):
    """The SQP's QP right-hand side in step space, h = (h0 + Hp dx0) - G z,
    each product and sum rounded on its own and added in index order: as K3
    forms it in-kernel, so the kernel routes hand their QPs the same h bit
    for bit."""
    h = h0[None, :]
    for j in range(Hp.shape[1]):
        h = h + Hp[:, j] * dx0[:, j, None]
    gz = torch.zeros_like(h)
    for c in range(G.shape[1]):
        gz = gz + G[:, c] * z[:, c, None]
    return h - gz


def _cholesky_floor(M: torch.Tensor, column_order: bool = False) -> torch.Tensor:
    """Left-looking batched Cholesky with the kernel's pivot floor
    sqrt(max(., 1e-30)) (pallas_ipm.py:328); reads M's lower triangle.
    Each column's updates are summed in one matrix product, or, with
    column_order, taken one column at a time in the order 0, 1, ..., as the
    reference's loop subtracts them (and the kernels' loops do): by one
    rank-one update of the trailing matrix a column. Without equilibration
    (K4's QP) late float32 Mehrotra iterations leave M's condition near
    1/eps, and there the matrix product's rounding drove pivots to the floor
    and lanes to NaN ten times as often as the reference (ROADMAP §3). K2's
    and K3's plain versions keep the matrix product: with the column order
    the float32 pallas_mono hybrid on the CPU left the golden envelope
    within 40 steps (tests/test_torch_parity.py, 0.0207 against 2e-2)."""
    nz = M.shape[-1]
    L = torch.zeros_like(M)
    if column_order:
        A = M
        rows = torch.arange(nz, device=M.device)
        for j in range(nz):
            djj = torch.sqrt(torch.clamp(A[:, j, j], min=1e-30))
            col = torch.where(rows >= j, A[:, :, j] / djj[:, None], 0.0)
            L[:, :, j] = col
            if j + 1 < nz:
                A = A - col[:, :, None] * col[:, None, :]
        return L
    for j in range(nz):
        acc = M[:, :, j] - (L[:, :, :j] @ L[:, j, :j, None])[..., 0]
        djj = torch.sqrt(torch.clamp(acc[:, j], min=1e-30))
        col = acc / djj[:, None]
        col[:, :j] = 0.0
        L[:, :, j] = col
    return L


def mehrotra_h_plain(G, H, g, h, iters: int, tau: float = 0.995,
                     d_cap: float = 1e6, warm=None, warm_eps: float = 1e-5,
                     equilibrate: bool = True, pad_rows: int = 0,
                     column_order: bool = False):
    """The plain PyTorch version of the kernels' loop (same iteration,
    batched tensor ops). H is (B, nz, nz) or one (nz, nz). pad_rows appends
    K4's reference padding: rows G = 0, h = 1e6 (s = 1e6, z = 1), outside mu.
    column_order: the Cholesky's updates one column at a time
    (_cholesky_floor). Returns (x (B, nz), mu (B,), (s, z))."""
    Bsz, nz = g.shape
    mI = G.shape[0]
    if pad_rows:
        G = F_.pad(G, (0, 0, 0, pad_rows))
        h = F_.pad(h, (0, pad_rows), value=BIG)
    x = torch.zeros(Bsz, nz, dtype=g.dtype, device=g.device)
    if warm is None:
        s = torch.clamp(h, min=1.0)
        z = torch.ones_like(h)
    else:
        s = torch.clamp(warm[0], min=warm_eps)
        z = torch.clamp(warm[1], min=warm_eps)
    eye = RIDGE * torch.eye(nz, dtype=g.dtype, device=g.device)
    Gt = G.T

    def mean(v):
        return v[:, :mI].sum(dim=1) / mI

    def ratio_min(v, dv):
        ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), BIG)
        return ratio.amin(dim=1)

    for _ in range(iters):
        rd = (H @ x[..., None])[..., 0] + g + z @ G
        rp = x @ Gt + s - h
        s_safe = torch.clamp(s, min=1e-25)
        d = torch.clamp(z / s_safe, max=d_cap)
        M = (Gt * d[:, None, :]) @ G + H + eye
        if equilibrate:
            sc = torch.rsqrt(torch.clamp(torch.diagonal(M, dim1=1, dim2=2), min=1e-30))
        else:
            sc = torch.ones_like(x)
        L = _cholesky_floor(M * sc[:, :, None] * sc[:, None, :], column_order)

        def kkt(rc):
            t = d * rp - rc / s_safe
            b = -(rd + t @ G) * sc
            y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
            u = torch.linalg.solve_triangular(L.transpose(1, 2), y, upper=True)
            dx = u[..., 0] * sc
            Gdx = dx @ Gt
            return dx, -rp - Gdx, d * (rp + Gdx) - rc / s_safe

        mu = mean(s * z)
        _, dsa, dza = kkt(s * z)
        ap = torch.clamp(ratio_min(s, dsa), max=1.0)[:, None]
        ad = torch.clamp(ratio_min(z, dza), max=1.0)[:, None]
        mu_aff = mean((s + ap * dsa) * (z + ad * dza))
        sr = mu_aff / torch.clamp(mu, min=1e-25)
        sigma = sr * sr * sr
        dx, ds, dz = kkt(s * z + dsa * dza - (sigma * mu)[:, None])
        ap = torch.clamp(tau * ratio_min(s, ds), max=1.0)[:, None]
        ad = torch.clamp(tau * ratio_min(z, dz), max=1.0)[:, None]
        x = x + ap * dx
        s = s + ap * ds
        z = z + ad * dz
    return x, mean(s * z), (s[:, :mI], z[:, :mI])


def _check_sizes(name: str, nz: int, mI: int, nz_max: int = NZ_MAX) -> None:
    if nz > nz_max or mI > MI_MAX:
        raise ValueError(f"the {name} kernel takes nz <= {nz_max} and mI <= {MI_MAX} "
                         f"(got nz={nz}, mI={mI})")


def mehrotra_h(G, H, g, h, iters: int, tau: float = 0.995, d_cap: float = 1e6,
               warm=None, warm_eps: float = 1e-5, want_state: bool = False,
               plan: WidePlan | None = None):
    """Route one batched solve: CUDA tensors launch K2 (nz <= 32) or K2w
    (32 < nz <= 128, on `plan`, G's WidePlan, computed here when not given),
    CPU tensors take mehrotra_h_plain. Returns (x, mu, (s, z) or None)."""
    if g.device.type == "cpu":
        x, mu, state = mehrotra_h_plain(G, H, g, h, iters, tau, d_cap, warm,
                                        warm_eps)
        return x, mu, (state if want_state else None)
    if g.device.type != "cuda":
        raise ValueError(f"mehrotra_h runs on cuda or cpu, not {g.device}")
    dev = g.device
    Bsz, nz = g.shape
    mI = G.shape[0]
    _check_sizes("mehrotra_h (K2) / mehrotra_h_wide (K2w)", nz, mI, NZ_MAX_WIDE)
    check("G", G, (mI, nz), dev)
    check("H", H, (Bsz, nz, nz), dev)
    check("g", g, (Bsz, nz), dev)
    check("h", h, (Bsz, mI), dev)
    if warm is not None:
        check("warm s", warm[0], (Bsz, mI), dev)
        check("warm z", warm[1], (Bsz, mI), dev)
    x = torch.empty(Bsz, nz, dtype=torch.float32, device=dev)
    mu = torch.empty(Bsz, dtype=torch.float32, device=dev)
    state = ((torch.empty(Bsz, mI, dtype=torch.float32, device=dev),
              torch.empty(Bsz, mI, dtype=torch.float32, device=dev))
             if want_state else None)
    null = P(None)
    extra = ()
    if nz <= NZ_MAX:
        kernel, g_args = KERNEL, (ptr(G),)
        extra = (I(narrow_launch(mI, nz, Bsz, sms=sm_count(dev))[0]),)
    else:
        if plan is None:
            plan = WidePlan(G)
        check_plan(plan, mI, nz, dev)
        kernel, g_args = KERNEL_WIDE, (ptr(plan.Gp), ptr(plan.GpT), ptr(plan.meta))
    kernel.launch(dev, *g_args, ptr(H), ptr(g), ptr(h),
                  ptr(warm[0]) if warm is not None else null,
                  ptr(warm[1]) if warm is not None else null,
                  ptr(x), ptr(mu),
                  ptr(state[0]) if want_state else null,
                  ptr(state[1]) if want_state else null,
                  I(Bsz), I(mI), I(nz), I(iters), F(tau), F(d_cap),
                  F(warm_eps), *extra)
    return x, mu, state


def check_plan(plan: WidePlan, mI: int, nz: int, device) -> None:
    """Raise unless `plan` is a WidePlan of an (mI, nz) G on `device`."""
    if (plan.mI, plan.nz) != (mI, nz):
        raise ValueError(f"the plan is for G {(plan.mI, plan.nz)}, not {(mI, nz)}")
    check("plan.Gp", plan.Gp, tuple(plan.Gp.shape), device)
    check("plan.GpT", plan.GpT, (nz, mI), device)
    check("plan.meta", plan.meta, tuple(plan.meta.shape), device, torch.int32)


class QPSolverH:
    """A Mehrotra QP solver for a fixed G and schedule (the reference's
    build_pallas_qp_solver_h): `solver(H_b, g, h, warm=None)` is `raw`;
    `raw_packed` is the K1 hand-off entry (H straight from the GN kernel,
    (B, nz, nz) float32, used without a copy); `cold_state(h)` is the warm
    state equal to a cold start. Returns (x, mu) or, with warm_out,
    (x, mu, (s, z))."""

    def __init__(self, G, iters: int = 16, tau: float = 0.995,
                 d_cap: float = 1e6, warm_in: bool = False,
                 warm_out: bool = False, warm_eps: float = 1e-5, device=None,
                 plain: bool = False):
        dev = resolve_device(device)
        self.G = torch.as_tensor(np.asarray(G, np.float32), device=dev)
        self.iters, self.tau, self.d_cap = int(iters), float(tau), float(d_cap)
        self.warm_in, self.warm_out = bool(warm_in), bool(warm_out)
        self.warm_eps = float(warm_eps)
        self.plain = plain
        self._plan = None

    @property
    def plan(self) -> WidePlan:
        """K2w's host plan of G, computed once at the first use."""
        if self._plan is None:
            self._plan = WidePlan(self.G)
        return self._plan

    def __call__(self, H_b, g, h, warm=None):
        return self.raw_packed(H_b.to(torch.float32).contiguous(), g, h, warm)

    def raw_packed(self, H, g, h, warm=None):
        if self.warm_in and warm is None:
            raise ValueError("a warm_in solver needs the previous QP's warm state")
        if not self.warm_in:
            warm = None
        g = g.to(torch.float32).contiguous()
        h = h.to(torch.float32).contiguous()
        if self.plain:
            x, mu, state = mehrotra_h_plain(self.G, H, g, h, self.iters,
                                            self.tau, self.d_cap, warm,
                                            self.warm_eps)
        else:
            wide = g.device.type == "cuda" and self.G.shape[1] > NZ_MAX
            x, mu, state = mehrotra_h(self.G, H, g, h, self.iters, self.tau,
                                      self.d_cap, warm, self.warm_eps,
                                      want_state=self.warm_out,
                                      plan=self.plan if wide else None)
        return (x, mu, state) if self.warm_out else (x, mu)

    @staticmethod
    def cold_state(h):
        """(s, z) = (max(h, 1), 1): fed to a warm_in solver it reproduces the
        cold start bit for bit (max(s, eps) and max(z, eps) are identities)."""
        h = h.to(torch.float32)
        return torch.clamp(h, min=1.0), torch.ones_like(h)


def mehrotra_plain(G, H, g, h, iters: int, tau: float = 0.995):
    """K4's plain version: the shared-H solve (d capped at 1e7, no
    equilibration, the reference's padded rows) and the reference's
    converged flag, mu < 2e-4 (1 + mu mI) and max |G x + s - h| < 2e-3 over
    the real rows. H is (nz, nz). Returns (x (B, nz), conv (B,) bool,
    mu (B,))."""
    mI = G.shape[0]
    # the reference pads mI to a multiple of 128
    x, mu, (s, z) = mehrotra_h_plain(G, H, g, h, iters, tau, SHARED_D_CAP,
                                     equilibrate=False, pad_rows=-mI % 128,
                                     column_order=True)
    rp = x @ G.T + s - h
    conv = (mu < 2e-4 * (1.0 + mu * mI)) & (rp.abs().amax(dim=1) < 2e-3)
    return x, conv, mu


def mehrotra(G, H, g, h, iters: int, tau: float = 0.995):
    """Route one shared-H batched solve: CUDA tensors launch K4, CPU tensors
    take mehrotra_plain. Returns (x, conv, mu)."""
    if g.device.type == "cpu":
        return mehrotra_plain(G, H, g, h, iters, tau)
    if g.device.type != "cuda":
        raise ValueError(f"mehrotra runs on cuda or cpu, not {g.device}")
    dev = g.device
    Bsz, nz = g.shape
    mI = G.shape[0]
    _check_sizes("mehrotra", nz, mI)
    check("G", G, (mI, nz), dev)
    check("H", H, (nz, nz), dev)
    check("g", g, (Bsz, nz), dev)
    check("h", h, (Bsz, mI), dev)
    x = torch.empty(Bsz, nz, dtype=torch.float32, device=dev)
    conv = torch.empty(Bsz, dtype=torch.bool, device=dev)
    mu = torch.empty(Bsz, dtype=torch.float32, device=dev)
    lanes = shared_launch(mI, nz, Bsz, sms=sm_count(dev))[0]
    KERNEL_SHARED.launch(dev, ptr(G), ptr(H), ptr(g), ptr(h), ptr(x), ptr(conv), ptr(mu),
                         I(Bsz), I(mI), I(nz), I(iters), F(tau), F(SHARED_D_CAP), I(lanes))
    return x, conv, mu


class QPSolver:
    """The shared-H Mehrotra QP solver (the reference's
    build_pallas_qp_solver): H (nz, nz) and G (mI, nz) fixed at build time,
    `solve(g (B, nz), h (B, mI))` -> (x (B, nz), converged (B,)), float32,
    any batch size (no lane tile). plain=True runs the plain version on the
    solver's device."""

    def __init__(self, H, G, iters: int = 20, tau: float = 0.995, device=None,
                 plain: bool = False):
        dev = resolve_device(device)
        self.H = torch.as_tensor(np.asarray(H, np.float32), device=dev)
        self.G = torch.as_tensor(np.asarray(G, np.float32), device=dev)
        _check_sizes("mehrotra", *self.G.shape[::-1])
        self.iters, self.tau = int(iters), float(tau)
        self.device = dev
        self.plain = plain

    def solve(self, g, h):
        g = torch.as_tensor(g, dtype=torch.float32, device=self.device).contiguous()
        h = torch.as_tensor(h, dtype=torch.float32, device=self.device).contiguous()
        fn = mehrotra_plain if self.plain else mehrotra
        return fn(self.G, self.H, g, h, self.iters, self.tau)[:2]
