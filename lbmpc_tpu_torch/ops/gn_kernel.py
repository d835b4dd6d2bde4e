"""K1 and K1w — the Gauss-Newton phase: learned-rollout residual e,
H = 2J'J + Hconst and g = 2J'e for every lane, in one launch.

Port of lbmpc_tpu/ops/pallas_gn.py (build_pallas_gn_kernel) over its
domain, the m=1 model with n=4 states and one theta, in two kernels:
- K1 (csrc/gn_phase.cu, one warp per lane, several lanes a block: the
  shape from `narrow_gn_launch`): the fmincon family at nz <= 32;
- K1w (csrc/gn_wide.cu, one warp per lane, several lanes a block: the
  shape from `wide_launch`): every other shape up to nz = 128, both
  families — the casadi DMS flagship (nz=101) and the fmincon family above
  nz 32 (LBMPC_N40 uncut, nz=41).
The wrapper routes by device: a CUDA tensor always launches a kernel (K1 or
K1w by shape, or raises); a CPU tensor takes the plain version, which
builds J with controllers/lbmpc.make_residual_and_jac and forms the normal
terms with matrix products. H comes out as (B, nz, nz), row-major and
symmetric — the layout ops/qp_kernel.py's kernels read without a copy.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmpc_tpu_torch.controllers.lbmpc import (make_residual_and_jac,
                                               residual_rows)
from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops._cuda import WIDE_FLAGS, I, P, CudaKernel, check, ptr
from lbmpc_tpu_torch.ops.qp_kernel import H100_SMS, lanes_a_block, sm_count

KERNEL = CudaKernel("gn_phase", [P] * 9 + [I, I, I, I, P])
KERNEL_WIDE = CudaKernel("gn_wide", [P] * 9 + [I, I, I, I, I, P], flags=WIDE_FLAGS)
NZ_MAX, NZ_MAX_WIDE = 32, 128   # csrc/gn_body.cuh, csrc/gn_wide_body.cuh kNzMax
WIDE_MAX_LANES = 8              # csrc/gn_wide.cu kMaxLanes
NARROW_MAX_LANES = 8            # csrc/gn_phase.cu kMaxLanes

# constant block offsets (csrc/gn_body.cuh and gn_wide_body.cuh enums)
_C_A, _C_B, _C_KS, _C_LQ, _C_LP, _C_LAM, _C_XSREF = 0, 16, 20, 24, 40, 56, 60
_C_LR, _C_PSI, _C_SQRTT, _C_INVBW2, _C_RIDGE, _C_SQD, _C_HCONST = (
    64, 65, 66, 67, 68, 69, 72)
_RIDGE_H = 1e-6


def wide_virtual_warps(nz: int) -> int:
    """The warps of gnw::threads(nz) (csrc/gn_wide_body.cuh: 64 threads up to
    nz = 64, 128 above), whose order K1w's NW sums keep."""
    return 2 if nz <= 64 else 4


def wide_smem_bytes(nz: int, q: int, lanes: int) -> int:
    """K1w's dynamic shared memory for a block of `lanes` lanes
    (csrc/gn_wide.cu lane_floats): the constants once a block, and a lane's
    Jacobian rows (5 nz), window (8 q) and packed lower triangle of H,
    rounded up to 4 floats."""
    lane = -(-(5 * nz + 8 * q + nz * (nz + 1) // 2) // 4) * 4
    return 4 * (_C_HCONST + lanes * lane)


def narrow_gn_smem_bytes(nz: int, q: int, lanes: int) -> int:
    """K1's dynamic shared memory for a block of `lanes` lanes
    (csrc/gn_phase.cu lane_floats): each lane's constants before Hconst,
    window (8 q), Jacobian rows (5 x 32) (csrc/gn_body.cuh work_floats) and
    H's accumulator (nz x nz), rounded up to 4 floats."""
    lane = -(-(_C_HCONST + 8 * q + 5 * 32 + nz * nz) // 4) * 4
    return 4 * lanes * lane


def narrow_gn_launch(nz: int, q: int, B: int, sms: int = H100_SMS) -> tuple:
    """K1's launch shape for B lanes at nz decision variables and a window
    of q points on a card of `sms` SMs: (lanes a block, blocks, the block's
    shared memory in bytes). A warp runs a lane; a block holds the most
    lanes, a power of two up to NARROW_MAX_LANES, that still give every SM
    a block (a small batch, such as the repair's 24 lanes, sees one lane's
    latency, so it spreads as wide as it can) and fit the opt-in shared
    memory. Raises where the kernel does not take the shape (the fmincon
    family's N >= 3: 4 <= nz <= NZ_MAX) or one lane does not fit."""
    if not (4 <= nz <= NZ_MAX and q >= 1 and B >= 0):
        raise ValueError(f"K1 takes 4 <= nz <= {NZ_MAX} (N >= 3), q >= 1 and a batch B >= 0 "
                         f"(got nz={nz}, q={q}, B={B})")
    return lanes_a_block(B, NARROW_MAX_LANES, sms, lambda n: narrow_gn_smem_bytes(nz, q, n),
                         f"K1 at nz={nz}, q={q}")


def wide_launch(nz: int, q: int, B: int, sms: int = H100_SMS) -> tuple:
    """K1w's launch shape for B lanes at nz decision variables and a window
    of q points on a card of `sms` SMs: (lanes a block, blocks, the block's
    shared memory in bytes). A warp runs a lane; a block holds the most
    lanes, a power of two up to WIDE_MAX_LANES, that still give every SM a
    block (up to `sms` lanes each has a block of its own) and fit the
    opt-in shared memory. Raises where the kernel does not take the shape or
    one lane does not fit."""
    if not (2 <= nz <= NZ_MAX_WIDE and q >= 1 and B >= 0):
        raise ValueError(f"K1w takes 2 <= nz <= {NZ_MAX_WIDE}, q >= 1 and a batch B >= 0 "
                         f"(got nz={nz}, q={q}, B={B})")
    return lanes_a_block(B, WIDE_MAX_LANES, sms, lambda n: wide_smem_bytes(nz, q, n),
                         f"K1w at nz={nz}, q={q}")


class GNPhase:
    """K1 / K1w for one condensed QP: holds the kernels' constant block and
    the plain version's residual/Jacobian functions (float32, on `device`).
    `narrow` says K1 takes the shape, `wide` K1w; `kernel_ok` either.

    Calling it returns (e (B, ne), H (B, nz, nz), g (B, nz)) for
    z (B, nz), dx0 (B, n) and a window batched over the same lanes."""

    def __init__(self, qp, A, B, Ks, w, family: str = "fmincon",
                 delta: float = 0.01, bandwidth: float = 0.5,
                 ridge: float = 0.001, dx_ref=None, device=None):
        self.device = resolve_device(device)
        self.N, self.n, self.m = qp.N, qp.n, qp.m
        self.nz = qp.nz
        self.family = family
        self.ne = residual_rows(qp.N, qp.n, qp.m, family)
        self.residual, self.res_jac = make_residual_and_jac(
            qp, A, B, Ks, w, family=family, delta=delta, bandwidth=bandwidth,
            ridge=ridge, dx_ref=dx_ref, dtype=torch.float32, device=self.device)
        self._eye = _RIDGE_H * torch.eye(self.nz, dtype=torch.float32,
                                         device=self.device)
        nth = np.atleast_2d(np.asarray(w.LAMBDA)).shape[1]
        model = (family in ("fmincon", "casadi") and qp.n == 4 and qp.m == 1
                 and nth == 1 and qp.N >= (3 if family == "fmincon" else 1))
        self.narrow = model and family == "fmincon" and qp.nz <= NZ_MAX
        self.wide = model and not self.narrow and qp.nz <= NZ_MAX_WIDE
        self.kernel_ok = self.narrow or self.wide
        if self.kernel_ok:
            self.cst = self._constants(A, B, Ks, w, delta, bandwidth, ridge, dx_ref)

    def _constants(self, A, B, Ks, w, delta, bandwidth, ridge,
                   dx_ref) -> torch.Tensor:
        nz, N = self.nz, self.N
        c = np.zeros(_C_HCONST + nz * nz)
        c[_C_A:_C_A + 16] = np.asarray(A, float).ravel()
        c[_C_B:_C_B + 4] = np.asarray(B, float).ravel()
        c[_C_KS:_C_KS + 4] = np.asarray(Ks, float).ravel()
        c[_C_LQ:_C_LQ + 16] = np.asarray(w.Lq, float).ravel()
        c[_C_LP:_C_LP + 16] = np.asarray(w.Lp, float).ravel()
        LAM = np.asarray(w.LAMBDA, float).ravel()
        c[_C_LAM:_C_LAM + 4] = LAM
        c[_C_XSREF:_C_XSREF + 4] = (np.zeros(4) if dx_ref is None
                                    else np.asarray(dx_ref, float))
        c[_C_LR] = float(np.asarray(w.Lr).ravel()[0])
        c[_C_PSI] = float(np.asarray(w.PSI).ravel()[0])
        c[_C_SQRTT] = float(w.sqrtT)
        c[_C_INVBW2] = 1.0 / (bandwidth * bandwidth)
        c[_C_RIDGE] = ridge
        casadi = self.family == "casadi"
        sqd = float(np.sqrt(delta)) if casadi else 1.0
        c[_C_SQD] = sqd
        # Hconst: the SQP's ridge and the constant rT rows' 2 J'J block; for
        # casadi also the du rows', sqrt(delta) Lr (E_k - PSI_T), whose
        # Jacobian does not depend on the lane (pallas_gn.py:118-125)
        JrT = np.zeros((4, nz))
        JrT[:, N] = w.sqrtT * LAM
        Hc = _RIDGE_H * np.eye(nz) + 2.0 * JrT.T @ JrT
        if casadi:
            Lr = float(np.asarray(w.Lr).ravel()[0])
            PSI_T = np.zeros(nz)
            PSI_T[N] = float(np.asarray(w.PSI).ravel()[0])
            for k in range(N):
                Jru = -sqd * Lr * PSI_T
                Jru[k] += sqd * Lr
                Hc += 2.0 * np.outer(Jru, Jru)
        c[_C_HCONST:] = Hc.ravel()
        return torch.as_tensor(c, dtype=torch.float32, device=self.device)

    def plain(self, z, dx0, window: DataWindow, jac_mode: str = "manual"):
        """The plain PyTorch version: same function, any device.
        jac_mode="jacfwd" takes J from torch.func.jacfwd of one lane's
        residual, vmapped over the lanes, in place of the hand-derived
        sensitivities."""
        if jac_mode == "jacfwd":
            e, J = self.residual(z, dx0, window), self.jacfwd(z, dx0, window)
        else:
            e, J = self.res_jac(z, dx0, window)
        Jt = J.transpose(1, 2)
        H = 2.0 * (Jt @ J) + self._eye
        g = 2.0 * (Jt @ e[..., None])[..., 0]
        return e, H, g

    def jacfwd(self, z, dx0, window: DataWindow):
        """J (B, ne, nz) of the residual by forward-mode autodiff of one
        lane, vmapped over the lanes."""
        def one(z1, dx1, *win):
            return self.residual(z1[None], dx1[None],
                                 DataWindow(*(a[None] for a in win)))[0]

        return torch.func.vmap(torch.func.jacfwd(one))(z, dx0, *window)

    def __call__(self, z, dx0, window: DataWindow):
        if z.device.type == "cpu":
            return self.plain(z, dx0, window)
        if z.device.type != "cuda":
            raise ValueError(f"gn_phase runs on cuda or cpu, not {z.device}")
        return self._launch(z, dx0, window)

    def _launch(self, z, dx0, window: DataWindow):
        if not self.kernel_ok:
            raise ValueError(
                "the GN kernels cover n=4, m=1 and one theta: gn_phase (K1) the "
                f"fmincon family at nz <= {NZ_MAX}, gn_wide (K1w) both families at "
                f"nz <= {NZ_MAX_WIDE}; got family={self.family!r}, nz={self.nz}")
        dev = z.device
        Bsz = z.shape[0]
        q = window.X.shape[-2]
        check("z", z, (Bsz, self.nz), dev)
        check("dx0", dx0, (Bsz, self.n), dev)
        check("window.X", window.X, (Bsz, q, 3), dev)
        check("window.Y", window.Y, (Bsz, q, self.n), dev)
        check("window.valid", window.valid, (Bsz, q), dev)
        check("constants", self.cst, tuple(self.cst.shape), dev)
        e = torch.empty(Bsz, self.ne, dtype=torch.float32, device=dev)
        H = torch.empty(Bsz, self.nz, self.nz, dtype=torch.float32, device=dev)
        g = torch.empty(Bsz, self.nz, dtype=torch.float32, device=dev)
        args = (ptr(self.cst), ptr(z), ptr(dx0), ptr(window.X), ptr(window.Y),
                ptr(window.valid), ptr(e), ptr(H), ptr(g), I(Bsz), I(self.N), I(q))
        if self.narrow:
            lanes = narrow_gn_launch(self.nz, q, Bsz, sms=sm_count(dev))[0]
            KERNEL.launch(dev, *args, I(lanes))
        else:
            lanes = wide_launch(self.nz, q, Bsz, sms=sm_count(dev))[0]
            KERNEL_WIDE.launch(dev, *args, I(int(self.family == "casadi")), I(lanes))
        return e, H, g
