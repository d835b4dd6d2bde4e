"""K3 and K3w — one launch per Gauss-Newton iteration: the GN phase and the
whole cold Mehrotra QP loop of every lane.

Port of lbmpc_tpu/ops/pallas_gn.py, build_pallas_gn_kernel(...,
ipm=dict(iters, d_cap)) -> kernel_ipm (the qp_kernel="pallas_mono" route of
controllers/sqp_fused), over its domain in two kernels:
- K3 (csrc/gn_mehrotra.cu): the fmincon family at nz <= 32, K1's GN body
  and K2's loop on one warp a lane, several lanes a block (the launch shape
  from ops/qp_kernel.narrow_launch);
- K3w (csrc/gn_mehrotra_wide.cu): every other shape up to nz = 128, both
  families, K1w's GN body and K2w's loop (LBMPC_N40 uncut, LBMPC_N50, the
  casadi shapes the reference's VMEM model admits).
Per lane the kernel runs the GN phase (residual e, H = 2J'J + 1e-6 I + the
constant rows, g = 2J'e), forms the QP's step-space right-hand side
h = (h0 + Hp dx0) - G z, and runs the Mehrotra loop cold on (H, g, G, h). It
returns e (B, ne), the step d (B, nz), mu (B,) and g (B, nz); H never leaves
the kernel. The wrapper routes by device: a CUDA tensor always launches a
kernel (K3 or K3w by shape, or raises); a CPU tensor takes the plain
version, the composition GNPhase.plain -> step_rhs -> mehrotra_h_plain
(cold).
"""

from __future__ import annotations

import torch

from lbmpc_tpu_torch.oracle import DataWindow
from lbmpc_tpu_torch.ops._cuda import WIDE_FLAGS, F, I, P, CudaKernel, check, ptr
from lbmpc_tpu_torch.ops.gn_kernel import GNPhase
from lbmpc_tpu_torch.ops.qp_kernel import (MI_MAX, WidePlan, check_plan, mehrotra_h_plain,
                                           narrow_launch, sm_count, step_rhs)

KERNEL = CudaKernel("gn_mehrotra", [P] * 13 + [I, I, I, I, I, F, F, I, P])
KERNEL_WIDE = CudaKernel("gn_mehrotra_wide", [P] * 15 + [I, I, I, I, I, F, F, I, P],
                         flags=WIDE_FLAGS)


class MonoPhase:
    """K3 / K3w for one condensed QP and one IPM iteration count: GN phase +
    cold Mehrotra loop. `gn` is the solver's GNPhase (its constants and plain
    version); G (mI, nz), h0 (mI,) and Hp (mI, n) are float32 tensors on
    gn's device. Calling it returns (e, d, mu, g) for z (B, nz), dx0 (B, n)
    and a window batched over the same lanes. `narrow` says K3 takes the
    shape (K1's: fmincon at nz <= 32), `wide` K3w (K1w's); `kernel_ok`
    either."""

    def __init__(self, gn: GNPhase, G, h0, Hp, iters: int, d_cap: float = 1e6,
                 tau: float = 0.995):
        self.gn = gn
        self.G, self.h0, self.Hp = G, h0, Hp
        self.iters, self.d_cap, self.tau = int(iters), float(d_cap), float(tau)
        rows_ok = G.shape[0] <= MI_MAX
        self.narrow = gn.narrow and rows_ok
        self.wide = gn.wide and rows_ok
        self.kernel_ok = self.narrow or self.wide
        self._plan = None

    @property
    def plan(self) -> WidePlan:
        """K3w's host plan of G (K2w's), computed once at the first use."""
        if self._plan is None:
            self._plan = WidePlan(self.G)
        return self._plan

    def plain(self, z, dx0, window: DataWindow):
        """The plain PyTorch version: same function, any device."""
        e, H, g = self.gn.plain(z, dx0, window)
        h = step_rhs(self.h0, self.Hp, self.G, dx0, z)
        d, mu, _ = mehrotra_h_plain(self.G, H, g, h, self.iters, self.tau, self.d_cap)
        return e, d, mu, g

    def __call__(self, z, dx0, window: DataWindow):
        if z.device.type == "cpu":
            return self.plain(z, dx0, window)
        if z.device.type != "cuda":
            raise ValueError(f"gn_mehrotra runs on cuda or cpu, not {z.device}")
        return self._launch(z, dx0, window)

    def _launch(self, z, dx0, window: DataWindow):
        if not self.kernel_ok:
            raise ValueError(
                "the GN + Mehrotra kernels cover n=4, m=1, one theta and mI <= "
                f"{MI_MAX}: gn_mehrotra (K3) the fmincon family at nz <= 32, "
                "gn_mehrotra_wide (K3w) both families at nz <= 128; got "
                f"family={self.gn.family!r}, nz={self.gn.nz}, mI={self.G.shape[0]}")
        gn = self.gn
        dev = z.device
        Bsz = z.shape[0]
        q = window.X.shape[-2]
        mI = self.G.shape[0]
        check("z", z, (Bsz, gn.nz), dev)
        check("dx0", dx0, (Bsz, gn.n), dev)
        check("window.X", window.X, (Bsz, q, 3), dev)
        check("window.Y", window.Y, (Bsz, q, gn.n), dev)
        check("window.valid", window.valid, (Bsz, q), dev)
        check("constants", gn.cst, tuple(gn.cst.shape), dev)
        check("G", self.G, (mI, gn.nz), dev)
        check("h0", self.h0, (mI,), dev)
        check("Hp", self.Hp, (mI, gn.n), dev)
        f32 = dict(dtype=torch.float32, device=dev)
        e = torch.empty(Bsz, gn.ne, **f32)
        d = torch.empty(Bsz, gn.nz, **f32)
        mu = torch.empty(Bsz, **f32)
        g = torch.empty(Bsz, gn.nz, **f32)
        rest = (ptr(self.h0), ptr(self.Hp), ptr(e), ptr(d), ptr(mu), ptr(g), I(Bsz),
                I(gn.N), I(q), I(mI), I(self.iters), F(self.tau), F(self.d_cap))
        win = (ptr(gn.cst), ptr(z), ptr(dx0), ptr(window.X), ptr(window.Y),
               ptr(window.valid))
        if self.narrow:
            warps = narrow_launch(mI, gn.nz, Bsz, q=q, sms=sm_count(dev))[0]
            KERNEL.launch(dev, *win, ptr(self.G), *rest, I(warps))
        else:
            plan = self.plan
            check_plan(plan, mI, gn.nz, dev)
            KERNEL_WIDE.launch(dev, *win, ptr(plan.Gp), ptr(plan.GpT), ptr(plan.meta), *rest,
                               I(int(gn.family == "casadi")))
        return e, d, mu, g
