"""Roofline accounting for the batched solver paths, in H100 units.

Port of lbmpc_tpu/analysis/roofline.py: a speed-of-light denominator for a
measured call time. The peaks are the published H100 SXM ones (NVIDIA's data
sheet, dense rates, 700 W): 67 TFLOP/s in float32 outside the tensor cores
and 3.35 TB/s of HBM. The port turns TF32 off (lbmpc_tpu_torch/__init__.py),
so every float32 operation, matrix products included, is held to the 67
TFLOP/s: the op-class split below is a matrix-product class and an
elementwise class, both against that one peak. The reference's TPU peaks and
its MXU/VPU split are not carried over.

The analytic counts (`fused_sqp_flops_per_solve`, `fused_sqp_op_split`) are
the reference's arithmetic and return its numbers; `program_costs` counts a
call's torch operations (see there).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lbmpc_tpu_torch.ops.qp_kernel import analyze_constraint_rows

H100_F32_FLOPS = 67e12        # float32 outside the tensor cores, H100 SXM
H100_HBM_BYTES_S = 3.35e12    # HBM3, H100 SXM


@dataclasses.dataclass(frozen=True)
class Roofline:
    """Per-call cost + achieved rates for one solver call."""

    flops_per_call: float
    bytes_per_call: float
    call_s: float
    solves_per_call: int
    peak_flops: float = H100_F32_FLOPS
    peak_bytes_s: float = H100_HBM_BYTES_S
    # optional op-class split of flops_per_call (matrix products, and
    # elementwise / reduction / sequential work); None = split unknown
    matmul_flops_per_call: float | None = None
    elementwise_flops_per_call: float | None = None

    @property
    def flops_per_solve(self) -> float:
        return self.flops_per_call / max(self.solves_per_call, 1)

    @property
    def achieved_flops(self) -> float:
        return self.flops_per_call / self.call_s

    @property
    def achieved_bytes_s(self) -> float:
        return self.bytes_per_call / self.call_s

    @property
    def flop_util(self) -> float:
        """Achieved FLOP rate against the float32 peak."""
        return self.achieved_flops / self.peak_flops

    @property
    def hbm_util(self) -> float:
        return self.achieved_bytes_s / self.peak_bytes_s

    @property
    def arithmetic_intensity(self) -> float:
        """FLOPs per HBM byte; the float32 ridge point is 67e12 / 3.35e12 =
        20 FLOP/B."""
        return self.flops_per_call / max(self.bytes_per_call, 1.0)

    @property
    def matmul_util(self) -> float | None:
        """Achieved matrix-product FLOP rate against the float32 peak."""
        if self.matmul_flops_per_call is None:
            return None
        return (self.matmul_flops_per_call / self.call_s) / self.peak_flops

    @property
    def elementwise_util(self) -> float | None:
        """Achieved elementwise FLOP rate against the float32 peak."""
        if self.elementwise_flops_per_call is None:
            return None
        return (self.elementwise_flops_per_call / self.call_s) / self.peak_flops

    @property
    def sol_s(self) -> float | None:
        """Speed-of-light call time: both operation classes at the float32
        peak and the bytes at the HBM peak, serialized (a sum, not a max: a
        conservative upper bound on the light). None when the op-class split
        is unknown."""
        if self.matmul_flops_per_call is None or self.elementwise_flops_per_call is None:
            return None
        return ((self.matmul_flops_per_call + self.elementwise_flops_per_call)
                / self.peak_flops + self.bytes_per_call / self.peak_bytes_s)

    @property
    def sol_frac(self) -> float | None:
        """Fraction of speed-of-light achieved: sol_s / call_s. The gap is
        issue, dispatch and dependency overhead the counts cannot explain."""
        return None if self.sol_s is None else self.sol_s / self.call_s

    @property
    def bound(self) -> str:
        """The resource the call is closer to saturating: "FP32", "HBM", or
        "issue/overhead" when none is near its peak (below 50 % with the
        op-class split, below 10 % without it)."""
        mu, eu = self.matmul_util, self.elementwise_util
        if mu is not None and eu is not None:
            best = max(mu, eu, self.hbm_util)
            if best < 0.5:
                return "issue/overhead"
            return "HBM" if best == self.hbm_util else "FP32"
        if max(self.flop_util, self.hbm_util) < 0.10:
            return "issue/overhead"
        return "FP32" if self.flop_util >= self.hbm_util else "HBM"

    def as_dict(self) -> dict:
        d = {
            "flops_per_solve": round(self.flops_per_solve, 1),
            "achieved_gflops": round(self.achieved_flops / 1e9, 1),
            "fp32_util": round(self.flop_util, 4),
            "hbm_gb_s": round(self.achieved_bytes_s / 1e9, 1),
            "hbm_util": round(self.hbm_util, 4),
            "arith_intensity_flop_per_byte": round(self.arithmetic_intensity, 1),
            "bound": self.bound,
        }
        if self.elementwise_util is not None:
            d["matmul_util_vs_fp32_peak"] = round(self.matmul_util, 4)
            d["elementwise_util_vs_fp32_peak"] = round(self.elementwise_util, 4)
            d["sol_call_ms"] = round(self.sol_s * 1e3, 3)
            d["sol_frac"] = round(self.sol_frac, 4)
        return d


def _tensors(obj) -> list:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    return []


def program_costs(fn, *args) -> tuple[float, float]:
    """(flops, bytes) of one call fn(*args).

    flops: torch.utils.flop_counter.FlopCounterMode's count of the call's
    torch operations (matrix products, convolutions, attention). Like XLA's
    cost model with custom calls, it does not see inside the hand-written
    kernels the call launches, nor count elementwise work: a floor on the
    call's operations. bytes: the bytes of the call's tensor inputs and
    outputs (each read or written once), a floor on the memory traffic.
    The call runs once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    byts = sum(t.numel() * t.element_size() for t in _tensors(args) + _tensors(out))
    return float(counter.get_total_flops()), float(byts)


def measure_roofline(fn, args, call_s: float, solves_per_call: int,
                     **peaks) -> Roofline:
    flops, byts = program_costs(fn, *args)
    return Roofline(flops_per_call=flops, bytes_per_call=byts,
                    call_s=call_s, solves_per_call=solves_per_call, **peaks)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def assembly_mac_ratio(G: np.ndarray) -> float:
    """Actual/dense MAC ratio of the reference's packed-H KKT assembly
    (lbmpc_tpu/ops/pallas_ipm.assembly_mac_ratio, numpy, kept here so the
    port's counts equal the reference's): column j contracts nz_p x
    (mD_p - lo128[j]) MACs, the dense rows sorted by their last nonzero
    column and padded to 128, the split-G rows 9 mS."""
    r = analyze_constraint_rows(G)
    mI, nz = np.asarray(G).shape
    nz_p = _round_up(nz, 8)
    mD_p = _round_up(max(r["mD"], 1), 128)
    Gn = np.asarray(G, np.float32)
    maxc = np.asarray([int(np.nonzero(Gn[i])[0][-1]) if np.any(Gn[i]) else 0
                       for i in r["d_rows"]], np.int64)
    lo128 = [int(np.searchsorted(maxc, j)) // 128 * 128 for j in range(nz)]
    dense = 2.0 * mI * nz * nz
    actual = sum(2.0 * nz_p * (mD_p - lo) for lo in lo128) + 9.0 * r["mS"]
    return float(actual / dense)


def fused_sqp_flops_per_solve(N: int, n: int, m: int, q: int, mc: int,
                              ne: int, nz: int, sqp_iters: int,
                              ipm_iters: int, n_merit: int = 6,
                              d_in: int = 3, d_out: int = 4,
                              kkt_mac_ratio: float = 1.0) -> dict:
    """Analytic FLOP count per LBMPC SQP solve, by phase (the reference's
    model, term for term): program_costs cannot see inside the hand-written
    kernels, so the count comes from the algorithm's own shapes
    (controllers/sqp_fused.py + ops/ipm_fused.py), every term naming the
    operation it counts. kkt_mac_ratio scales the KKT formation to the MACs
    an assembly executes (assembly_mac_ratio)."""
    nw_est = q * (2 * d_in + 2 * d_out + 1)          # distances+kernel+sums
    nw_jac = 2 * q * d_out * d_in                    # closed-form Jg
    sens = 2 * n * nz * (n + d_in + 2 * m)           # S propagation matmuls
    jac_scan = N * (nw_est + nw_jac + sens)
    gn_terms = 2 * ne * nz * nz + 2 * ne * nz        # H = 2J'J, g = 2J'e
    kkt_form = kkt_mac_ratio * 2 * mc * nz * nz + mc * nz   # G'DG + scaling
    chol = nz ** 3 // 3 + 4 * nz * nz                # factor + 2 tri-solves
    ipm_vec = 8 * mc * nz                            # residuals/steplen/etc
    ipm = ipm_iters * (kkt_form + chol + ipm_vec)
    rollout = N * (nw_est + 2 * n * (n + m))
    merit = n_merit * (rollout + 2 * mc * nz)
    per_gn = jac_scan + gn_terms + ipm + merit
    total = sqp_iters * per_gn
    return {
        "total": float(total),
        "jac_scan": float(sqp_iters * jac_scan),
        "gn_terms": float(sqp_iters * gn_terms),
        "ipm_kkt_form": float(sqp_iters * ipm_iters * kkt_form),
        "ipm_chol_solve": float(sqp_iters * ipm_iters * chol),
        "ipm_vector": float(sqp_iters * ipm_iters * ipm_vec),
        "merit_ladder": float(sqp_iters * merit),
    }


def fused_sqp_op_split(N: int, n: int, m: int, q: int, mc: int, ne: int,
                       nz: int, sqp_iters: int, ipm_iters: int,
                       n_merit: int = 6, d_in: int = 3,
                       d_out: int = 4, kkt_mac_ratio: float = 1.0) -> dict:
    """Op-class split of fused_sqp_flops_per_solve: "matmul" (contractions:
    the G'DG KKT formation, H = 2J'J, the sensitivity propagation, the NW
    weighted sums, the constraint-stack products) and "elementwise"
    (elementwise chains, reductions, and the sequential Cholesky and
    triangular solves). The reference's "mxu" and "vpu" numbers, under the
    card's names; on the H100 both run on the float32 pipes (TF32 off)."""
    nw_sum = 2 * q * d_out                      # NW weighted sums (matvec)
    nw_elem = q * (2 * d_in + 1)                # distances + kernel weights
    nw_jac = 2 * q * d_out * d_in               # closed-form Jg outer products
    sens = 2 * n * nz * (n + d_in + 2 * m)      # S propagation
    jac_mm = N * (nw_sum + sens)
    jac_el = N * (nw_elem + nw_jac)
    gn_terms = 2 * ne * nz * nz + 2 * ne * nz   # matmul
    kkt_mm = kkt_mac_ratio * 2 * mc * nz * nz   # suffix-restricted G'DG
    kkt_el = mc * nz                            # row scaling
    chol = nz ** 3 // 3 + 4 * nz * nz           # sequential
    ipm_vec = 8 * mc * nz
    roll_mm = N * (nw_sum + 2 * n * (n + m))
    roll_el = N * nw_elem
    merit_mm = n_merit * (roll_mm + 2 * mc * nz)   # viol = z G' (matmul)
    merit_el = n_merit * roll_el
    mm = sqp_iters * (jac_mm + gn_terms + ipm_iters * kkt_mm + merit_mm)
    el = sqp_iters * (jac_el + ipm_iters * (kkt_el + chol + ipm_vec) + merit_el)
    return {"matmul": float(mm), "elementwise": float(el)}
