"""H-representation polytope toolkit (offline, float64 numpy/scipy).

A from-scratch replacement for the reference's MPT3 + `linprog` layer
(ref: functions/getCONS.m, getCONSPOLY.m, utilities/pdiff.m). Set *synthesis*
runs once at config time on host (like the reference caches `term_set.mat`,
functions/getCONS.m:56-58); set *application* (F x <= h checks, tightening) is
plain batched linear algebra on device.

Everything here is dense (rows, n) arrays — no object graph, so the computed
sets drop straight into the condensed constraint stacks.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import scipy.optimize
import scipy.spatial


def _use_native() -> bool:
    if os.environ.get("LBMPC_TPU_NO_NATIVE"):
        return False
    from lbmpc_tpu_torch.sets import native

    return native.available()


def _linprog_max(c: np.ndarray, F: np.ndarray, h: np.ndarray) -> float:
    """max c'x s.t. Fx <= h (support function). Raises on failure.

    Uses the native C++ IPM (native/polylp.cpp) when available — the compiled
    replacement for MATLAB linprog / MPT3's LP core — with scipy HiGHS as the
    pure-Python fallback and cross-check.
    """
    if _use_native():
        from lbmpc_tpu_torch.sets import native

        return native.support(np.asarray(c, float), F, h)
    res = scipy.optimize.linprog(-c, A_ub=F, b_ub=h, bounds=(None, None), method="highs")
    if res.status == 3:
        return np.inf
    if not res.success:
        raise RuntimeError(f"LP failed: {res.message}")
    return -res.fun


@dataclasses.dataclass
class Polytope:
    """{x : F x <= h}. F (k, n), h (k,)."""

    F: np.ndarray
    h: np.ndarray

    def __post_init__(self):
        self.F = np.atleast_2d(np.asarray(self.F, float))
        self.h = np.asarray(self.h, float).ravel()
        assert self.F.shape[0] == self.h.shape[0]

    @property
    def dim(self) -> int:
        return self.F.shape[1]

    @property
    def nrows(self) -> int:
        return self.F.shape[0]

    # ---------------- basic ops ----------------

    def normalize(self) -> "Polytope":
        """Scale rows so h = 1 (requires h > 0; ref: compute_MPIS.m:7)."""
        if np.any(self.h <= 0):
            raise ValueError("normalize() needs h > 0 (origin strictly inside)")
        return Polytope(self.F / self.h[:, None], np.ones(self.nrows))

    def intersect(self, other: "Polytope") -> "Polytope":
        return Polytope(np.vstack([self.F, other.F]), np.concatenate([self.h, other.h]))

    def support(self, c: np.ndarray) -> float:
        return _linprog_max(np.asarray(c, float), self.F, self.h)

    def contains(self, x: np.ndarray, tol: float = 1e-9) -> bool:
        return bool(np.all(self.F @ np.asarray(x, float) <= self.h + tol))

    def chebyshev_center(self) -> tuple[np.ndarray, float]:
        """Largest inscribed ball (center, radius) via one LP."""
        norms = np.linalg.norm(self.F, axis=1)
        n = self.dim
        c = np.zeros(n + 1)
        c[-1] = -1.0
        A = np.hstack([self.F, norms[:, None]])
        res = scipy.optimize.linprog(c, A_ub=A, b_ub=self.h, bounds=(None, None), method="highs")
        if not res.success:
            raise RuntimeError(f"Chebyshev LP failed: {res.message}")
        return res.x[:n], res.x[n]

    # ---------------- redundancy / equality ----------------

    def min_hrep(self, tol: float = 1e-9) -> "Polytope":
        """Remove redundant rows (MPT minHRep equivalent).

        Row i is redundant iff max F_i x over the polytope without row i
        (rhs relaxed) still satisfies F_i x <= h_i.
        """
        F, h = self.F.copy(), self.h.copy()
        # quick dedup of (nearly) identical rows after normalization by row norm
        norms = np.linalg.norm(F, axis=1)
        keepmask = norms > tol
        F, h = F[keepmask], h[keepmask]
        norms = norms[keepmask]
        Fn = F / norms[:, None]
        hn = h / norms
        order = np.lexsort(np.round(np.column_stack([Fn, hn]), 9).T)
        uniq = np.ones(len(hn), bool)
        prev = None
        for idx in order:
            row = (tuple(np.round(Fn[idx], 9)), round(float(hn[idx]), 9))
            if row == prev:
                uniq[idx] = False
            prev = row
        F, h = Fn[uniq], hn[uniq]

        if _use_native():
            from lbmpc_tpu_torch.sets import native

            keep = native.min_hrep_mask(F, h, tol)
            return Polytope(F[keep], h[keep])

        keep = np.ones(F.shape[0], bool)
        for i in range(F.shape[0]):
            if not keep[i]:
                continue
            mask = keep.copy()
            mask[i] = False
            if not mask.any():
                continue
            val = _linprog_max(F[i], F[mask], h[mask])
            if val <= h[i] + tol:
                keep[i] = False
        return Polytope(F[keep], h[keep])

    def is_subset(self, other: "Polytope", tol: float = 1e-7) -> bool:
        """self ⊆ other iff every face of `other` is satisfied at self's support."""
        for i in range(other.nrows):
            if _linprog_max(other.F[i], self.F, self.h) > other.h[i] + tol:
                return False
        return True

    def set_equals(self, other: "Polytope", tol: float = 1e-7) -> bool:
        return self.is_subset(other, tol) and other.is_subset(self, tol)

    def is_empty(self) -> bool:
        res = scipy.optimize.linprog(
            np.zeros(self.dim), A_ub=self.F, b_ub=self.h, bounds=(None, None), method="highs"
        )
        return res.status == 2

    # ---------------- geometric ops ----------------

    def pontryagin_diff(self, other: "Polytope") -> "Polytope":
        """self ⊖ other: h_i -> h_i - h_other(F_i) (Kolmanovsky-Gilbert).

        Ref: utilities/pdiff.m:5-17 — one support LP per constraint row.
        """
        shrink = np.array([other.support(f) for f in self.F])
        return Polytope(self.F, self.h - shrink)

    def vertices(self) -> np.ndarray:
        """Vertex enumeration: native basic-solution core (native/polylp.cpp
        polylp_vertices) with scipy HalfspaceIntersection (qhull) fallback for
        instances past the native combination budget."""
        if _use_native():
            from lbmpc_tpu_torch.sets import native

            V = native.vertices(self.F, self.h)
            if V is not None:
                if V.shape[0] == 0:
                    raise ValueError("polytope has no vertices (empty or unbounded)")
                return np.unique(np.round(V, 9), axis=0)
        c, r = self.chebyshev_center()
        if r <= 1e-12:
            raise ValueError("polytope has empty interior; cannot enumerate vertices")
        halfspaces = np.hstack([self.F, -self.h[:, None]])
        hs = scipy.spatial.HalfspaceIntersection(halfspaces, c)
        V = hs.intersections
        # dedup
        V = np.unique(np.round(V, 9), axis=0)
        return V

    def linear_map(self, A: np.ndarray) -> "Polytope":
        """Image {A x : x in self} for invertible A: F A^-1 x <= h."""
        Ai = np.linalg.inv(np.asarray(A, float))
        return Polytope(self.F @ Ai, self.h)

    def scale(self, alpha: float) -> "Polytope":
        return Polytope(self.F, alpha * self.h)

    def minkowski_sum(self, other: "Polytope") -> "Polytope":
        """V-rep Minkowski sum + convex hull back to H-rep (ref: reach_set.m:5-11)."""
        V1 = self.vertices()
        V2 = other.vertices()
        pts = (V1[:, None, :] + V2[None, :, :]).reshape(-1, self.dim)
        return from_vertices(pts)

    def project(self, dims) -> "Polytope":
        """Orthogonal projection onto coordinates `dims` via Fourier-Motzkin.

        Ref: MPT `projection` used by trackingMPC/ROA.m:24. Redundancy is
        pruned after each eliminated variable to contain row blowup.
        """
        dims = list(dims)
        n = self.dim
        elim = [i for i in range(n) if i not in dims]
        F, h = self.F.copy(), self.h.copy()
        cols = list(range(n))
        for e in elim:
            j = cols.index(e)
            F, h = _fourier_motzkin_step(F, h, j)
            cols.pop(j)
            p = Polytope(F, h).min_hrep()
            F, h = p.F, p.h
        # reorder columns to `dims` order
        perm = [cols.index(d) for d in dims]
        return Polytope(F[:, perm], h)


def _fourier_motzkin_step(F: np.ndarray, h: np.ndarray, j: int):
    """Eliminate column j from F x <= h."""
    col = F[:, j]
    pos = col > 1e-12
    neg = col < -1e-12
    zero = ~(pos | neg)
    keepF = np.delete(F[zero], j, axis=1)
    keeph = h[zero]
    rows = [keepF]
    rhs = [keeph]
    Fp, hp = F[pos], h[pos]
    Fn, hn = F[neg], h[neg]
    cp, cn = col[pos], col[neg]
    if len(hp) and len(hn):
        # pairwise combine: (1/cp_i) row_i + (-1/cn_k) row_k
        Fp_s = Fp / cp[:, None]
        hp_s = hp / cp
        Fn_s = Fn / (-cn[:, None])
        hn_s = hn / (-cn)
        comb_F = (Fp_s[:, None, :] + Fn_s[None, :, :]).reshape(-1, F.shape[1])
        comb_h = (hp_s[:, None] + hn_s[None, :]).reshape(-1)
        rows.append(np.delete(comb_F, j, axis=1))
        rhs.append(comb_h)
    Fo = np.vstack(rows) if rows else np.zeros((0, F.shape[1] - 1))
    ho = np.concatenate(rhs) if rhs else np.zeros(0)
    return Fo, ho


def from_vertices(pts: np.ndarray) -> Polytope:
    """Convex hull of points -> H-rep polytope.

    Native path: polar duality. With the centroid c strictly inside the
    (full-dimensional) hull, the dual polytope {y : (p_i - c)'y <= 1} is
    bounded, and each of its vertices v is one facet v'(x - c) <= 1 of
    conv(pts) — so facet enumeration reuses the native vertex enumerator.
    Degenerate (rank-deficient) hulls fall back to qhull.
    """
    pts = np.asarray(pts, float)
    P = _from_vertices_dual(pts) if _use_native() else None
    if P is not None:
        return P
    hull = scipy.spatial.ConvexHull(pts, qhull_options="QJ" if pts.shape[1] > 3 else None)
    # hull.equations: [normal, offset] with normal . x + offset <= 0
    F = hull.equations[:, :-1]
    h = -hull.equations[:, -1]
    return Polytope(F, h).min_hrep()


def _from_vertices_dual(pts: np.ndarray) -> Polytope | None:
    from lbmpc_tpu_torch.sets import native

    c = pts.mean(axis=0)
    Q = pts - c
    n = pts.shape[1]
    scale = np.abs(Q).max()
    if scale <= 0 or np.linalg.matrix_rank(Q, tol=1e-9 * scale) < n:
        return None  # flat hull: polar dual unbounded
    V = native.vertices(Q, np.ones(Q.shape[0]))
    if V is None or V.shape[0] < n + 1:
        return None
    return Polytope(V, 1.0 + V @ c).min_hrep()


def box(lo: np.ndarray, hi: np.ndarray) -> Polytope:
    """Axis-aligned box {lo <= x <= hi} as [I; -I] H-rep (ref: getCONS.m:15-16)."""
    lo = np.asarray(lo, float).ravel()
    hi = np.asarray(hi, float).ravel()
    n = lo.size
    return Polytope(np.vstack([np.eye(n), -np.eye(n)]), np.concatenate([hi, -lo]))
