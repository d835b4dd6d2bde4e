"""Constraint-polytope factories for the MGCM OCP (getCONS / getCONSPOLY).

Produces the H-rep constraint stacks the controllers consume:
  - state / input boxes shifted to the working point
    (ref: functions/getCONS.m:15-16)
  - the extended-state [x; theta] terminal invariant set, either the MPIS
    fixpoint variant (ref: getCONS.m commented block + cached term_set.mat)
    or the robust pdiff variant (ref: getCONSPOLY.m:40-69)
  - the tightened one-step state set X ⊖ D (ref: getCONSPOLY.m:28-30)

Artifacts are cached on disk exactly like the reference caches term_set.mat
(ref: getCONS.m:56-58), keyed by a hash of the inputs.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pathlib

import numpy as np

from lbmpc_tpu_torch.sets.invariant import compute_mpis
from lbmpc_tpu_torch.sets.polytope import Polytope
from lbmpc_tpu_torch.synthesis import dlqr

CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / ".cache" / "sets"


@dataclasses.dataclass(frozen=True)
class ConstraintSet:
    """All constraint polytopes a controller needs, dense and device-ready."""

    F_x: np.ndarray
    h_x: np.ndarray
    F_u: np.ndarray
    h_u: np.ndarray
    F_w_N: np.ndarray   # terminal set rows over [x; theta]
    h_w_N: np.ndarray
    F_x_d: np.ndarray | None = None  # tightened one-step state set (robust variant)
    h_x_d: np.ndarray | None = None


def _boxes(x_min, x_max, u_min, u_max, x_wp, u_wp):
    """Working-point-shifted box H-reps (ref: getCONS.m:15-16)."""
    x_min = np.asarray(x_min, float)
    x_max = np.asarray(x_max, float)
    x_wp = np.asarray(x_wp, float)
    n = x_wp.size
    u_min = np.atleast_1d(np.asarray(u_min, float))
    u_max = np.atleast_1d(np.asarray(u_max, float))
    u_wp = np.atleast_1d(np.asarray(u_wp, float))
    m = u_wp.size
    F_x = np.vstack([np.eye(n), -np.eye(n)])
    h_x = np.concatenate([x_max - x_wp, -(x_min - x_wp)])
    F_u = np.vstack([np.eye(m), -np.eye(m)])
    h_u = np.concatenate([u_max - u_wp, -(u_min - u_wp)])
    return F_x, h_x, F_u, h_u


def _extended_stack(F_x, h_x, F_u, h_u, K, LAMBDA, PSI, LAMBDA_0, PSI_0, lam):
    """Extended-state [x; theta] constraint stack (ref: getCONS.m:33-44,
    getCONSPOLY.m:44-55 minus its extra tightened block)."""
    n = F_x.shape[1]
    m = F_u.shape[1]
    L = PSI - K @ LAMBDA
    L0 = PSI_0 - K @ LAMBDA_0
    F_w = np.vstack(
        [
            np.hstack([F_x, np.zeros((F_x.shape[0], LAMBDA.shape[1]))]),
            np.hstack([np.zeros((F_x.shape[0], n)), F_x @ LAMBDA]),
            np.hstack([F_u @ K, F_u @ L]),
            np.hstack([np.zeros((F_u.shape[0], n)), F_u @ PSI]),
        ]
    )
    h_w = np.concatenate(
        [
            h_x,
            lam * (h_x - F_x @ LAMBDA_0),
            h_u - F_u @ L0,
            lam * (h_u - F_u @ PSI_0),
        ]
    )
    return F_w, h_w


def _cache_key(*arrays) -> str:
    hsh = hashlib.sha256()
    for a in arrays:
        hsh.update(np.ascontiguousarray(np.asarray(a, float)).tobytes())
    return hsh.hexdigest()[:16]


def get_cons(
    x_min, x_max, u_min, u_max, x_wp, u_wp,
    A, B, K, LAMBDA, PSI, LAMBDA_0, PSI_0,
    lam: float = 0.99,
    cache: bool = True,
) -> ConstraintSet:
    """MPIS-based constraint factory (ref: functions/getCONS.m).

    The terminal set is the maximal positively invariant set of the extended
    autonomous system w+ = [A+BK, B(PSI - K LAMBDA); 0, I] w inside the
    lambda-contracted extended constraint set, minimal H-rep, rhs normalized
    to 1 — regenerating what the reference loads from term_set.mat.
    """
    F_x, h_x, F_u, h_u = _boxes(x_min, x_max, u_min, u_max, x_wp, u_wp)
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    K = np.atleast_2d(np.asarray(K, float))
    LAMBDA = np.atleast_2d(np.asarray(LAMBDA, float))
    PSI = np.atleast_2d(np.asarray(PSI, float))
    LAMBDA_0 = np.asarray(LAMBDA_0, float).reshape(LAMBDA.shape[0])
    PSI_0 = np.asarray(PSI_0, float).reshape(PSI.shape[0])
    n, m = B.shape

    key = _cache_key(F_x, h_x, F_u, h_u, A, B, K, LAMBDA, PSI, LAMBDA_0, PSI_0, [lam])
    cache_file = CACHE_DIR / f"mpis_{key}.npz"
    if cache and cache_file.exists():
        d = np.load(cache_file)
        return ConstraintSet(F_x, h_x, F_u, h_u, d["F"], d["h"])

    F_w, h_w = _extended_stack(F_x, h_x, F_u, h_u, K, LAMBDA, PSI, LAMBDA_0, PSI_0, lam)
    L = PSI - K @ LAMBDA
    Aw = np.block(
        [[A + B @ K, B @ L], [np.zeros((LAMBDA.shape[1], n)), np.eye(LAMBDA.shape[1])]]
    )
    mpis = compute_mpis(Polytope(F_w, h_w), Aw).min_hrep()
    if cache:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        np.savez(cache_file, F=mpis.F, h=mpis.h)
    return ConstraintSet(F_x, h_x, F_u, h_u, mpis.F, mpis.h)


def get_cons_poly(
    x_min, x_max, u_min, u_max, state_uncert, x_wp, u_wp,
    A, B, Q, R, LAMBDA, PSI, LAMBDA_0, PSI_0,
    lam: float = 0.99,
    maxadm_controlweight: float = 10.0,
) -> ConstraintSet:
    """Robust (pdiff) constraint factory (ref: functions/getCONSPOLY.m).

    Steps: tightened state set X ⊖ D; terminal feedback K_t = -dlqr(A,B,Q,10R);
    extended constraint stack with an extra one-step-robust block; Pontryagin
    difference against the extended disturbance polytope; minimal H-rep.
    """
    F_x, h_x, F_u, h_u = _boxes(x_min, x_max, u_min, u_max, x_wp, u_wp)
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    LAMBDA = np.atleast_2d(np.asarray(LAMBDA, float))
    PSI = np.atleast_2d(np.asarray(PSI, float))
    LAMBDA_0 = np.asarray(LAMBDA_0, float).reshape(LAMBDA.shape[0])
    PSI_0 = np.asarray(PSI_0, float).reshape(PSI.shape[0])
    n, m = B.shape
    th = LAMBDA.shape[1]

    # uncertainty polytope D (ref: getCONSPOLY.m:19)
    su = np.asarray(state_uncert, float).ravel()
    F_d = np.vstack([np.eye(n), -np.eye(n)])
    h_d = np.concatenate([su, su])

    # X ⊖ D, minimal (ref: getCONSPOLY.m:28-30). Zero-uncertainty coordinates
    # make D lower-dimensional; the Kolmanovsky-Gilbert support-function form
    # of the difference handles that without MPT's special-casing.
    tight = Polytope(F_x, h_x).pontryagin_diff(Polytope(F_d, h_d)).min_hrep()
    F_x_d, h_x_d = tight.F, tight.h

    K_t = -dlqr(A, B, np.asarray(Q, float), maxadm_controlweight * np.asarray(R, float))
    L = PSI - K_t @ LAMBDA
    L0 = PSI_0 - K_t @ LAMBDA_0
    F_w, h_w = _extended_stack(F_x, h_x, F_u, h_u, K_t, LAMBDA, PSI, LAMBDA_0, PSI_0, lam)
    # extra one-step-robust block (ref: getCONSPOLY.m:49,55)
    F_w = np.vstack([F_w, np.hstack([F_x_d @ (A + B @ K_t), F_x_d @ B @ L])])
    h_w = np.concatenate([h_w, h_x_d - F_x_d @ B @ (PSI_0 - K_t @ LAMBDA_0)])

    # extended disturbance polytope: D x {0} (ref: getCONSPOLY.m:58-63)
    F_d_w = np.vstack(
        [
            np.hstack([F_d, np.zeros((F_d.shape[0], th))]),
            np.hstack([np.zeros((th, n)), np.eye(th)]),
            np.hstack([np.zeros((th, n)), -np.eye(th)]),
        ]
    )
    h_d_w = np.concatenate([h_d, np.zeros(2 * th)])

    term = (
        Polytope(F_w, h_w)
        .pontryagin_diff(Polytope(F_d_w, h_d_w))
        .min_hrep()
    )
    return ConstraintSet(F_x, h_x, F_u, h_u, term.F, term.h, F_x_d, h_x_d)


def get_cons_robust_ks(
    x_min, x_max, u_min, u_max, state_uncert, x_wp, u_wp,
    A, B, Ks, LAMBDA, PSI, LAMBDA_0, PSI_0,
    lam: float = 0.99,
    eps: float = 1e-4,
    cache: bool = True,
) -> ConstraintSet:
    """Ks-consistent tube constraint factory (ROADMAP robustness item 10).

    The reference's robust factory (getCONSPOLY.m:38-69) builds its terminal
    machinery around K_t = -dlqr(A, B, Q, 10R) while the rollouts apply the
    pole-placement prestabilizer Ks; on the 2-state Moore-Greitzer reduction
    that mismatch leaves the "robust" terminal set non-contractive and the
    closed loop limit-cycles (see config.py MG2 note). This factory is the
    standard disturbance-invariant-tube construction (Mayne/Langson), built
    around the SAME Ks the controller actually applies:

      E      = mRPIS of e+ = (A + B Ks) e + w,  w in D (calc_mRPIS.m math);
      X_tube = X ⊖ E,  U_tube = U ⊖ Ks E   (support-function tightening);
      F_w_N  = MPIS of the extended autonomous system w+ = [A+B Ks, B(PSI -
               Ks LAMBDA); 0, I] w inside the lam-contracted TIGHTENED stack.

    The returned F_x/h_x, F_u/h_u are the TIGHTENED sets (tube semantics: the
    nominal rollout satisfies them; the true state stays in X because every
    realization lives in nominal ⊕ E). F_x_d/h_x_d mirror the tightened state
    set for builders that use the one-step-tightening hook.
    """
    F_x, h_x, F_u, h_u = _boxes(x_min, x_max, u_min, u_max, x_wp, u_wp)
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    Ks = np.atleast_2d(np.asarray(Ks, float))
    LAMBDA = np.atleast_2d(np.asarray(LAMBDA, float))
    PSI = np.atleast_2d(np.asarray(PSI, float))
    LAMBDA_0 = np.asarray(LAMBDA_0, float).reshape(LAMBDA.shape[0])
    PSI_0 = np.asarray(PSI_0, float).reshape(PSI.shape[0])
    n, m = B.shape

    su = np.asarray(state_uncert, float).ravel()
    F_d = np.vstack([np.eye(n), -np.eye(n)])
    h_d = np.concatenate([su, su])

    key = _cache_key(F_x, h_x, F_u, h_u, A, B, Ks, LAMBDA, PSI, LAMBDA_0,
                     PSI_0, su, [lam, eps])
    cache_file = CACHE_DIR / f"tube_{key}.npz"
    if cache and cache_file.exists():
        d = np.load(cache_file)
        return ConstraintSet(F_x, d["h_x_t"], F_u, d["h_u_t"], d["F"], d["h"],
                             F_x_d=F_x, h_x_d=d["h_x_t"])

    from lbmpc_tpu_torch.sets.invariant import calc_mrpis

    Ak = A + B @ Ks
    E = calc_mrpis(Ak, F_d, h_d, eps).min_hrep()
    # support-function tightening: h_i - h_E(f_i) (state), h_i - h_E(Ks' f_i)
    h_x_t = h_x - np.array([E.support(F_x[i]) for i in range(len(h_x))])
    h_u_t = h_u - np.array([E.support(Ks.T @ F_u[i]) for i in range(len(h_u))])
    if (h_x_t <= 0).any() or (h_u_t <= 0).any():
        raise ValueError(
            "tube cross-section exhausts the state/input budget: "
            f"min state margin {h_x_t.min():.3g}, input {h_u_t.min():.3g}")

    F_w, h_w = _extended_stack(F_x, h_x_t, F_u, h_u_t, Ks, LAMBDA, PSI,
                               LAMBDA_0, PSI_0, lam)
    L = PSI - Ks @ LAMBDA
    Aw = np.block([[Ak, B @ L],
                   [np.zeros((LAMBDA.shape[1], n)), np.eye(LAMBDA.shape[1])]])
    mpis = compute_mpis(Polytope(F_w, h_w), Aw).min_hrep()
    if cache:
        CACHE_DIR.mkdir(parents=True, exist_ok=True)
        np.savez(cache_file, F=mpis.F, h=mpis.h, h_x_t=h_x_t, h_u_t=h_u_t)
    return ConstraintSet(F_x, h_x_t, F_u, h_u_t, mpis.F, mpis.h,
                         F_x_d=F_x, h_x_d=h_x_t)
