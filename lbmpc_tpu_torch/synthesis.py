"""OCP matrix factory: stabilizing gains, LQR, DARE, steady-state parametrization.

The port's own copy of the reference's control-synthesis layer
(ref: matlab/LBMPC/functions/matOCP.m). Synthesis runs once at config time, so
it is done in float64 numpy/scipy on host; the resulting small dense matrices
are then copied to the device by the solvers that use them.

Parity targets: the exact Kstabil/Klqr/P/Mtheta dumps in
matlab/LBMPC/examples/DSS_NMPC.m:7-100.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.linalg


def place_poles(A: np.ndarray, B: np.ndarray, poles) -> np.ndarray:
    """Pole-placement gain K with eig(A - B K) = poles.

    Ref: functions/matOCP.m:7-9 (`place`, then Ks = -K so u = Ks x stabilizes).
    For single-input systems the solution is unique (Ackermann); for multi-input
    we delegate to scipy's Kautsky-Nichols-Van Dooren / Tits-Yang.
    """
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    n, m = B.shape
    if m == 1:
        # Ackermann's formula — unique K, matches MATLAB `place` for SISO.
        ctrb = np.hstack([np.linalg.matrix_power(A, i) @ B for i in range(n)])
        coeffs = np.poly(np.asarray(poles, complex))  # desired char. polynomial
        phiA = np.zeros_like(A)
        for c in coeffs:
            phiA = phiA @ A + c * np.eye(n)
        e_last = np.zeros((1, n))
        e_last[0, -1] = 1.0
        K = e_last @ np.linalg.solve(ctrb, phiA)
        return np.real(K)
    import scipy.signal

    res = scipy.signal.place_poles(A, B, np.asarray(poles))
    return res.gain_matrix


def dare(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Discrete algebraic Riccati equation solution X (MATLAB `dare` convention).

    Ref: functions/matOCP.m:30 — terminal cost P = dare(A + B*Ks, B, Q, R).
    """
    return scipy.linalg.solve_discrete_are(
        np.asarray(A, float), np.asarray(B, float), np.asarray(Q, float), np.asarray(R, float)
    )


def dlqr(A: np.ndarray, B: np.ndarray, Q: np.ndarray, R: np.ndarray) -> np.ndarray:
    """LQR gain K with u = -K x optimal (MATLAB `dlqr` convention).

    Ref: functions/matOCP.m:28 (Klqr = -dlqr(A,B,Q,R)) and
    functions/getCONSPOLY.m:39 (terminal feedback K_t = -dlqr(A,B,Q,10R)).
    """
    X = dare(A, B, Q, R)
    return np.linalg.solve(B.T @ X @ B + np.asarray(R, float), B.T @ X @ A)


def steady_state_parametrization(
    A: np.ndarray, B: np.ndarray, C: np.ndarray, d0: np.ndarray | None = None
):
    """Null-space parametrization of trackable steady states.

    M = [[A - I, B, 0], [C, 0, -I]]; Mtheta = null(M) (orthonormal);
    LAMBDA = Mtheta[:n], PSI = Mtheta[n:n+m]; affine offsets from the
    least-squares solution of M z = [-d0; 0].
    Ref: functions/matOCP.m:12-23.

    Returns (Mtheta, LAMBDA, PSI, LAMBDA_0, PSI_0).
    """
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    C = np.asarray(C, float)
    n, m = B.shape
    o = C.shape[0]
    M = np.block(
        [
            [A - np.eye(n), B, np.zeros((n, o))],
            [C, np.zeros((o, m)), -np.eye(o)],
        ]
    )
    Mtheta = scipy.linalg.null_space(M)
    # Canonical sign: make the PSI block's first entry non-negative per column
    # (the controller is invariant to the sign of Mtheta — theta absorbs it —
    # but a fixed convention keeps parity tests and warm starts deterministic).
    for j in range(Mtheta.shape[1]):
        lead = Mtheta[n : n + m, j]
        s = np.sign(lead[np.argmax(np.abs(lead))]) if np.any(lead) else 1.0
        if s < 0:
            Mtheta[:, j] *= -1.0
    LAMBDA = Mtheta[:n, :]
    PSI = Mtheta[n : n + m, :]
    if d0 is None:
        d0 = np.zeros(n)
    rhs = np.concatenate([-np.asarray(d0, float), np.zeros(o)])
    M0, *_ = np.linalg.lstsq(M, rhs, rcond=None)
    LAMBDA_0 = M0[:n]
    PSI_0 = M0[n : n + m]
    return Mtheta, LAMBDA, PSI, LAMBDA_0, PSI_0


@dataclasses.dataclass(frozen=True)
class OCPMatrices:
    """Everything functions/matOCP.m returns, as float64 numpy arrays."""

    Ks: np.ndarray        # prestabilizing feedback (u = Ks x + c)
    Klqr: np.ndarray      # LQR gain (u = Klqr x)
    Q: np.ndarray
    R: np.ndarray
    P: np.ndarray         # terminal cost
    T: float              # steady-state offset weight
    Mtheta: np.ndarray
    LAMBDA: np.ndarray
    PSI: np.ndarray
    LAMBDA_0: np.ndarray
    PSI_0: np.ndarray


def mat_ocp(
    A: np.ndarray,
    B: np.ndarray,
    C: np.ndarray,
    poles=(0.75, 0.78, 0.98, 0.99),
    Q: np.ndarray | None = None,
    R: np.ndarray | None = None,
    T: float = 1000.0,
) -> OCPMatrices:
    """Reference matOCP pipeline (ref: functions/matOCP.m:1-32)."""
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    C = np.asarray(C, float)
    n, m = B.shape
    if Q is None:
        Q = np.eye(n)
    if R is None:
        R = np.eye(m)
    Ks = -place_poles(A, B, poles)
    Mtheta, LAMBDA, PSI, LAMBDA_0, PSI_0 = steady_state_parametrization(A, B, C)
    Klqr = -dlqr(A, B, Q, R)
    P = dare(A + B @ Ks, B, Q, R)
    return OCPMatrices(
        Ks=Ks, Klqr=Klqr, Q=Q, R=R, P=P, T=T,
        Mtheta=Mtheta, LAMBDA=LAMBDA, PSI=PSI, LAMBDA_0=LAMBDA_0, PSI_0=PSI_0,
    )
