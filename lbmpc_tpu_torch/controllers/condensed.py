"""Condensed OCP builders: eliminate states, get a dense QP in (c, theta).

The reference formulates its OCPs either as blackbox rollouts inside
fmincon closures (functions/costLMPC.m + constraintsLMPC.m) or as lifted
multiple-shooting NLPs for IPOPT (examples/DMS_LBMPC_casadi.m:122-129). On an
accelerator the right shape is different: for linear (nominal) dynamics the
states are eliminated exactly, leaving a small dense QP over
z = [c_0..c_{N-1}; theta] whose KKT systems are small batched matrices and one
small Cholesky per lane.
The LBMPC/NMPC nonconvexity lives only in the *cost* (learned/true rollout),
so SQP reuses the same constant constraint matrices every iteration.

Semantics are kept step-for-step compatible with the reference (including its
quirks), see the builder docstrings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lbmpc_tpu_torch.sets.terminal import ConstraintSet


@dataclasses.dataclass(frozen=True)
class CondensedQP:
    """Dense QP data: min_z 1/2 z'Hz + (Gg p + g0)'z  s.t.  G z <= h0 + Hp p,
    where p = dx0 is the measured state (delta coordinates)."""

    H: np.ndarray
    Gg: np.ndarray
    g0: np.ndarray
    G: np.ndarray
    h0: np.ndarray
    Hp: np.ndarray
    # prediction operators (for warm starts / diagnostics)
    Sx: np.ndarray  # (N+1, n, n)   x_k = Sx[k] p + Sc[k] C
    Sc: np.ndarray  # (N+1, n, N*m)
    N: int
    n: int
    m: int

    @property
    def nz(self) -> int:
        return self.N * self.m + self.m


def _rollout_operators(A: np.ndarray, Bc: np.ndarray, N: int):
    """Sx[k] = Ak^k, Sc[k][:, j*m:(j+1)*m] = Ak^(k-1-j) Bc for j < k."""
    n, m = Bc.shape
    Sx = np.zeros((N + 1, n, n))
    Sc = np.zeros((N + 1, n, N * m))
    Sx[0] = np.eye(n)
    for k in range(1, N + 1):
        Sx[k] = A @ Sx[k - 1]
        Sc[k] = A @ Sc[k - 1]
        Sc[k][:, (k - 1) * m : k * m] = Bc
    return Sx, Sc


def build_fmincon_lmpc(
    A: np.ndarray,
    B: np.ndarray,
    Ks: np.ndarray,
    Q: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    T: float,
    LAMBDA: np.ndarray,
    PSI: np.ndarray,
    cs: ConstraintSet,
    N: int,
    dx_ref: np.ndarray | None = None,
    terminal_at: str = "last",
    tighten_first_step: bool = False,
) -> CondensedQP:
    """Condense the fmincon-family prestabilized tracking OCP.

    Dynamics u_k = Ks x_k + c_k, x_{k+1} = (A + B Ks) x_k + B c_k
    (ref: functions/transitionNominal.m:12).

    Cost replicates costLMPC.m:25-45 exactly, including its quirks:
    running cost over stages k = 0..N-3 only (`if k < N-1` on the 1-based
    loop), terminal P-cost on x_N, steady-state offset T on (LAMBDA theta - xs).

    Constraints replicate constraintsLMPC.m:20-45 / constraintsLBMPC.m:20-45:
    state rows on x_1..x_{N-1}, input rows on u_0..u_{N-2}; terminal set rows
    on [x_{N-1}; theta] when terminal_at='last' (the MATLAB loop's k==N branch
    reuses the last computed state, i.e. x_{N-1}) or on [x_1; theta] plus the
    tightened F_x_d rows on x_1 when terminal_at='first' (LBMPC variant).
    """
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    Ks = np.atleast_2d(np.asarray(Ks, float))
    LAMBDA = np.atleast_2d(np.asarray(LAMBDA, float))
    PSI = np.atleast_2d(np.asarray(PSI, float))
    n, m = B.shape
    nth = LAMBDA.shape[1]
    nz = N * m + nth
    if dx_ref is None:
        dx_ref = np.zeros(n)
    dx_ref = np.asarray(dx_ref, float)

    Ak = A + B @ Ks
    Sx, Sc = _rollout_operators(Ak, B, N)

    # z layout: [c_0 .. c_{N-1}, theta]
    def zsel_c(k):
        E = np.zeros((m, nz))
        E[:, k * m : (k + 1) * m] = np.eye(m)
        return E

    th_sel = np.zeros((nth, nz))
    th_sel[:, N * m :] = np.eye(nth)

    def x_op(k):
        """x_k = Mx z + Nx p (Mx (n, nz), Nx (n, n))."""
        Mx = np.zeros((n, nz))
        Mx[:, : N * m] = Sc[k]
        return Mx, Sx[k]

    def u_op(k):
        Mx, Nx = x_op(k)
        Mu = Ks @ Mx + zsel_c(k)
        Nu = Ks @ Nx
        return Mu, Nu

    # ---- cost:  J = sum e_i' W_i e_i,  e_i = M_i z + N_i p + r_i ----
    H = np.zeros((nz, nz))
    Gg = np.zeros((nz, n))
    g0 = np.zeros(nz)

    def add_term(M, Np_, r, W):
        nonlocal H, Gg, g0
        H += 2.0 * M.T @ W @ M
        Gg += 2.0 * M.T @ W @ Np_
        g0 += 2.0 * M.T @ W @ r

    for k in range(0, N - 2):  # running: stages 0..N-3 (ref quirk)
        Mx, Nx = x_op(k)
        add_term(Mx - LAMBDA @ th_sel, Nx, np.zeros(n), np.asarray(Q, float))
        Mu, Nu = u_op(k)
        add_term(Mu - PSI @ th_sel, Nu, np.zeros(m), np.asarray(R, float))
    MxN, NxN = x_op(N)
    add_term(MxN - LAMBDA @ th_sel, NxN, np.zeros(n), np.asarray(P, float))
    add_term(LAMBDA @ th_sel, np.zeros((n, n)), -dx_ref, T * np.eye(n))

    # ---- constraints: G z <= h0 + Hp p ----
    G_rows, h0_rows, Hp_rows = [], [], []

    def add_rows(Fmat, M, Np_, h):
        G_rows.append(Fmat @ M)
        h0_rows.append(np.asarray(h, float))
        Hp_rows.append(-Fmat @ Np_)

    for k in range(1, N):  # state rows x_1..x_{N-1}
        Mx, Nx = x_op(k)
        add_rows(cs.F_x, Mx, Nx, cs.h_x)
    for k in range(0, N - 1):  # input rows u_0..u_{N-2}
        Mu, Nu = u_op(k)
        add_rows(cs.F_u, Mu, Nu, cs.h_u)

    Fw_x = cs.F_w_N[:, :n]
    Fw_th = cs.F_w_N[:, n:]
    if terminal_at == "first":
        Mx1, Nx1 = x_op(1)
        if tighten_first_step and cs.F_x_d is not None:
            add_rows(cs.F_x_d, Mx1, Nx1, cs.h_x_d)
        G_rows.append(Fw_x @ Mx1 + Fw_th @ th_sel)
        h0_rows.append(cs.h_w_N)
        Hp_rows.append(-Fw_x @ Nx1)
    else:
        MxT, NxT = x_op(N - 1)  # MATLAB applies the terminal set at x_{N-1}
        G_rows.append(Fw_x @ MxT + Fw_th @ th_sel)
        h0_rows.append(cs.h_w_N)
        Hp_rows.append(-Fw_x @ NxT)

    return CondensedQP(
        H=H, Gg=Gg, g0=g0,
        G=np.vstack(G_rows), h0=np.concatenate(h0_rows), Hp=np.vstack(Hp_rows),
        Sx=Sx, Sc=Sc, N=N, n=n, m=m,
    )
