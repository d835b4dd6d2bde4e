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


class _Stacks:
    """The condensed QP, term by term: cost terms e' W e with
    e = M z + Np p + r, and constraint rows F (M z + Np p) <= h."""

    def __init__(self, nz: int, n: int):
        self.H = np.zeros((nz, nz))
        self.Gg = np.zeros((nz, n))
        self.g0 = np.zeros(nz)
        self.G, self.h0, self.Hp = [], [], []

    def term(self, M, Np_, r, W):
        self.H += 2.0 * M.T @ W @ M
        self.Gg += 2.0 * M.T @ W @ Np_
        self.g0 += 2.0 * M.T @ W @ r

    def rows(self, F, M, Np_, h):
        self.G.append(F @ M)
        self.h0.append(np.asarray(h, float))
        self.Hp.append(-F @ Np_)

    def terminal(self, cs: ConstraintSet, M, Np_, th_sel):
        """The terminal set's rows F_w_N [x; theta] <= h_w_N, x = M z + Np p."""
        n = M.shape[0]
        Fw_x, Fw_th = cs.F_w_N[:, :n], cs.F_w_N[:, n:]
        self.G.append(Fw_x @ M + Fw_th @ th_sel)
        self.h0.append(cs.h_w_N)
        self.Hp.append(-Fw_x @ Np_)

    def qp(self, Sx, Sc, N: int, n: int, m: int) -> CondensedQP:
        return CondensedQP(
            H=self.H, Gg=self.Gg, g0=self.g0, G=np.vstack(self.G),
            h0=np.concatenate(self.h0), Hp=np.vstack(self.Hp),
            Sx=Sx, Sc=Sc, N=N, n=n, m=m,
        )


def _operators(Sx, Sc, N: int, m: int, nth: int, Ks=None):
    """For z = [c_0 .. c_{N-1}; theta]: theta's selector (nth, nz), and
    x_op(k), u_op(k) -> (M, Np) with x_k = M z + Np p. The input is
    u_k = Ks x_k + c_k (prestabilized) when Ks is given, else u_k = c_k."""
    n = Sx.shape[1]
    nz = N * m + nth
    th_sel = np.zeros((nth, nz))
    th_sel[:, N * m :] = np.eye(nth)

    def x_op(k):
        Mx = np.zeros((n, nz))
        Mx[:, : N * m] = Sc[k]
        return Mx, Sx[k]

    def u_op(k):
        E = np.zeros((m, nz))
        E[:, k * m : (k + 1) * m] = np.eye(m)
        if Ks is None:
            return E, np.zeros((m, n))
        Mx, Nx = x_op(k)
        return Ks @ Mx + E, Ks @ Nx

    return th_sel, x_op, u_op


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
    if dx_ref is None:
        dx_ref = np.zeros(n)
    dx_ref = np.asarray(dx_ref, float)

    Sx, Sc = _rollout_operators(A + B @ Ks, B, N)
    th_sel, x_op, u_op = _operators(Sx, Sc, N, m, nth, Ks)
    st = _Stacks(N * m + nth, n)

    for k in range(0, N - 2):  # running: stages 0..N-3 (ref quirk)
        Mx, Nx = x_op(k)
        st.term(Mx - LAMBDA @ th_sel, Nx, np.zeros(n), np.asarray(Q, float))
        Mu, Nu = u_op(k)
        st.term(Mu - PSI @ th_sel, Nu, np.zeros(m), np.asarray(R, float))
    MxN, NxN = x_op(N)
    st.term(MxN - LAMBDA @ th_sel, NxN, np.zeros(n), np.asarray(P, float))
    st.term(LAMBDA @ th_sel, np.zeros((n, n)), -dx_ref, T * np.eye(n))

    for k in range(1, N):  # state rows x_1..x_{N-1}
        st.rows(cs.F_x, *x_op(k), cs.h_x)
    for k in range(0, N - 1):  # input rows u_0..u_{N-2}
        st.rows(cs.F_u, *u_op(k), cs.h_u)
    if terminal_at == "first":
        Mx1, Nx1 = x_op(1)
        if tighten_first_step and cs.F_x_d is not None:
            st.rows(cs.F_x_d, Mx1, Nx1, cs.h_x_d)
        st.terminal(cs, Mx1, Nx1, th_sel)
    else:
        st.terminal(cs, *x_op(N - 1), th_sel)  # MATLAB applies it at x_{N-1}
    return st.qp(Sx, Sc, N, n, m)


def _casadi_qp(A, B, Ks, Q, R, P, T, LAMBDA, PSI, cs, N, delta, k_terminal,
               tighten) -> CondensedQP:
    """The casadi family's stacks (DMS_LBMPC_casadi.m costfunction :252-268,
    nonlinearconstraints :282-315): delta-scaled running cost on stages
    0..N-1, terminal P on x_N and T on LAMBDA theta; state rows on x_1..x_N,
    input rows on u_0..u_{N-1}, then the tightened F_x_d rows (if `tighten`)
    and the terminal set on x_{k_terminal}. Prestabilized rollout when Ks
    is given, direct input otherwise."""
    A = np.asarray(A, float)
    B = np.asarray(B, float)
    LAMBDA = np.atleast_2d(np.asarray(LAMBDA, float))
    PSI = np.atleast_2d(np.asarray(PSI, float))
    n, m = B.shape
    nth = LAMBDA.shape[1]
    if Ks is not None:
        Ks = np.atleast_2d(np.asarray(Ks, float))
        A = A + B @ Ks
    Sx, Sc = _rollout_operators(A, B, N)
    th_sel, x_op, u_op = _operators(Sx, Sc, N, m, nth, Ks)
    st = _Stacks(N * m + nth, n)

    for k in range(0, N):
        Mx, Nx = x_op(k)
        st.term(Mx - LAMBDA @ th_sel, Nx, np.zeros(n), delta * np.asarray(Q, float))
        Mu, Nu = u_op(k)
        st.term(Mu - PSI @ th_sel, Nu, np.zeros(m), delta * np.asarray(R, float))
    MxN, NxN = x_op(N)
    st.term(MxN - LAMBDA @ th_sel, NxN, np.zeros(n), np.asarray(P, float))
    st.term(LAMBDA @ th_sel, np.zeros((n, n)), np.zeros(n), T * np.eye(n))

    for k in range(1, N + 1):  # state rows x_1..x_N
        st.rows(cs.F_x, *x_op(k), cs.h_x)
    for k in range(0, N):  # input rows u_0..u_{N-1}
        st.rows(cs.F_u, *u_op(k), cs.h_u)
    MxT, NxT = x_op(k_terminal)
    if tighten and cs.F_x_d is not None:
        st.rows(cs.F_x_d, MxT, NxT, cs.h_x_d)
    st.terminal(cs, MxT, NxT, th_sel)
    return st.qp(Sx, Sc, N, n, m)


def build_casadi_dms_k(
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
    delta: float,
) -> CondensedQP:
    """Condense the CasADi-family tracking OCP with the EXPLICIT
    prestabilization split u = Ks x + c (ref: DMS_tracking_LMPC_casadi_K.m
    :110-136 — decision y = [x; c; u; theta] with the equality
    u_k = c_k + K (x_k - x_eq) at :293, eliminated exactly here).

    After elimination the rollout is the prestabilized x_{k+1} =
    (A + B Ks) x_k + B c_k with z = [c; theta], while cost and constraint
    stage sets keep the casadi-family indexing (delta-scaled running cost on
    ALL N stages, state rows x_1..x_N, input rows u_0..u_{N-1}, terminal
    F_wN at x_N — :246-304) — i.e. the fmincon-family ROLLOUT with the
    casadi-family STACKS."""
    return _casadi_qp(A, B, Ks, Q, R, P, T, LAMBDA, PSI, cs, N, delta,
                      k_terminal=N, tighten=False)


def build_casadi_dms(
    A: np.ndarray,
    B: np.ndarray,
    Q: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    T: float,
    LAMBDA: np.ndarray,
    PSI: np.ndarray,
    cs: ConstraintSet,
    N: int,
    delta: float,
    terminal_at: str = "first",
    tighten_first_step: bool = True,
) -> CondensedQP:
    """Condense the CasADi-family direct-input tracking OCP.

    z = [du_0..du_{N-1}; theta] in delta coordinates; x_{k+1} = A x_k + B du_k.
    Cost replicates DMS_LBMPC_casadi.m costfunction (:252-268): delta-scaled
    running cost on stages 0..N-1 plus terminal P on x_N and T on Lambda theta.
    Constraints replicate nonlinearconstraints (:282-315): state rows on
    x_1..x_N, input rows on u_0..u_{N-1}, tightened + terminal rows at x_1.
    """
    first = terminal_at == "first"
    return _casadi_qp(A, B, None, Q, R, P, T, LAMBDA, PSI, cs, N, delta,
                      k_terminal=1 if first else N,
                      tighten=first and tighten_first_step)
