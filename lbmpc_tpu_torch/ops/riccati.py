"""Riccati machinery, batched over lanes: the DARE by doubling, the
finite-horizon LQ by the sequential sweep, and the same factorization by a
log-depth scan over value-function elements.

Port of lbmpc_tpu/ops/riccati.py. The reference solves one problem and is
vmapped; here every per-problem array carries the lanes on its leading
axis, and arrays shared by all lanes may come without it (they broadcast):

  1. `dare_doubling` — the DARE by structure-preserving doubling, fixed
     iterations (the counterpart of synthesis.dare, MATLAB `dare`).
  2. `lqr_backward` — the sequential Riccati recursion over the stages and
     the forward rollout.
  3. `lqr_parallel` — the same (K, k_ff, V) from an associative scan over
     the time-reversed element array (Sarkka & Garcia-Fernandez). torch has
     no associative scan, so `associative_scan` below is jax.lax's odd/even
     recursion written out: it combines the same pairs in the same order.

All solve:  min sum_{k=0}^{N-1} [1/2 x'Q x + 1/2 u'R u + q'x + r'u]
                 + 1/2 x_N' P x_N + p' x_N
            s.t. x_{k+1} = A x_k + B u_k + c_k,   x_0 given.

Every linear solve is `torch.linalg.solve_ex` / `inv_ex` with
check_errors=False: a singular system gives inf/NaN, as jnp.linalg.solve
does, and nothing reads the device to check it (so a CUDA graph can hold
the sweeps).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^-1 B (broadcast), inf/NaN on a singular A and no host check."""
    return torch.linalg.solve_ex(A, B, check_errors=False)[0]


def _inv(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv_ex(A, check_errors=False)[0]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v over the leading (broadcast) axes: M (..., r, c), v (..., c)."""
    return (M @ v[..., None])[..., 0]


def dare_doubling(A, B, Q, R, iters: int = 30) -> torch.Tensor:
    """Solve A'XA - X - A'XB(B'XB+R)^-1 B'XA + Q = 0 by the structure-
    preserving doubling algorithm (quadratic convergence, fixed iterations).
    Arrays (..., n, n), (..., n, m), (..., n, n), (..., m, m); leading axes
    broadcast (a batch of lanes)."""
    n = A.shape[-1]
    I = torch.eye(n, dtype=A.dtype, device=A.device)
    G = B @ _solve(R, B.mT)
    Ak, Gk, Hk = A, G, Q
    for _ in range(iters):
        W = I + Gk @ Hk
        Winv_A = _solve(W, Ak)
        A1 = Ak @ Winv_A
        G1 = Gk + Ak @ Gk @ _solve(W.mT, Ak.mT)
        H1 = Hk + Winv_A.mT @ Hk @ Ak
        Ak, Gk, Hk = A1, G1, H1
    return Hk


class LQSolution(NamedTuple):
    X: torch.Tensor       # (B, N+1, n) optimal states
    U: torch.Tensor       # (B, N, m) optimal inputs
    K: torch.Tensor       # (B, N, m, n) feedback gains
    k_ff: torch.Tensor    # (B, N, m) feedforward terms
    V: torch.Tensor       # (B, N+1, n, n) value Hessians (Riccati matrices)


def _stages(x0, B, q, r, c, p, Q, R):
    """The lane count, N and the affine terms with their zero defaults, and
    Q, R as (Bl, N, ., .) stage stacks (a 4-d Q or R is stage-varying)."""
    n, m = B.shape[-2:]
    Bl = x0.shape[0]
    N = q.shape[-2] if q is not None else c.shape[-2]
    kw = dict(dtype=x0.dtype, device=x0.device)
    q = torch.zeros(Bl, N, n, **kw) if q is None else q.expand(Bl, N, n)
    r = torch.zeros(Bl, N, m, **kw) if r is None else r.expand(Bl, N, m)
    c = torch.zeros(Bl, N, n, **kw) if c is None else c.expand(Bl, N, n)
    p = torch.zeros(Bl, n, **kw) if p is None else p.expand(Bl, n)
    Qs = Q if Q.ndim == 4 else Q.unsqueeze(-3)
    Rs = R if R.ndim == 4 else R.unsqueeze(-3)
    return Bl, N, q, r, c, p, Qs.expand(Bl, N, n, n), Rs.expand(Bl, N, m, m)


def _rollout(A, B, x0, Ks, kfs, c):
    """x_{k+1} = A x_k + B u_k + c_k with u_k = K_k x_k + kf_k."""
    x, X, U = x0, [], []
    for k in range(Ks.shape[1]):
        u = _mv(Ks[:, k], x) + kfs[:, k]
        x1 = _mv(A, x) + _mv(B, u) + c[:, k]
        X.append(x)
        U.append(u)
        x = x1
    return torch.stack(X + [x], 1), torch.stack(U, 1)


def _gains(B, A, V1, v1, Rk, rk, ck):
    BtV = B.mT @ V1
    S = Rk + BtV @ B
    K = -_solve(S, BtV @ A)
    kf = -_solve(S, _mv(B.mT, _mv(V1, ck) + v1) + rk)
    return K, kf


def lqr_backward(A, B, Q, R, P, x0, q=None, r=None, c=None, p=None) -> LQSolution:
    """Sequential Riccati factorization + forward rollout.

    x0 (Bl, n) sets the lanes. A (n, n), B (n, m), P (n, n), with or without
    the lane axis; Q/R time-invariant ((.., n, n) / (.., m, m)) or
    stage-varying ((Bl, N, n, n) / (Bl, N, m, m)); optional affine terms
    q (Bl, N, n), r (Bl, N, m), c (Bl, N, n) dynamics offsets and p (Bl, n)
    terminal linear cost (a shared one without the lane axis broadcasts).
    """
    Bl, N, q, r, c, p, Qs, Rs = _stages(x0, B, q, r, c, p, Q, R)
    n = x0.shape[-1]
    V, v = P.expand(Bl, n, n), p
    Ks, kfs, Vs = [None] * N, [None] * N, [None] * (N + 1)
    for k in reversed(range(N)):
        Qk, qk, Rk, rk, ck = Qs[:, k], q[:, k], Rs[:, k], r[:, k], c[:, k]
        K, kf = _gains(B, A, V, v, Rk, rk, ck)
        Acl = A + B @ K
        # V_k = Q + K'RK + Acl'V Acl ;  v_k = q + K'(r + R kf) + Acl'(V(B kf + c) + v)
        V1 = Qk + K.mT @ Rk @ K + Acl.mT @ V @ Acl
        v1 = qk + _mv(K.mT, rk + _mv(Rk, kf)) + _mv(Acl.mT, _mv(V, _mv(B, kf) + ck) + v)
        Ks[k], kfs[k], Vs[k + 1] = K, kf, V
        V, v = V1, v1
    Vs[0] = V
    Ks, kfs = torch.stack(Ks, 1), torch.stack(kfs, 1)
    X, U = _rollout(A, B, x0, Ks, kfs, c)
    return LQSolution(X=X, U=U, K=Ks, k_ff=kfs, V=torch.stack(Vs, 1))


# ---------------- parallel (associative-scan) Riccati ----------------
#
# Value-function elements (Sarkka & Garcia-Fernandez 2021): the conditional
# value function between stages i<j in the dual representation
# (A, b, C, eta, J); composition is associative (the formulas in _combine).


def _combine(later, earlier):
    """Associative combination of value elements; elem = (A, b, C, eta, J).

    Called by `associative_scan` over the time-REVERSED element array, so the
    first argument is the already-combined LATER block (index j in the
    Sarkka/Garcia-Fernandez formulas) and the second is the EARLIER element
    (index i). Arrays carry leading batch dims."""
    Aj, bj, Cj, ej, Jj = later
    Ai, bi, Ci, ei, Ji = earlier
    n = Ai.shape[-1]
    I = torch.eye(n, dtype=Ai.dtype, device=Ai.device)
    M = I + Ci @ Jj                      # (I + C_i J_j)
    A = Aj @ _solve(M, Ai)
    b = (Aj @ _solve(M, bi[..., None] + Ci @ ej[..., None]))[..., 0] + bj
    C = Aj @ _solve(M, Ci) @ Aj.mT + Cj
    Mt = I + Jj @ Ci                     # (I + J_j C_i)
    e = (Ai.mT @ _solve(Mt, ej[..., None] - Jj @ bi[..., None]))[..., 0] + ei
    J = Ai.mT @ _solve(Mt, Jj) @ Ai + Ji
    return (A, b, C, e, J)


def _interleave(even, odd):
    """[e0, o0, e1, o1, ...] along axis 1 (len(even) is len(odd) or one
    more)."""
    k = even.shape[1] + odd.shape[1]
    out = torch.empty((even.shape[0], k) + even.shape[2:], dtype=even.dtype,
                      device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(fn, elems):
    """Inclusive scan of `fn` along axis 1 (axis 0 holds the lanes) of the
    tuple of arrays `elems`: [a, fn(a, b), fn(fn(a, b), c), ...]. The
    odd/even recursion of jax.lax.associative_scan, so the same pairs meet
    in the same order: adjacent pairs are combined, the half-length array
    is scanned, and the even entries are the odd results combined with the
    next original entry."""
    k = elems[0].shape[1]
    if k < 2:
        return list(elems)
    reduced = fn([e[:, 0:k - 1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    nxt = [e[:, 2::2] for e in elems]
    if nxt[0].shape[1] == 0:
        even = [e[:, :1] for e in elems]
    else:
        left = [e[:, :-1] for e in odd] if k % 2 == 0 else odd
        even = [torch.cat([e[:, :1], r], 1) for e, r in zip(elems, fn(left, nxt))]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def lqr_parallel(A, B, Q, R, P, x0, q=None, r=None, c=None, p=None) -> LQSolution:
    """Parallel Riccati: O(log N) depth over the stages by an associative
    scan; the same (K, k_ff, V) as `lqr_backward` up to roundoff, and the
    same arguments. Q and R may be stage-varying ((Bl, N, n, n) /
    (Bl, N, m, m)) — the form the sparse IPM's barrier-modified weights take
    (ops/sparse_ipm.py)."""
    Bl, N, q, r, c, p, Qs, Rs = _stages(x0, B, q, r, c, p, Q, R)
    n = x0.shape[-1]
    kw = dict(dtype=x0.dtype, device=x0.device)
    Rinv = _inv(Rs)                                   # (Bl, N, m, m)
    # stage elements: A_k = A, b_k = c_k - B R_k^-1 r_k, C_k = B R_k^-1 B',
    # eta_k = -q_k, J_k = Q_k (value-function dual parametrization); the
    # terminal element A = b = C = 0, eta = -p, J = P encodes V_N
    B3 = B.unsqueeze(-3)
    BRinv = B3 @ Rinv
    elems = (
        torch.cat([A.unsqueeze(-3).expand(Bl, N, n, n), torch.zeros(Bl, 1, n, n, **kw)], 1),
        torch.cat([c - _mv(BRinv, r), torch.zeros(Bl, 1, n, **kw)], 1),
        torch.cat([BRinv @ B3.mT, torch.zeros(Bl, 1, n, n, **kw)], 1),
        torch.cat([-q, -p[:, None]], 1),
        torch.cat([Qs, P.expand(Bl, n, n)[:, None]], 1),
    )
    # reverse scan: suffix compositions give the value function at each stage
    scanned = associative_scan(_combine, [e.flip(1) for e in elems])
    etas, Js = scanned[3].flip(1), scanned[4].flip(1)
    # V_k = J of the suffix element at k; the linear term v_k = -eta
    Vs, vs = Js, -etas
    Ks, kfs = _gains(B3, A.unsqueeze(-3), Vs[:, 1:], vs[:, 1:], Rs, r, c)
    X, U = _rollout(A, B, x0, Ks, kfs, c)
    return LQSolution(X=X, U=U, K=Ks, k_ff=kfs, V=Vs)


def scan_peak_bytes(lanes: int, N: int, n: int, m: int, itemsize: int) -> int:
    """A model of the peak bytes `lqr_parallel` holds at once for `lanes`
    lanes of N stages, from its shapes: the element array (N+1 entries of
    the five arrays, 3 n^2 + 2 n numbers an entry) in its forward copy, its
    time-reversed copy and every level of the recursion, plus the
    top level's odd and even halves, their concatenation and the
    interleaved result, plus the combine's temporaries (at most 8 n x n
    matrices a pair)."""
    per = 3 * n * n + 2 * n
    k, levels = N + 1, 0
    while k >= 2:
        k //= 2
        levels += k
    top = N + 1
    entries = 2 * top + levels + top // 2 * 2 + (top + 1) // 2 + top
    temps = (top // 2) * 8 * n * n
    stage = N * (2 * n * n + m * m + 2 * n + 2 * m)   # Q, R, q, r, c stacks and Rinv, B Rinv
    return lanes * itemsize * (entries * per + temps + stage)
