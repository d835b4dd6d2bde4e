"""Stage-sharded Riccati sweeps over a mesh of devices ("SP").

Port of lbmpc_tpu/ops/riccati_sharded.py. The stage-form solvers
(ops/sparse_gn, ops/sparse_ipm) factor every IPM Newton system by Riccati
sweeps whose depth is the horizon N. This module splits the horizon's
stages into D blocks, one a shard of a "stage" mesh (runtime/sharding.Mesh),
and runs the sweep as a distributed linear recurrence:

  1. each shard eliminates the cross terms (c = v - R^-1 S' w) and folds
     its block of value-function elements (Sarkka & Garcia-Fernandez, as
     ops/riccati) into a suffix scan — ops/riccati.associative_scan, no
     communication;
  2. the D block composites (3 (nw, nw) and 2 (nw, K) arrays each) are
     exchanged, and every shard folds the composites of the later blocks
     and the terminal element into its carry-in;
  3. the local suffixes composed with the carry-in give every stage's value
     function (V_k, v_k); the gains use the original (A, B, S, R);
  4. the forward rollout is an affine recurrence: each block composes its
     closed-loop maps, the D composites are exchanged, and each block rolls
     from its carry-in.

The exchange: each shard writes its composite into its slot of a zero
(D, ...) stack; in a process the slots are filled by copies, across ranks
one `dist.all_reduce(SUM)` completes the stack (Mesh.all_reduce: adding
zeros is exact, and the one path serves NCCL and gloo, CPU and CUDA
tensors). The solution is gathered the same way.

Linear terms carry a trailing right-hand-side axis K, so one sweep serves
the stage-form IPM's theta columns and predictor. Arrays may carry leading
lane axes (they broadcast): the stage axis is the third from the end of
every stage array.
"""

from __future__ import annotations

import torch

from lbmpc_tpu_torch.ops.riccati import _inv, _solve, associative_scan
from lbmpc_tpu_torch.runtime.sharding import Mesh, scenario_mesh


def stage_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh on the 'stage' axis (runtime/sharding.scenario_mesh's
    rules: CUDA devices unless `devices` names them)."""
    return scenario_mesh(n_devices, axis="stage", devices=devices)


def _combine(later, earlier):
    """Associative combination of value elements (A, b, C, e, J) whose b
    and e carry a trailing right-hand-side axis K; `later` is the already
    combined suffix block (the composition of ops/riccati._combine)."""
    Aj, bj, Cj, ej, Jj = later
    Ai, bi, Ci, ei, Ji = earlier
    n = Ai.shape[-1]
    I = torch.eye(n, dtype=Ai.dtype, device=Ai.device)
    M = I + Ci @ Jj
    A = Aj @ _solve(M, Ai)
    b = Aj @ _solve(M, bi + Ci @ ej) + bj
    C = Aj @ _solve(M, Ci) @ Aj.mT + Cj
    Mt = I + Jj @ Ci
    e = Ai.mT @ _solve(Mt, ej - Jj @ bi) + ei
    J = Ai.mT @ _solve(Mt, Jj) @ Ai + Ji
    return (A, b, C, e, J)


def _identity_elem(lead, n, K, dtype, device):
    kw = dict(dtype=dtype, device=device)
    return (torch.eye(n, **kw).expand(lead + (n, n)), torch.zeros(lead + (n, K), **kw),
            torch.zeros(lead + (n, n), **kw), torch.zeros(lead + (n, K), **kw),
            torch.zeros(lead + (n, n), **kw))


def _exchange(mesh: Mesh, parts: dict, like: torch.Tensor) -> torch.Tensor:
    """The (D, ...) stack of every shard's `parts[j]` (this rank's shards'
    given), on the device of `like`: copies into a zero stack, then one
    all_reduce across the ranks."""
    stack = torch.zeros((mesh.size,) + tuple(like.shape), dtype=like.dtype,
                        device=like.device)
    for j, a in parts.items():
        stack[j] = a.to(like.device)
    return mesh.all_reduce(stack)


def _block(As, Bs, Qs, Ss, Rs, qs, rs):
    """Steps 1 and 3's stage algebra for one block (lanes on axis 0, stages
    on axis 1): the cross-term-free elements and their local suffix scan."""
    Rinv = _inv(Rs)
    SRi = Ss @ Rinv                                      # (Bl, L, nw, m)
    At = As - (Bs @ Rinv) @ Ss.mT
    Qt = Qs - SRi @ Ss.mT
    qt = qs - SRi @ rs                                   # (Bl, L, nw, K)
    Ce = Bs @ Rinv @ Bs.mT
    be = -(Bs @ Rinv @ rs)
    elems = (At, be, Ce, -qt, Qt)
    suf = associative_scan(_combine, [a.flip(1) for a in elems])
    return [a.flip(1) for a in suf]                      # suf[:, k] = [k..end]


def lqr_cross_sharded(mesh: Mesh, As, Bs, Qs, Ss, Rs, qs, rs, PN, pN):
    """Distributed-prefix LQ solve with cross terms and stage-varying
    dynamics — ops/sparse_gn._riccati_cross's problem with K right-hand
    sides:

      min sum_k 1/2 w'Q_k w + w'S_k c + 1/2 c'R_k c + q_k'w + r_k'c
          + 1/2 w_N'PN w_N + pN'w_N,   w_{k+1} = A_k w + B_k c,  w_0 = 0

    As (..., N, nw, nw), Bs (..., N, nw, m), Qs, Ss, Rs likewise, qs (..., N,
    nw, K), rs (..., N, m, K), PN (..., nw, nw), pN (..., nw, K); the leading
    axes (lanes) broadcast. The stages are split over the mesh's shards;
    each rank computes its blocks and every rank returns the whole
    (W (..., N+1, nw, K), C (..., N, m, K)) on the device of As. N not a
    multiple of the shards is padded with identity stages (A=I, B=0,
    Q=S=q=r=0, R=I), whose value elements are the identity — exact."""
    lead = torch.broadcast_shapes(As.shape[:-3], Bs.shape[:-3], Qs.shape[:-3],
                                  Ss.shape[:-3], Rs.shape[:-3], qs.shape[:-3],
                                  rs.shape[:-3], PN.shape[:-2], pN.shape[:-2])
    N, nw = As.shape[-3], As.shape[-1]
    m, K = Bs.shape[-1], qs.shape[-1]
    dtype, out_dev = As.dtype, As.device
    Bl = 1
    for d in lead:
        Bl *= d
    flat = lambda a, tail: a.expand(lead + tail).reshape((Bl,) + tail)
    As, Bs = flat(As, (N, nw, nw)), flat(Bs, (N, nw, m))
    Qs, Ss, Rs = flat(Qs, (N, nw, nw)), flat(Ss, (N, nw, m)), flat(Rs, (N, m, m))
    qs, rs = flat(qs, (N, nw, K)), flat(rs, (N, m, K))
    PN, pN = flat(PN, (nw, nw)), flat(pN, (nw, K))
    D = mesh.size
    pad = (-N) % D
    if pad:
        kw = dict(dtype=dtype, device=out_dev)

        def zpad(a, fill):
            return torch.cat([a, fill.expand((Bl, pad) + tuple(fill.shape))], dim=1)

        As, Bs = zpad(As, torch.eye(nw, **kw)), zpad(Bs, torch.zeros(nw, m, **kw))
        Qs, Ss = zpad(Qs, torch.zeros(nw, nw, **kw)), zpad(Ss, torch.zeros(nw, m, **kw))
        Rs = zpad(Rs, torch.eye(m, **kw))
        qs, rs = zpad(qs, torch.zeros(nw, K, **kw)), zpad(rs, torch.zeros(m, K, **kw))
    L = (N + pad) // D
    devs = dict(zip(mesh.local, mesh.devices))
    blk = {j: [a[:, j * L:(j + 1) * L].to(d) for a in (As, Bs, Qs, Ss, Rs, qs, rs)]
           for j, d in devs.items()}

    # ---- 1. local suffix scans; 2. exchange the block composites ----------
    j0 = mesh.local[0]
    sufs = {j: _block(*blk[j]) for j in devs}
    comps = [_exchange(mesh, {j: sufs[j][i][:, 0] for j in devs}, sufs[j0][i][:, 0])
             for i in range(5)]
    W_parts, C_parts, aff, gains = {}, {}, {}, {}
    for j, d in devs.items():
        Aj, Bj, Qj, Sj, Rj, qj, rj = blk[j]
        zero = lambda *s: torch.zeros((Bl,) + s, dtype=dtype, device=d)
        carry = (zero(nw, nw), zero(nw, K), zero(nw, nw), -pN.to(d), PN.to(d))
        for i in range(D - 1, j, -1):
            carry = _combine(carry, [c[i].to(d) for c in comps])
        # ---- 3. value functions at k+1 and the gains ----------------------
        ident = _identity_elem((Bl, 1), nw, K, dtype, d)
        shifted = [torch.cat([a[:, 1:], i], dim=1) for a, i in zip(sufs[j], ident)]
        full = _combine([c[:, None] for c in carry], shifted)
        Vs, vs = full[4], -full[3]
        BtV = Bj.mT @ Vs
        Sw = Rj + BtV @ Bj
        Kg = -_solve(Sw, Sj.mT + BtV @ Aj)
        kf = -_solve(Sw, Bj.mT @ vs + rj)                  # (Bl, L, m, K)
        # ---- 4. the block's affine composite -------------------------------
        Acl = Aj + Bj @ Kg
        ts = Bj @ kf
        Mc = torch.eye(nw, dtype=dtype, device=d).expand(Bl, nw, nw)
        tc = zero(nw, K)
        for k in range(L):
            Mc, tc = Acl[:, k] @ Mc, Acl[:, k] @ tc + ts[:, k]
        aff[j] = (Mc, tc)
        gains[j] = (Kg, kf)
    Mg = _exchange(mesh, {j: aff[j][0] for j in devs}, aff[j0][0])
    tg = _exchange(mesh, {j: aff[j][1] for j in devs}, aff[j0][1])
    for j, d in devs.items():
        Aj, Bj = blk[j][:2]
        Kg, kf = gains[j]
        w = torch.zeros((Bl, nw, K), dtype=dtype, device=d)
        for i in range(j):
            w = Mg[i].to(d) @ w + tg[i].to(d)
        Ws, Cs = [], []
        for k in range(L):
            c = Kg[:, k] @ w + kf[:, k]
            Ws.append(w)
            Cs.append(c)
            w = Aj[:, k] @ w + Bj[:, k] @ c
        W_parts[j] = torch.stack(Ws, 1)
        C_parts[j] = torch.stack(Cs, 1)
    wN = torch.zeros((Bl, nw, K), dtype=dtype, device=Mg.device)
    for i in range(D):
        wN = Mg[i] @ wN + tg[i]                          # the full fold: w_N
    # ---- gather the solution ----------------------------------------------
    WC = _exchange(mesh, {j: torch.cat([W_parts[j], C_parts[j]], dim=2) for j in devs},
                   torch.cat([W_parts[j0], C_parts[j0]], dim=2)).to(out_dev)
    WC = WC.movedim(0, 1).reshape(Bl, D * L, nw + m, K)
    W = torch.cat([WC[:, :N, :nw], wN.to(out_dev)[:, None]], dim=1)
    C = WC[:, :N, nw:]
    return W.reshape(lead + (N + 1, nw, K)), C.reshape(lead + (N, m, K))
