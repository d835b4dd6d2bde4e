"""Nadaraya-Watson model-error oracle + fixed-shape data windows.

The LBMPC learning layer (ref: functions/oracleL2NW.m, functions/casadiL2NW.m,
utilities/update_data.m), as batched torch:

  - a window is struct-of-arrays (X (..., q, d_in), Y (..., q, d_out),
    valid (..., q), count (...)) with the lanes in the leading axes;
  - the moving window is a ring buffer (ref: update_data.m:3-10 shift-append;
    NW weights are permutation-invariant, so ring order equals shift order).

Semantics (identical to the reference package):
  - kernel value exp(-||X_i - xi||^2 / bw^2), bw=0.5, ridge lambda=0.001
    (ref: oracleL2NW.m:9-10,26-30);
  - weights = valid_i kval_i / (lambda + sum_j valid_j kval_j);
  - the fmincon family's initial zero observation (LBMPC_RunExample.m:78-80)
    is slot 0 marked valid with X=0, Y=0.

Updates return new windows; the inputs are not written.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lbmpc_tpu_torch.device import resolve_device
from lbmpc_tpu_torch.ops.lanes import lane_mm, lane_sum_dim


class DataWindow(NamedTuple):
    """Fixed-shape oracle observation window (leading axes = lanes)."""

    X: torch.Tensor       # (..., q, d_in)  regressors  xi = [dx1, dx2, du]
    Y: torch.Tensor       # (..., q, d_out) targets     model-error observations
    valid: torch.Tensor   # (..., q) 0/1 flags
    count: torch.Tensor   # (...) int32 — total points ever inserted

    def index(self, idx) -> "DataWindow":
        """The lanes `idx` of a batched window."""
        return DataWindow(self.X[idx], self.Y[idx], self.valid[idx],
                          self.count[idx])

    def to(self, dtype=None, device=None) -> "DataWindow":
        """Float fields cast to `dtype`; every field moved to `device`."""
        return DataWindow(self.X.to(device=device, dtype=dtype),
                          self.Y.to(device=device, dtype=dtype),
                          self.valid.to(device=device, dtype=dtype),
                          self.count.to(device=device))


def init_window(q: int, d_in: int = 3, d_out: int = 4, dtype=torch.float64,
                seed_zero_point: bool = True, batch: tuple = (),
                device=None) -> DataWindow:
    """Empty window (one per lane of `batch`); optionally seed slot 0 as a
    valid (0, 0) observation (both reference families start that way)."""
    dev = resolve_device(device)
    batch = tuple(batch)
    X = torch.zeros(batch + (q, d_in), dtype=dtype, device=dev)
    Y = torch.zeros(batch + (q, d_out), dtype=dtype, device=dev)
    valid = torch.zeros(batch + (q,), dtype=dtype, device=dev)
    valid[..., 0] = 1.0 if seed_zero_point else 0.0
    count = torch.full(batch, 1 if seed_zero_point else 0, dtype=torch.int32,
                       device=dev)
    return DataWindow(X, Y, valid, count)


def window_from_arrays(X, Y, q: int | None = None, dtype=torch.float64,
                       device=None) -> DataWindow:
    """A (pre-trained) window from stacked observations X (k, d_in), Y (k,
    d_out), or in the reference's row layout X (3, k), Y (4, k), e.g. its
    train_data.mat (7 x 500: rows 1-3 X, rows 4-7 Y; ref:
    hybrid_LBMPC_casadi.m pretraining, the DMS_tLBMPC_q500_pretrained
    golden). If k > q the most recent q points are kept; if k < q the rest
    stays invalid. One window, no lane axis."""
    X = np.asarray(X, float)
    Y = np.asarray(Y, float)
    if X.shape[0] < X.shape[1] and X.shape[0] in (3,):  # row-layout input
        X = X.T
        Y = Y.T
    k = X.shape[0]
    if q is None:
        q = k
    keep = min(k, q)
    Xw = np.zeros((q, X.shape[1]))
    Yw = np.zeros((q, Y.shape[1]))
    valid = np.zeros(q)
    Xw[:keep] = X[-keep:]
    Yw[:keep] = Y[-keep:]
    valid[:keep] = 1.0
    dev = resolve_device(device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return DataWindow(t(Xw), t(Yw), t(valid),
                      torch.tensor(keep, dtype=torch.int32, device=dev))


def push(window: DataWindow, x_new: torch.Tensor,
         y_new: torch.Tensor) -> DataWindow:
    """Insert one observation per lane at that lane's ring slot, overwriting
    the oldest once the window is full (ref: update_data.m:3-10)."""
    q = window.X.shape[-2]
    idx = (window.count % q).long()
    X, Y, valid = window.X.clone(), window.Y.clone(), window.valid.clone()
    if idx.ndim == 0:
        X[idx], Y[idx], valid[idx] = x_new, y_new, 1.0
    else:
        lanes = torch.arange(idx.shape[0], device=idx.device)
        X[lanes, idx] = x_new
        Y[lanes, idx] = y_new
        valid[lanes, idx] = 1.0
    return DataWindow(X, Y, valid, window.count + 1)


def push_batched(window: DataWindow, x_new: torch.Tensor,
                 y_new: torch.Tensor) -> DataWindow:
    """Batched push with a lockstep fast path (ref oracle.py:99-123): fleet
    cohorts advance together, so every lane's ring index is equal and one
    shared-index slab write replaces the per-lane scatter; when counts
    differ (hand-built heterogeneous windows) it falls back to `push`.
    Reading the lockstep test costs one device-to-host flag per call."""
    c0 = window.count[0]
    if not bool((window.count == c0).all()):
        return push(window, x_new, y_new)
    idx = int(c0) % window.X.shape[1]
    X, Y, valid = window.X.clone(), window.Y.clone(), window.valid.clone()
    X[:, idx] = x_new
    Y[:, idx] = y_new
    valid[:, idx] = 1.0
    return DataWindow(X, Y, valid, window.count + 1)


def nw_estimate(xi: torch.Tensor, window: DataWindow, bandwidth: float = 0.5,
                ridge: float = 0.001) -> torch.Tensor:
    """g(xi) = sum_i Y_i k(X_i, xi) / (ridge + sum_j valid_j k(X_j, xi)).

    xi (..., d_in) broadcasts against the window's lane axes: one query per
    lane (xi (B, d_in), X (B, q, d_in)) or a stack of queries against one
    window (xi (K, d_in), X (q, d_in)). Returns (..., d_out). The sums over
    the window take ops/lanes.lane_sum_dim's form, whose order does not
    depend on the number of lanes.
    """
    X, Y, valid = window.X, window.Y, window.valid
    sq = ((xi[..., None, :] - X) ** 2).sum(dim=-1)               # (..., q)
    kval = torch.exp(-sq / (bandwidth * bandwidth))
    denom = ridge + lane_sum_dim(kval * valid, -1)[..., None]
    weights = (kval * valid) / denom                              # (..., q)
    return lane_sum_dim(weights[..., None] * Y, -2)               # (..., d_out)


def nw_estimate_and_jac(xi: torch.Tensor, window: DataWindow,
                        bandwidth: float = 0.5, ridge: float = 0.001):
    """NW value AND its closed-form xi-Jacobian from one kernel evaluation:

        d yhat / d xi = (2 / bw^2) [ sum_i w_i Y_i (X_i - xi)^T
                                     - yhat (sum_j w_j (X_j - xi))^T ]

    Returns (yhat (..., d_out), J (..., d_out, d_in)). The sums over the
    window as in nw_estimate.
    """
    X, Y, valid = window.X, window.Y, window.valid
    diff = X - xi[..., None, :]                                   # (..., q, d_in)
    sq = (diff * diff).sum(dim=-1)                                # (..., q)
    kval = torch.exp(-sq / (bandwidth * bandwidth))
    denom = ridge + lane_sum_dim(kval * valid, -1)[..., None]
    weights = (kval * valid) / denom                              # (..., q)
    wY = weights[..., None] * Y                                   # (..., q, d_out)
    yhat = lane_sum_dim(wY, -2)
    T1 = lane_sum_dim(wY[..., :, :, None] * diff[..., :, None, :], -3)
    s1 = lane_sum_dim(weights[..., None] * diff, -2)
    J = (2.0 / (bandwidth * bandwidth)) * (T1 - yhat[..., :, None] * s1[..., None, :])
    return yhat, J


def make_xi(dx: torch.Tensor, du: torch.Tensor) -> torch.Tensor:
    """Regressor xi = [dx1; dx2; du] (ref: oracleL2NW.m:2 `ksi=[x(1:2);u]`)."""
    return torch.cat([dx[..., :2], du], dim=-1)


def learned_step(dx: torch.Tensor, du: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, window: DataWindow, bandwidth: float = 0.5,
                 ridge: float = 0.001) -> torch.Tensor:
    """Learned model x+ = A dx + B du + g([dx1, dx2, du]) in delta
    coordinates (ref: models/learnedModel.m:25, DMS_LBMPC_casadi.m:321-333).
    dx (..., n), du (..., m); the query broadcasts against the window as in
    nw_estimate."""
    lin = lane_mm(dx, A) + lane_mm(du, B)
    return lin + nw_estimate(make_xi(dx, du), window, bandwidth, ridge)


def observe_residual(dx_k, du_k, dx_k1_true, A, B):
    """Data-acquisition pair (X, Y): regressor and true-vs-nominal residual
    (ref: functions/ocpLBMPC.m:14-15, DMS_LBMPC_casadi.m:204-206)."""
    x_new = make_xi(dx_k, du_k)
    y_new = dx_k1_true - (lane_mm(dx_k, A) + lane_mm(du_k, B))
    return x_new, y_new
