"""Trajectory comparison suite: the reference's overlay-plot scripts as code.

Port of lbmpc_tpu/analysis/compare.py (ref: saved_data+plots/compare.m:3-24,
plot_all.m, LMPCvsLBMPC.m:4-60, NMPCvsLBMPC.m, horizonsLBMPC.m:4-17,
plots_LBMPC.m, valid_qplots_LBMPC.m, validation_plots_LBMPC.m): each
reference script is one call over labeled histories,

  compare.m / plot_all.m / LMPCvsLBMPC.m / NMPCvsLBMPC.m, the horizon and
  window sweeps  -> overlay_histories({"LBMPC": h1, "LMPC": h2, ...}, ts)
  the response_info tables those scripts print
                 -> comparison_table(histories, ts), sweep_table(...)
  solve_stats.m:9-30 mean/CI95 + histfit figure
                 -> solve_stats_figure(samples_s)

A history is a (T, n+m) array ([states; input] columns, the reference's
sysH layout transposed; the (n+m, T) layout is accepted too), a tensor on
any device, an object with .x (T, n) and .u (T, m), or one episode's
ClosedLoopResult of the port (its sys_history, moved to the CPU).
matplotlib is imported only when a figure is drawn.
"""

from __future__ import annotations

import numpy as np
import torch

from lbmpc_tpu_torch.analysis.metrics import response_info
from lbmpc_tpu_torch.analysis.solve_stats import SolveStats


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, float)


def _as_history(h) -> np.ndarray:
    """Normalize a history to (T, channels) float array."""
    if hasattr(h, "sys_history"):
        h = h.sys_history
    elif hasattr(h, "x") and hasattr(h, "u"):
        x = _host(h.x)
        u = _host(h.u)
        if u.ndim == 1:
            u = u[:, None]
        T = min(x.shape[0], u.shape[0])
        return np.concatenate([x[:T], u[:T]], axis=1)
    a = _host(h)
    if a.ndim != 2:
        raise ValueError(f"history must be 2-D, got shape {a.shape}")
    # reference stores channel-major sysH (n+m, T); accept either orientation
    if a.shape[0] < a.shape[1]:
        a = a.T
    return a


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def overlay_histories(histories: dict, ts: float = 0.01, channel_labels=None,
                      refs=None, save_path=None):
    """Per-channel overlay of several labeled closed-loop histories: one
    subplot per channel, one line per controller/config, the optional
    reference dotted (ref: compare.m:8-23, LMPCvsLBMPC.m:12-60,
    horizonsLBMPC.m:14-22).

    refs: optional (channels,) or (channels, T) reference values drawn dotted.
    Returns the matplotlib figure.
    """
    plt = _pyplot()
    hs = {label: _as_history(h) for label, h in histories.items()}
    ch = max(h.shape[1] for h in hs.values())
    fig, axes = plt.subplots(ch, 1, figsize=(8, 2 * ch), sharex=True, squeeze=False)
    axes = axes[:, 0]
    styles = ["-", "-.", "--", ":", "-", "-."]
    for i in range(ch):
        ax = axes[i]
        for k, (label, h) in enumerate(hs.items()):
            if i >= h.shape[1]:
                continue
            t = ts * np.arange(h.shape[0])
            ax.plot(t, h[:, i], styles[k % len(styles)], lw=1.5, label=label)
        if refs is not None:
            r = np.asarray(refs, float)
            rline = np.full(h.shape[0], r[i]) if r.ndim == 1 else r[i]
            ax.plot(ts * np.arange(len(rline)), rline, ":", lw=1.0, color="k")
        ax.grid(True)
        ax.set_ylabel(
            channel_labels[i] if channel_labels
            else (f"x{i + 1}" if i < ch - 1 else "u")
        )
    axes[0].legend(loc="best", fontsize=8)
    axes[-1].set_xlabel("time [s]")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def comparison_table(histories: dict, ts: float = 0.01, channel: int = 0,
                     ref_value: float = 0.0) -> dict:
    """Response-metric table across labeled runs, for one output channel:
    settling time, overshoot, cumulative tracking error, control energy,
    final error (ref: saved_data+plots/utilities/response_info.m:1-7 applied
    per controller in the LMPCvsLBMPC/NMPCvsLBMPC analyses)."""
    out = {}
    for label, h in histories.items():
        a = torch.as_tensor(_as_history(h), dtype=torch.float64)
        x = a[:, channel]
        u = a[:, -1]
        ref = torch.full_like(x, ref_value)
        info = response_info(x, u, ref, ts)
        out[label] = {k: float(v) for k, v in info._asdict().items()}
    return out


def sweep_table(histories_by_param: dict, ts: float = 0.01, channel: int = 0,
                ref_value: float = 0.0) -> dict:
    """Metric table for a parameter sweep (horizon N or window size q;
    ref: horizonsLBMPC.m:4-7, valid_qplots_LBMPC.m)."""
    return comparison_table(
        {str(k): v for k, v in histories_by_param.items()}, ts, channel, ref_value
    )


def solve_stats_figure(samples_s, save_path=None):
    """Mean solve time with 95% CI band over iterations + histogram/normal fit.

    Ref: saved_data+plots/solve_stats.m:9-30 (per-iteration mean across the 5
    runs with t-CI95 shading) and :106-116 (histfit). samples_s: (runs, iters)
    seconds. Returns (figure, SolveStats).
    """
    import scipy.stats

    plt = _pyplot()
    s = np.atleast_2d(np.asarray(samples_s, float)) * 1e3  # ms
    runs, iters = s.shape
    stats = SolveStats.from_samples(samples_s)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    mean_t = s.mean(axis=0)
    ax1.plot(mean_t, lw=1.0, label="mean solve time")
    if runs > 1:
        sem = scipy.stats.sem(s, axis=0)
        tcrit = scipy.stats.t.ppf(0.975, runs - 1)
        ax1.fill_between(np.arange(iters), mean_t - tcrit * sem,
                         mean_t + tcrit * sem, alpha=0.3, label="95% CI")
    ax1.set_xlabel("MPC iteration")
    ax1.set_ylabel("solve time [ms]")
    ax1.grid(True)
    ax1.legend(fontsize=8)

    flat = s.ravel()
    ax2.hist(flat, bins=min(40, max(10, len(flat) // 25)), density=True,
             alpha=0.6)
    mu, sd = float(flat.mean()), float(flat.std())
    grid = np.linspace(flat.min(), flat.max(), 200)
    if sd > 0:
        ax2.plot(grid, scipy.stats.norm.pdf(grid, mu, sd), lw=1.5,
                 label="normal fit")
        ax2.legend(fontsize=8)
    ax2.set_xlabel("solve time [ms]")
    ax2.grid(True)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig, stats
