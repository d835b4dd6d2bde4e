"""Plot helpers: the reference's figure suite, matplotlib-optional.

Port of lbmpc_tpu/analysis/plots.py (ref: utilities/plotRESPONSE.m,
plot_RESPONSE.m, utilities/plot2DSS.m). matplotlib is imported inside each
function, so the package imports without it; histories may be tensors on
any device.
"""

from __future__ import annotations

import numpy as np

from lbmpc_tpu_torch.analysis.compare import _host, _pyplot


def plot_response(sys_history, art_ref=None, ts: float = 0.01, labels=None, ax=None,
                  save_path=None):
    """Per-channel subplot grid of a closed-loop [x; u] history.

    sys_history: (T, n+m) or (n+m, T). Ref: utilities/plotRESPONSE.m:1-14.
    """
    plt = _pyplot()
    sysH = _host(sys_history)
    if sysH.shape[0] < sysH.shape[1]:
        sysH = sysH.T
    T, ch = sysH.shape
    t = ts * np.arange(T)
    fig, axes = plt.subplots(ch, 1, figsize=(8, 2 * ch), sharex=True)
    for i in range(ch):
        axes[i].plot(t, sysH[:, i], lw=1.2)
        if art_ref is not None and i == 0:
            ar = _host(art_ref)
            axes[i].plot(ts * np.arange(len(ar)), ar, "--", lw=1.0, label="art ref")
            axes[i].legend()
        axes[i].grid(True)
        axes[i].set_ylabel(
            (labels[i] if labels else (f"x{i+1}" if i < ch - 1 else "u"))
        )
    axes[-1].set_xlabel("time [s]")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def plot_state_space(x1, x2, sets=None, save_path=None):
    """x1-x2 phase plot with optional polytope overlays.

    Ref: utilities/plot2DSS.m, trackingMPC/RunExample.m:181-208 set plots.
    `sets`: iterable of (Polytope, label) drawn via their 2-D vertices.
    """
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    if sets:
        for poly, label in sets:
            V = poly.vertices()
            # order vertices by angle for a closed outline
            c = V.mean(axis=0)
            ang = np.arctan2(V[:, 1] - c[1], V[:, 0] - c[0])
            Vo = V[np.argsort(ang)]
            ax.fill(Vo[:, 0], Vo[:, 1], alpha=0.15, label=label)
            ax.plot(np.r_[Vo[:, 0], Vo[0, 0]], np.r_[Vo[:, 1], Vo[0, 1]], lw=1.0)
    ax.plot(_host(x1), _host(x2), "o-", ms=3, lw=1.2, label="trajectory")
    ax.set_xlabel("x1")
    ax.set_ylabel("x2")
    ax.grid(True)
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig
