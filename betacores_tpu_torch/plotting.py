"""Plotting kit for experiment results (counterpart of
betacores_tpu/plotting.py: numpy and matplotlib only; matplotlib is imported
by the caller, or by ``plot_gaussian_ellipse`` when it draws).

Spec: reference examples/common/plotting.py (bokeh) — log-axis KL /
accuracy / NLL curves with median + inter-quartile bands across trials, the
10-color categorical palette, and 3-sigma Gaussian ellipses. Rebuilt on
matplotlib (bokeh is not in the image); the plot scripts under ``examples/``
consume the results pickles the drivers write.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np

# the reference's 10-color palette (plotting.py:47-65 uses bokeh's Category10)
PALETTE = [
    "#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
    "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf",
]


def median_iqr(trials: np.ndarray):
    """(median, q25, q75) across axis 0 (trials x sizes), the reference's
    band statistic (plotting.py:84-90)."""
    med = np.median(trials, axis=0)
    q25 = np.percentile(trials, 25, axis=0)
    q75 = np.percentile(trials, 75, axis=0)
    return med, q25, q75


def plot_curves(ax, curves: Dict[str, np.ndarray], x: Optional[np.ndarray] = None,
                ylabel: str = "", log_y: bool = True, log_x: bool = False,
                xlabel: str = "coreset size"):
    """curves: {alg: (T, M) array of per-trial metric-vs-size}. Median line
    + IQR band per algorithm."""
    for i, (name, arr) in enumerate(curves.items()):
        arr = np.atleast_2d(np.asarray(arr))
        xs = np.arange(arr.shape[1]) if x is None else x
        med, lo, hi = median_iqr(arr)
        c = PALETTE[i % len(PALETTE)]
        ax.plot(xs, med, color=c, label=name, linewidth=2)
        ax.fill_between(xs, lo, hi, color=c, alpha=0.25, linewidth=0)
    if log_y:
        ax.set_yscale("log")
    if log_x:
        ax.set_xscale("log")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.legend(frameon=False)
    ax.spines[["top", "right"]].set_visible(False)
    return ax


def plot_gaussian_ellipse(ax, mu, Sig, color="#1f77b4", n_sigma: float = 3.0, **kw):
    """n-sigma covariance ellipse (reference plotting.py:71-76)."""
    vals, vecs = np.linalg.eigh(np.asarray(Sig)[:2, :2])
    angle = math.degrees(math.atan2(vecs[1, 1], vecs[0, 1]))
    from matplotlib.patches import Ellipse

    e = Ellipse(xy=np.asarray(mu)[:2], width=2 * n_sigma * np.sqrt(vals[1]),
                height=2 * n_sigma * np.sqrt(vals[0]), angle=angle,
                facecolor="none", edgecolor=color, **kw)
    ax.add_patch(e)
    return e


def save_fig(fig, path: str, dpi: int = 150):
    fig.tight_layout()
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
