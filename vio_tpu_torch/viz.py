"""Offline analysis dashboards (matplotlib), replacing the reference's
visualize.py scripts (reference: 13-.../scripts/visualize.py LM lambda
curves, 12-.../calibration/scripts/visualize.py Allan curves,
16-.../scripts/visualize.py triangulation quality, 17-.../python_tool
trajectory plots).  All functions save PNGs; no GUI anywhere (SURVEY.md §5
aux plan: structured logs + offline plots, no Pangolin).

Numpy copy of ``vio_tpu/viz.py``; tensors are accepted and brought to the
host first."""
from __future__ import annotations

import numpy as np


def _np(x):
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_lm_log(log, path: str, title: str = "LM convergence"):
    """chi²/lambda per iteration (13-parity: curve_fitting_LM_log CSV)."""
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
    a1.semilogy(log.chi2, marker="o")
    a1.set_xlabel("iteration")
    a1.set_ylabel("0.5·chi²")
    a1.grid(True, alpha=0.3)
    a2.semilogy(log.lam, marker="o", color="tab:orange")
    a2.set_xlabel("iteration")
    a2.set_ylabel("lambda")
    a2.grid(True, alpha=0.3)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path


def plot_allan(taus, adev_axes, path: str, labels=("x", "y", "z"),
               fit=None):
    """Allan deviation log-log curves (12-parity)."""
    taus, adev_axes = _np(taus), _np(adev_axes)
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    for adev, lb in zip(np.atleast_2d(adev_axes), labels):
        ax.loglog(taus, adev, label=lb)
    if fit is not None:
        tau = np.asarray(taus)
        s2 = (fit["Q"] ** 2 / tau ** 2 + fit["N"] ** 2 / tau +
              fit["B"] ** 2 + fit["K"] ** 2 * tau + fit["R"] ** 2 * tau ** 2)
        ax.loglog(tau, np.sqrt(s2), "k--", label="fit")
    ax.set_xlabel("tau [s]")
    ax.set_ylabel("Allan deviation")
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path


def plot_trajectory(est_p, gt_p, path: str, title: str = "trajectory"):
    """3-view trajectory comparison (17-parity: draw_trajcory.py)."""
    est_p = _np(est_p)
    gt_p = None if gt_p is None else _np(gt_p)
    plt = _plt()
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    pairs = [(0, 1), (0, 2), (1, 2)]
    names = ["xy", "xz", "yz"]
    for ax, (i, j), nm in zip(axes, pairs, names):
        if gt_p is not None:
            ax.plot(gt_p[:, i], gt_p[:, j], "k-", lw=1, label="gt")
        ax.plot(est_p[:, i], est_p[:, j], "r--", lw=1, label="est")
        ax.set_xlabel("xyz"[i])
        ax.set_ylabel("xyz"[j])
        ax.set_title(nm)
        ax.axis("equal")
        ax.grid(True, alpha=0.3)
    axes[0].legend()
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path


def plot_triangulation_quality(noise_levels, sv_ratios, rel_errors,
                               path: str):
    """sigma3/sigma4 quality ratio + relative error vs noise
    (16-parity: triangulate.cpp:163-172 CSV → visualize.py)."""
    noise_levels, sv_ratios, rel_errors = map(_np, (noise_levels, sv_ratios,
                                                   rel_errors))
    plt = _plt()
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(10, 4))
    a1.semilogy(noise_levels, sv_ratios, marker="o")
    a1.set_xlabel("obs noise [px]")
    a1.set_ylabel("sigma3 / sigma4")
    a1.grid(True, alpha=0.3)
    a2.semilogy(noise_levels, rel_errors, marker="o", color="tab:red")
    a2.set_xlabel("obs noise [px]")
    a2.set_ylabel("relative depth error")
    a2.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    return path
