"""Allan-variance IMU noise calibration.

Port of ``vio_tpu/calib/allan.py``: numpy on the host, with the curve
fit's Jacobian by ``torch.func.jacfwd`` in host float64 and its LM loop
in the port's ``solver/generic.py``.  From the reference's ROS
calibration package
(reference: 12-imu-calibration/src/calibration/src/allan_variance.cpp —
log-spaced cluster sizes :117-149, 5-parameter log-log curve fit with
Ceres DOGLEG :301-327, JSON/CSV output :63-116; published accuracy
README.md:79-105: gyro N 0.01468 vs GT 0.015, acc N 0.01880 vs 0.019).

The overlapping Allan variance is computed with one cumulative sum and
vectorized cluster differencing (no ROS, no loops over samples); the
5-parameter model (quantization Q, white N, bias-instability B, random
walk K, ramp R) is fit in log-log space with the generic LM solver.
"""
from __future__ import annotations

import numpy as np
import torch

from ..solver import generic


def allan_variance(x: np.ndarray, dt: float, n_clusters: int = 100,
                   min_clusters: int = 9):
    """Overlapping Allan variance of a rate signal x (N,) sampled at dt.

    Returns (taus (M,), avar (M,)).  Cluster sizes are log-spaced from 1 to
    N/min_clusters (the reference requires ≥9 clusters per size)."""
    x = np.asarray(x, dtype=np.float64)
    N = len(x)
    theta = np.concatenate([[0.0], np.cumsum(x)]) * dt   # integrated angle
    max_m = N // min_clusters // 2
    ms = np.unique(np.round(np.logspace(0, np.log10(max(max_m, 2)),
                                        n_clusters)).astype(np.int64))
    ms = ms[ms >= 1]
    taus = ms * dt
    avar = np.empty(len(ms))
    for i, m in enumerate(ms):
        d = theta[2 * m:] - 2.0 * theta[m:-m] + theta[:-2 * m]
        avar[i] = np.sum(d * d) / (2.0 * (N - 2 * m + 1) * (m * dt) ** 2)
    return taus, avar


def fit_allan_params(taus: np.ndarray, adev: np.ndarray, max_iter: int = 80):
    """Fit sigma²(tau) = Q²/tau² + N²/tau + B² + K²·tau + R²·tau² in
    log-log space (the reference's 5-parameter AutoDiff model,
    allan_variance.h:137-184).  Host float64, as in vio_tpu.  Returns
    dict with Q, N, B, K, R."""
    lt = torch.as_tensor(np.log(taus), dtype=torch.float64)
    ld = torch.as_tensor(np.log(adev), dtype=torch.float64)

    def residuals(p):
        # (5, 1) coefficients keep every term ≥ 1-d under jacfwd
        q2, n2, b2, k2, r2 = torch.exp(p)[:, None]   # positive by construction
        tau = torch.exp(lt)
        s2 = q2 / tau ** 2 + n2 / tau + b2 + k2 * tau + r2 * tau ** 2
        return 0.5 * torch.log(s2) - ld

    def normal_fn(p):
        r = residuals(p)
        J = torch.func.jacfwd(residuals)(p)
        return J.T @ J, -J.T @ r, 0.5 * torch.sum(r * r)

    def chi2_fn(p):
        r = residuals(p)
        return 0.5 * torch.sum(r * r)

    # init each regime from the part of the curve it dominates:
    # Q from the first point, N from tau≈1, B from the minimum,
    # K/R from the last point
    avar = adev ** 2
    i1 = int(np.argmin(np.abs(np.log(taus))))
    p0 = torch.log(torch.tensor([
        max(avar[0] * taus[0] ** 2 * 0.25, 1e-16),
        max(avar[i1] * 1.0, 1e-14),
        max(np.min(avar) * 0.1, 1e-16),
        max(avar[-1] / taus[-1] * 0.25, 1e-16),
        max(avar[-1] / taus[-1] ** 2 * 0.05, 1e-18),
    ], dtype=torch.float64))
    p, stats = generic.lm_solve_dense(normal_fn, chi2_fn,
                                      lambda x, d: x + d, p0,
                                      max_iter=max_iter)
    q2, n2, b2, k2, r2 = np.exp(p.numpy())
    return dict(Q=np.sqrt(q2), N=np.sqrt(n2), B=np.sqrt(b2),
                K=np.sqrt(k2), R=np.sqrt(r2), chi2=stats["chi2"])


def detect_static_prefix(gyr: np.ndarray, dt: float, win_s: float = 1.0,
                         thresh: float = 0.05, margin_s: float = 1.0) -> int:
    """Number of leading samples during which the IMU is static, judged by
    the gyro-magnitude standard deviation over sliding windows staying
    below ``thresh`` [rad/s].  Real sequences (e.g. EuRoC MH-05) begin
    with the sensor at rest — the only segment on which Allan variance is
    meaningful.  ``margin_s`` seconds are trimmed before the detected
    motion onset.  Returns 0 if the stream starts in motion."""
    g = np.linalg.norm(np.asarray(gyr, np.float64), axis=1)
    win = max(int(round(win_s / dt)), 2)
    hop = max(win // 2, 1)
    for i in range(0, len(g) - win, hop):
        if g[i:i + win].std() > thresh:
            onset = i  # window start: conservatively treat as moving
            return max(int(onset - margin_s / dt), 0)
    return len(g)


def calibrate(x: np.ndarray, dt: float, n_clusters: int = 100):
    """Full per-axis calibration: Allan deviation + parameter fit.
    x (N,) or (N, 3).  Returns dict (per-axis lists when 3 axes):
    noise_density N [unit/√Hz] and bias random walk K."""
    x = np.atleast_2d(np.asarray(x).T).T
    out = dict(taus=None, adev=[], N=[], K=[], B=[])
    for a in range(x.shape[1]):
        taus, avar = allan_variance(x[:, a], dt, n_clusters)
        adev = np.sqrt(avar)
        fit = fit_allan_params(taus, adev)
        out["taus"] = taus
        out["adev"].append(adev)
        out["N"].append(fit["N"])
        out["K"].append(fit["K"])
        out["B"].append(fit["B"])
    return out
