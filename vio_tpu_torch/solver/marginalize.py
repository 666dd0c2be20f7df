"""Marginalization of evicted keyframes into an eigendecomposed Hessian prior.

Port of ``vio_tpu/solver/marginalize.py`` (reference:
vins-mono/src/backend/problem.cc:617-795): build the Hessian over the marg
frame's factors, Schur-eliminate its landmarks, fold the old prior,
permute the marginalized pose+speedbias block to the bottom-right,
eliminate it with an eigh-based pseudo-inverse (eps=1e-8), and recover
the sqrt form (Jt_prior_inv, err_prior).

The estimator runs the host float64 chain (``finalize_old_from_blocks``,
``marginalize_new_host``): the prior is the window's only long-memory
state and is re-folded every frame, so float32 rounding here compounds
over a run (on the TPU the device-f32 chain diverged to 81.29 m,
RESULTS.md).  The device-side ``marginalize_old`` / ``marginalize_new``
and ``marginalize_old_host`` are the JAX package's entry points for a
window problem of the caller's; none of them is on the estimator's path.
``torch.linalg.eigh``'s eigenvectors carry arbitrary signs (and bases
inside repeated eigenvalues), so ``Jt_prior_inv`` and ``err_prior`` are
unique only up to a row rotation; and since these priors' spectra run
down to round-off across the 1e-8 cut, which eigenvalues the pseudo-
inverse keeps is the eigensolver's own.  What two eigensolvers agree on
is what H_prior weights: H·JtᵀJt·H (= H_prior) and H·Jtᵀ·err.
"""
from __future__ import annotations

import numpy as np
import torch

from . import window as W

EPS = 1e-8


def _eigh_schur(H, b, n_keep):
    """Eliminate the trailing block of H (rows/cols n_keep:) with the
    eigendecomposed pseudo-inverse (problem.cc:747-764)."""
    Amm = 0.5 * (H[n_keep:, n_keep:] + H[n_keep:, n_keep:].T)
    w, V = torch.linalg.eigh(Amm)
    w_inv = torch.where(w > EPS, 1.0 / torch.where(w > EPS, w, 1.0), 0.0)
    Amm_inv = (V * w_inv[None, :]) @ V.T
    tempB = H[:n_keep, n_keep:] @ Amm_inv
    return (H[:n_keep, :n_keep] - tempB @ H[n_keep:, :n_keep],
            b[:n_keep] - tempB @ b[n_keep:])


def _sqrt_form(H, b):
    """(Jt_prior_inv, err_prior, H_clean) via eigh square root
    (problem.cc:766-779)."""
    w, V = torch.linalg.eigh(H)
    S = torch.where(w > EPS, w, 0.0)
    S_inv = torch.where(w > EPS, 1.0 / torch.where(w > EPS, w, 1.0), 0.0)
    Jt_inv = torch.sqrt(S_inv)[:, None] * V.T
    err = -(Jt_inv @ b)
    J = torch.sqrt(S)[:, None] * V.T
    H_clean = J.T @ J
    H_clean = torch.where(torch.abs(H_clean) > 1e-9, H_clean, 0.0)
    return Jt_inv, err, H_clean


def _finalize(H_perm, b_perm, P):
    """Eliminate the trailing 15-dim marg block, then zero-pad everything
    back to the static size P (the reference's ExtendHessiansPriorSize(15)
    at the next solve, problem.cc:82-91)."""
    n_keep = P - 15
    H_new, b_new = _eigh_schur(H_perm, b_perm, n_keep)
    Jt_inv, err, H_clean = _sqrt_form(H_new, b_new)
    Hp = H_new.new_zeros((P, P))
    Jtp = H_new.new_zeros((P, P))
    bp = b_new.new_zeros(P)
    errp = b_new.new_zeros(P)
    Hp[:n_keep, :n_keep] = H_clean
    Jtp[:n_keep, :n_keep] = Jt_inv
    bp[:n_keep] = b_new
    errp[:n_keep] = err
    return Hp, bp, errp, Jtp


def _marg_old_normal(states: W.WindowStates, f: W.WindowFactors,
                     loss_delta: float, n_obs: int | None):
    """Normal equations of frame 0's factors (IMU interval 0 and every
    observation of landmarks hosted by frame 0, Cauchy loss), without
    fixed-vertex zeroing (Marginalize has none); the prior fold inside
    ``assemble`` matches problem.cc:711-715, since the prior is additive
    to the pose block only.  Returns (normal, marg_feat)."""
    W1 = states.Ps.shape[0]
    marg_feat = f.feat_valid & (f.start == 0)
    f_marg = f._replace(
        feat_valid=marg_feat,
        imu_valid=f.imu_valid & (torch.arange(W1 - 1, device=f.imu_valid.device) == 0))
    return W.assemble(states, f_marg, fix_ext=False, loss_delta=loss_delta,
                      n_obs=n_obs), marg_feat


def marginalize_old(states: W.WindowStates, f: W.WindowFactors,
                    loss_delta: float = 1.0):
    """Marginalize frame 0 (MargOldFrame, estimator.cpp:693-829) on the
    device, in the states' dtype: landmarks Schur-eliminated, prior
    folded, frame-0 pose+speedbias eliminated.  Returns (H_prior,
    b_prior, err_prior, Jt_prior_inv) zero-padded to the pose-param size."""
    P = W.num_pose_params(states.Ps.shape[0] - 1)
    n, marg_feat = _marg_old_normal(states, f, loss_delta, None)
    # landmark Schur (problem.cc:686-708)
    Hmm_inv = torch.where(torch.abs(n.Hmm) > 1e-30, 1.0 / n.Hmm, 0.0)
    Hmm_inv = torch.where(marg_feat, Hmm_inv, 0.0)
    tempH = n.Hpm * Hmm_inv[None, :]
    Hpp = n.Hpp - tempH @ n.Hpm.T
    bp = n.bp - tempH @ n.bm
    perm = torch.as_tensor(_perm_np(P, 0), device=Hpp.device)
    return _finalize(Hpp[perm][:, perm], bp[perm], P)


def marginalize_new(f: W.WindowFactors):
    """Marginalize frame W-1 out of the prior only (MargNewFrame,
    estimator.cpp:830-901 — the problem there contains no edges), on the
    prior's device and dtype."""
    P = f.H_prior.shape[0]
    W1 = (P - 6) // 15
    perm = torch.as_tensor(_perm_np(P, W1 - 2), device=f.H_prior.device)
    return _finalize(f.H_prior[perm][:, perm], f.b_prior[perm], P)


def marginalize_old_host(states: W.WindowStates, f: W.WindowFactors,
                         loss_delta: float = 1.0, n_obs: int | None = None):
    """marginalize_old with the prior chain in host float64: the Hessian
    of the marg frame's factors is assembled on the device (device dtype),
    everything after runs in numpy float64.  Returns host float64 arrays."""
    P = W.num_pose_params(states.Ps.shape[0] - 1)
    n, marg_feat = _marg_old_normal(states, f, loss_delta, n_obs)
    Hpp, bp, Hpm, Hmm, bm = (t.detach().cpu().numpy().astype(np.float64)
                             for t in (n.Hpp, n.bp, n.Hpm, n.Hmm, n.bm))
    mf = marg_feat.cpu().numpy()
    Hmm_inv = np.where((np.abs(Hmm) > 1e-30) & mf, 1.0 /
                       np.where(np.abs(Hmm) > 1e-30, Hmm, 1.0), 0.0)
    tempH = Hpm * Hmm_inv[None, :]
    Hpp = Hpp - tempH @ Hpm.T
    bp = bp - tempH @ bm
    perm = _perm_np(P, 0)
    return _finalize_np(Hpp[perm][:, perm], bp[perm], P)


def _eigh_schur_np(H, b, n_keep):
    Amm = 0.5 * (H[n_keep:, n_keep:] + H[n_keep:, n_keep:].T)
    w, V = np.linalg.eigh(Amm)
    w_inv = np.where(w > EPS, 1.0 / np.where(w > EPS, w, 1.0), 0.0)
    Amm_inv = (V * w_inv[None, :]) @ V.T
    tempB = H[:n_keep, n_keep:] @ Amm_inv
    return (H[:n_keep, :n_keep] - tempB @ H[n_keep:, :n_keep],
            b[:n_keep] - tempB @ b[n_keep:])


def _sqrt_form_np(H, b):
    w, V = np.linalg.eigh(H)
    S = np.where(w > EPS, w, 0.0)
    S_inv = np.where(w > EPS, 1.0 / np.where(w > EPS, w, 1.0), 0.0)
    Jt_inv = np.sqrt(S_inv)[:, None] * V.T
    err = -(Jt_inv @ b)
    J = np.sqrt(S)[:, None] * V.T
    H_clean = J.T @ J
    H_clean = np.where(np.abs(H_clean) > 1e-9, H_clean, 0.0)
    return Jt_inv, err, H_clean


def _finalize_np(H_perm, b_perm, P):
    n_keep = P - 15
    H_new, b_new = _eigh_schur_np(H_perm, b_perm, n_keep)
    Jt_inv, err, H_clean = _sqrt_form_np(H_new, b_new)
    Hp = np.zeros((P, P))
    bp = np.zeros(P)
    errp = np.zeros(P)
    Jtp = np.zeros((P, P))
    Hp[:n_keep, :n_keep] = H_clean
    bp[:n_keep] = b_new
    errp[:n_keep] = err
    Jtp[:n_keep, :n_keep] = Jt_inv
    return Hp, bp, errp, Jtp


def _perm_np(P, k):
    i0 = 6 + 15 * k
    return np.asarray(list(range(0, i0)) + list(range(i0 + 15, P)) +
                      list(range(i0, i0 + 15)), np.int64)


def marginalize_new_host(H_prior: np.ndarray, b_prior: np.ndarray):
    """Marginalize frame W-1 out of the prior only (MargNewFrame,
    estimator.cpp:830-901 — the problem there contains no edges)."""
    P = H_prior.shape[0]
    W1 = (P - 6) // 15
    perm = _perm_np(P, W1 - 2)
    H_perm = np.asarray(H_prior, np.float64)[perm][:, perm]
    b_perm = np.asarray(b_prior, np.float64)[perm]
    return _finalize_np(H_perm, b_perm, P)


def finalize_old_from_blocks(marg_Hpp, marg_bp):
    """Host-f64 prior chain from frame_step's marg subproblem blocks
    (landmarks already Schur-eliminated on the device): permute the
    evicted frame-0 block to the bottom-right, eigh-eliminate it, and
    recover the sqrt form.  Returns host float64 (Hp, bp, errp, Jtp)."""
    P = marg_Hpp.shape[0]
    perm = _perm_np(P, 0)
    H_perm = np.asarray(marg_Hpp, np.float64)[perm][:, perm]
    b_perm = np.asarray(marg_bp, np.float64)[perm]
    return _finalize_np(H_perm, b_perm, P)
