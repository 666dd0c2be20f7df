"""One estimator frame on the device: preintegrate → LM solve → yaw-gauge
re-fix → outlier errors → marginalization Hessian, in ONE call.

Port of ``vio_tpu/solver/frame_step.py`` (reference per-frame flow:
vins-mono/src/estimator.cpp:492-503 solveOdometry → :549-600 double2vector
gauge re-fix → :1075-1143 backendOptimization/marginalization).  The JAX
version is one jitted program; here it is one plain function that takes
the raw host arrays, uploads them once, and returns a ``FrameOut`` of
device tensors that ``fetch`` brings to the host in one copy.

The marginalization prior CHAIN runs on the host in float64
(solver/marginalize.py); this call only produces the marg subproblem's
landmark-eliminated (Hpp, bp) at the gauge-fixed solution.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import factors, imu
from ..convert import to_tensor
from ..utils import lie
from . import lm
from . import window as W


class FrameOut(NamedTuple):
    states: W.WindowStates      # gauge-fixed solution
    b_prior: torch.Tensor       # first-order-updated prior rhs
    err_prior: torch.Tensor
    chi2: torch.Tensor
    chi2_init: torch.Tensor
    iterations: int
    lam: torch.Tensor
    feat_errs: torch.Tensor     # (F,) mean reproj error per feature
    marg_Hpp: torch.Tensor      # (P, P) marg subproblem, landmarks eliminated
    marg_bp: torch.Tensor       # (P,)


def _gauge_fix(origin_Ps, origin_Qs, s: W.WindowStates) -> W.WindowStates:
    """Yaw-gauge re-fix (double2vector, estimator.cpp:549-600): rotate the
    solved window so frame 0 keeps its pre-solve yaw and position.
    Gimbal-lock (pitch ≈ ±90°) falls back to full rotation transfer,
    branch-free via torch.where."""
    R0_orig = lie.quat_to_mat(origin_Qs[0])
    R0_new = lie.quat_to_mat(s.Qs[0])
    origin_ypr = lie.mat_to_ypr(R0_orig)
    opt_ypr = lie.mat_to_ypr(R0_new)
    y_diff = origin_ypr[0] - opt_ypr[0]
    zero = torch.zeros_like(y_diff)
    rot_diff = lie.ypr_to_mat(torch.stack([y_diff, zero, zero]))
    gimbal = (torch.abs(torch.abs(origin_ypr[1]) - 90.0) < 1.0) | \
             (torch.abs(torch.abs(opt_ypr[1]) - 90.0) < 1.0)
    rot_diff = torch.where(gimbal, R0_orig @ R0_new.T, rot_diff)

    q_diff = lie.mat_to_quat(rot_diff)
    Ps = (s.Ps - s.Ps[0]) @ rot_diff.T + origin_Ps[0]
    Qs = lie.quat_normalize(lie.quat_mul(q_diff.expand(s.Qs.shape), s.Qs))
    Vs = s.Vs @ rot_diff.T
    return s._replace(Ps=Ps, Qs=Qs, Vs=Vs)


def frame_step(states: W.WindowStates,
               dts, accs, gyrs, mask, acc0, gyr0, imu_valid,
               pts_i, pts_j, start, obs_mask, feat_valid,
               H_prior, b_prior, err_prior, Jt_prior_inv,
               g, noise_diag, proj_sqrt_info,
               max_iter: int = 10, fix_ext: bool = True,
               loss_delta: float = 1.0, n_obs: int | None = None,
               marg_old: bool = True, exact_noise: bool = True,
               *, device, dtype) -> FrameOut:
    """One full estimator frame.  ``states`` and every array argument are
    raw host data (numpy): one upload, one device call, one fetch."""
    up = lambda x: to_tensor(x, device, dtype)   # noqa: E731
    states = W.WindowStates(*map(up, states))
    W1 = states.Ps.shape[0]

    # ---- batched preintegration at the current start-frame biases ----
    st = imu.preintegrate_batch(up(dts), up(accs), up(gyrs), up(mask),
                                up(acc0), up(gyr0),
                                states.Bas[:W1 - 1], states.Bgs[:W1 - 1],
                                up(noise_diag), exact_noise)
    imu_valid = up(imu_valid)
    eye15 = torch.eye(15, dtype=dtype, device=device)
    cov = torch.where(imu_valid[:, None, None], st.covariance, eye15)
    terms = factors.ImuFactorTerms.from_state(st._replace(covariance=cov))

    start = up(start)
    feat_valid = up(feat_valid)
    f = W.WindowFactors(
        imu_terms=terms, imu_valid=imu_valid,
        pts_i=up(pts_i), pts_j=up(pts_j), start=start, obs_mask=up(obs_mask),
        feat_valid=feat_valid, H_prior=up(H_prior), b_prior=up(b_prior),
        err_prior=up(err_prior), Jt_prior_inv=up(Jt_prior_inv), g=up(g),
        proj_sqrt_info=up(proj_sqrt_info))

    # ---- LM solve ----
    solved, b_out, err_out, stats = lm.solve_window(
        states, f, max_iter=max_iter, fix_ext=fix_ext,
        loss_delta=loss_delta, n_obs=n_obs)

    # ---- yaw-gauge re-fix ----
    fixed = _gauge_fix(states.Ps, states.Qs, solved)

    # ---- per-feature outlier errors at the solution ----
    errs = W.feature_reproj_errors(fixed, f)

    # ---- marginalization subproblem at the gauge-fixed states ----
    P = W.num_pose_params(W1 - 1)
    if marg_old:
        first = torch.arange(W1 - 1, device=device) == 0
        f_m = f._replace(feat_valid=feat_valid & (start == 0),
                         imu_valid=imu_valid & first,
                         b_prior=b_out, err_prior=err_out)
        n = W.assemble(fixed, f_m, fix_ext=False, loss_delta=loss_delta,
                       n_obs=n_obs)
        live = (torch.abs(n.Hmm) > 1e-30) & f_m.feat_valid
        Hmm_inv = torch.where(live, 1.0 / torch.where(
            torch.abs(n.Hmm) > 1e-30, n.Hmm, torch.ones_like(n.Hmm)),
            torch.zeros_like(n.Hmm))
        tempH = n.Hpm * Hmm_inv[None, :]
        marg_Hpp = n.Hpp - tempH @ n.Hpm.T
        marg_bp = n.bp - tempH @ n.bm
    else:
        marg_Hpp = torch.zeros((P, P), dtype=dtype, device=device)
        marg_bp = torch.zeros((P,), dtype=dtype, device=device)

    return FrameOut(states=fixed, b_prior=b_out, err_prior=err_out,
                    chi2=stats["chi2"], chi2_init=stats["chi2_init"],
                    iterations=stats["iterations"], lam=stats["lam"],
                    feat_errs=errs, marg_Hpp=marg_Hpp, marg_bp=marg_bp)


def fetch(out: FrameOut) -> FrameOut:
    """Bring a FrameOut to the host as float64 numpy in one device-to-host
    copy (the JAX estimator's single ``jax.device_get``)."""
    leaves = list(out.states) + [out.b_prior, out.err_prior, out.chi2,
                                 out.chi2_init, out.lam, out.feat_errs,
                                 out.marg_Hpp, out.marg_bp]
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves]).cpu().numpy()
    parts, o = [], 0
    for t in leaves:
        parts.append(flat[o:o + t.numel()].reshape(tuple(t.shape)))
        o += t.numel()
    n = len(out.states)
    s = W.WindowStates(*parts[:n])
    b_prior, err_prior, chi2, chi2_init, lam, errs, mH, mb = parts[n:]
    return FrameOut(states=s, b_prior=b_prior, err_prior=err_prior,
                    chi2=chi2, chi2_init=chi2_init, iterations=out.iterations,
                    lam=lam, feat_errs=errs, marg_Hpp=mH, marg_bp=mb)
