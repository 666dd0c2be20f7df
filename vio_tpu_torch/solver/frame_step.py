"""One estimator frame on the device: preintegrate → LM solve → yaw-gauge
re-fix → outlier errors → marginalization Hessian, in ONE call.

Port of ``vio_tpu/solver/frame_step.py`` (reference per-frame flow:
vins-mono/src/estimator.cpp:492-503 solveOdometry → :549-600 double2vector
gauge re-fix → :1075-1143 backendOptimization/marginalization).  The JAX
version is one jitted program; here it is one loop program
(``_frame_fns``) on one of ``solver/graph.py``'s executors.
``frame_step`` runs it on the eager loop (the CPU's path, and the card's
reference): it takes the raw host arrays, uploads them, and returns a
``FrameOut`` of device tensors that ``fetch`` brings to the host in one
copy.  ``frame_step_graphed`` replays the same functions as captured CUDA
graphs, cached by ``frame_key``, what ``jax.jit`` holds static; it is the
estimator's path on the card.

The marginalization prior CHAIN runs on the host in float64
(solver/marginalize.py); this call only produces the marg subproblem's
landmark-eliminated (Hpp, bp) at the gauge-fixed solution.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import factors, imu
from ..utils import lie
from . import graph, lm
from . import window as W


class FrameOut(NamedTuple):
    states: W.WindowStates      # gauge-fixed solution
    b_prior: torch.Tensor       # first-order-updated prior rhs
    err_prior: torch.Tensor
    chi2: torch.Tensor
    chi2_init: torch.Tensor
    iterations: torch.Tensor    # () int64
    lam: torch.Tensor
    feat_errs: torch.Tensor     # (F,) mean reproj error per feature
    marg_Hpp: torch.Tensor      # (P, P) marg subproblem, landmarks eliminated
    marg_bp: torch.Tensor       # (P,)
    reads: int = 0              # the graphed loop's host reads of its condition


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


class FrameKey(NamedTuple):
    """What a frame's captured graphs are specialised on: ``vio_tpu``'s
    static arguments (``vio_tpu/solver/frame_step.py:72``), the shapes
    (window slots W1, feature slots F, IMU capacity M), dtype and device."""
    max_iter: int
    fix_ext: bool
    loss_delta: float
    n_obs: int | None
    marg_old: bool
    exact_noise: bool
    W1: int
    F: int
    M: int
    dtype: torch.dtype
    device: torch.device


def frame_key(states, dts, max_iter: int = 10, fix_ext: bool = True,
              loss_delta: float = 1.0, n_obs: int | None = None,
              marg_old: bool = True, exact_noise: bool = True,
              *, device, dtype) -> FrameKey:
    """The cache key of a frame whose window ``states`` and IMU buffers
    ``dts`` (W, M) are given (host arrays)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    W1, F = len(states.Ps), len(states.inv_dep)
    return FrameKey(int(max_iter), bool(fix_ext), float(loss_delta),
                    None if n_obs is None else int(n_obs), bool(marg_old),
                    bool(exact_noise), W1, F, int(np.shape(dts)[-1]), dtype, device)


def _factors(states: W.WindowStates, dts, accs, gyrs, mask, acc0, gyr0, imu_valid,
             pts_i, pts_j, start, obs_mask, feat_valid, H_prior, b_prior,
             err_prior, Jt_prior_inv, g, noise_diag, proj_sqrt_info,
             exact_noise: bool) -> W.WindowFactors:
    """Batched preintegration at the current start-frame biases, and the
    window's factors (device tensors in, device tensors out)."""
    W1 = states.Ps.shape[0]
    st = imu.preintegrate_batch(dts, accs, gyrs, mask, acc0, gyr0,
                                states.Bas[:W1 - 1], states.Bgs[:W1 - 1],
                                noise_diag, exact_noise)
    eye15 = torch.eye(15, dtype=states.Ps.dtype, device=states.Ps.device)
    cov = torch.where(imu_valid[:, None, None], st.covariance, eye15)
    terms = factors.ImuFactorTerms.from_state(st._replace(covariance=cov))
    return W.WindowFactors(
        imu_terms=terms, imu_valid=imu_valid,
        pts_i=pts_i, pts_j=pts_j, start=start, obs_mask=obs_mask,
        feat_valid=feat_valid, H_prior=H_prior, b_prior=b_prior,
        err_prior=err_prior, Jt_prior_inv=Jt_prior_inv, g=g,
        proj_sqrt_info=proj_sqrt_info)


def _finish(states: W.WindowStates, f: W.WindowFactors, solved: W.WindowStates,
            b_out, err_out, loss_delta: float, n_obs: int | None,
            marg_old: bool):
    """After the solve: the yaw-gauge re-fix, the per-feature outlier
    errors and the marginalization subproblem.  Returns (fixed states,
    errs, marg_Hpp, marg_bp)."""
    W1 = states.Ps.shape[0]
    kw = dict(dtype=states.Ps.dtype, device=states.Ps.device)

    # ---- yaw-gauge re-fix ----
    fixed = _gauge_fix(states.Ps, states.Qs, solved)

    # ---- per-feature outlier errors at the solution ----
    errs = W.feature_reproj_errors(fixed, f)

    # ---- marginalization subproblem at the gauge-fixed states ----
    P = W.num_pose_params(W1 - 1)
    if marg_old:
        first = torch.arange(W1 - 1, device=kw["device"]) == 0
        f_m = f._replace(feat_valid=f.feat_valid & (f.start == 0),
                         imu_valid=f.imu_valid & first,
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
        marg_Hpp = torch.zeros((P, P), **kw)
        marg_bp = torch.zeros((P,), **kw)
    return fixed, errs, marg_Hpp, marg_bp


def _frame_fns(key: FrameKey):
    """The head, chunk and tail of a frame's loop; the inputs are
    frame_step's array arguments, the states' leaves first."""
    n_states = len(W.WindowStates._fields)

    def begin(views):
        states = W.WindowStates(*views[:n_states])
        f = _factors(states, *views[n_states:], key.exact_noise)
        s, p, chi2_init = lm.start(states, f, key.max_iter, key.fix_ext,
                                   key.loss_delta, key.n_obs)
        return s, (states, p, chi2_init)

    def tail(s, aux):
        states, p, chi2_init = aux
        fixed, errs, marg_Hpp, marg_bp = _finish(
            states, p.f, s.states, s.b_prior, s.err_prior, key.loss_delta,
            key.n_obs, key.marg_old)
        return [*fixed, s.b_prior, s.err_prior, s.chi, chi2_init, s.it, s.lam,
                errs, marg_Hpp, marg_bp]

    return graph.loop_fns(begin, lambda s, aux, k: lm.attempts(s, aux[1], k),
                          lambda s, aux: lm.live(s, key.max_iter), tail)


def _loop(loop, states, arrays, kw):
    """The executor ``loop`` of a frame's program (``graph.EagerLoop`` or
    ``graph.loop_graph``), its inputs uploaded: ``states`` and the array
    arguments, ``kw`` frame_step's keywords."""
    key = frame_key(states, arrays[0], **kw)
    host = [*states, *arrays]
    g = loop(key, [graph.spec_of(a, kw["dtype"]) for a in host], *_frame_fns(key), key.device)
    g.inputs.upload(host)
    return g


def _frame_out(out, reads: int = 0) -> FrameOut:
    """The tail's outputs as a ``FrameOut``: tensors (``iterations`` 0-d)
    or host arrays (``iterations`` an int)."""
    n = len(W.WindowStates._fields)
    b_prior, err_prior, chi2, chi2_init, it, lam, errs, mH, mb = out[n:]
    return FrameOut(states=W.WindowStates(*out[:n]), b_prior=b_prior, err_prior=err_prior,
                    chi2=chi2, chi2_init=chi2_init,
                    iterations=it if torch.is_tensor(it) else int(it), lam=lam,
                    feat_errs=errs, marg_Hpp=mH, marg_bp=mb, reads=reads)


def frame_step(states: W.WindowStates,
               dts, accs, gyrs, mask, acc0, gyr0, imu_valid,
               pts_i, pts_j, start, obs_mask, feat_valid,
               H_prior, b_prior, err_prior, Jt_prior_inv,
               g, noise_diag, proj_sqrt_info,
               max_iter: int = 10, fix_ext: bool = True,
               loss_delta: float = 1.0, n_obs: int | None = None,
               marg_old: bool = True, exact_noise: bool = True,
               *, device, dtype) -> FrameOut:
    """One full estimator frame, eagerly: the frame's loop on
    ``graph.EagerLoop``.  ``states`` and every array argument are raw
    host data (numpy): one upload per argument, one host read of the
    loop's condition per ``graph.CHUNK`` attempts, a ``FrameOut`` of
    device tensors (``reads`` 0)."""
    arrays = (dts, accs, gyrs, mask, acc0, gyr0, imu_valid, pts_i, pts_j, start, obs_mask,
              feat_valid, H_prior, b_prior, err_prior, Jt_prior_inv, g, noise_diag,
              proj_sqrt_info)
    kw = dict(max_iter=max_iter, fix_ext=fix_ext, loss_delta=loss_delta, n_obs=n_obs,
              marg_old=marg_old, exact_noise=exact_noise, device=device, dtype=dtype)
    return _frame_out(_loop(graph.EagerLoop, states, arrays, kw).run_tensors())


def frame_step_graphed(states: W.WindowStates, *arrays,
                       max_iter: int = 10, fix_ext: bool = True,
                       loss_delta: float = 1.0, n_obs: int | None = None,
                       marg_old: bool = True, exact_noise: bool = True,
                       device, dtype) -> FrameOut:
    """``frame_step`` on the card from its captured graphs (captured at a
    key's first frame): one copy of every input from one pinned buffer,
    the replays, one copy of every output back.  Takes frame_step's
    arguments; returns the ``FrameOut`` that ``fetch`` would, as host
    float64 arrays (``iterations`` an int), with the loop's host reads of
    its condition in ``reads``.  Raises where there is no
    CUDA device; there is no eager fallback."""
    lg = _loop(graph.loop_graph, states, arrays,
               dict(max_iter=max_iter, fix_ext=fix_ext, loss_delta=loss_delta, n_obs=n_obs,
                    marg_old=marg_old, exact_noise=exact_noise, device=device, dtype=dtype))
    out = lg.run()
    return _frame_out(out, lg.reads)


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
                    chi2=chi2, chi2_init=chi2_init, iterations=int(out.iterations),
                    lam=lam, feat_errs=errs, marg_Hpp=mH, marg_bp=mb)
