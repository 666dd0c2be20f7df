"""Levenberg-Marquardt (Nielsen) solver for the sliding window.

Port of ``vio_tpu/solver/lm.py`` (reference: vins-mono/src/backend/
problem.cc:169-250 outer/inner loops, :394-451 SolveLinearSystem with
landmark Schur, :497-522 ComputeLambdaInitLM, :541-573 IsGoodStepInLM).
The JAX ``lax.while_loop`` over λ-attempts with a ``lax.cond`` accept/reject
becomes a Python loop: each attempt reads its accept and stop decisions on
the host, one device-to-host sync per attempt.  The scalars λ, ν and the
chi² values stay device tensors in the solve dtype, as in the JAX loop.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from . import window as W
from ..ops import linsolve
from ..parallel.global_ba import _psum_hi, all_reduce_system


def reduce_camera_system(normal: W.Normal, feat_valid):
    """Landmark Schur elimination (problem.cc:409-433): the reduced pose
    system, its right-hand side and diag(Hmm)⁻¹."""
    Hmm = normal.Hmm
    zero = torch.zeros_like(Hmm)
    Hmm_inv = torch.where(torch.abs(Hmm) > 1e-30, 1.0 / Hmm, zero)
    Hmm_inv = torch.where(feat_valid, Hmm_inv, zero)
    tempH = normal.Hpm * Hmm_inv[None, :]                    # Hpm · Hmm⁻¹
    return normal.Hpp - tempH @ normal.Hpm.T, normal.bp - tempH @ normal.bm, Hmm_inv


def _solve_reduced(normal: W.Normal, S, rhs, Hmm_inv, lam):
    """Damped pose solve of the reduced system + back-substitution
    (problem.cc:434-446).  λ is added to the pose block diagonal only,
    exactly like the reference."""
    P = S.shape[0]
    dx_p = linsolve.spd_solve(S + lam * torch.eye(P, dtype=S.dtype, device=S.device), rhs)
    return dx_p, Hmm_inv * (normal.bm - normal.Hpm.T @ dx_p)


def schur_solve(normal: W.Normal, lam, feat_valid):
    """Landmark Schur elimination + damped pose solve + back-substitution
    (problem.cc:409-446)."""
    return _solve_reduced(normal, *reduce_camera_system(normal, feat_valid), lam)


def solve_window(states: W.WindowStates, f: W.WindowFactors,
                 max_iter: int = 10, fix_ext: bool = True,
                 loss_delta: float = 1.0, n_obs: int | None = None,
                 group=None):
    """Run LM on the window problem.  Returns (states, b_prior, err_prior,
    stats dict).  b_prior/err_prior carry the first-order prior update
    accumulated over accepted steps (problem.cc:466-478).  n_obs: optional
    live-observation cap — see window.assemble.

    ``group``: a ``torch.distributed`` process group over which the
    problem's features are split (``parallel.sharded.shard_problem``).
    Each assembly's reduced system, chi² and the gain ratio's landmark
    terms are then summed over its ranks in ONE all_reduce; the damped
    pose solve is replicated, so every rank takes the same decisions.
    stats count the all_reduces and their bytes (0 without a group)."""
    imu_infos = W._imu_infos(f)
    wire = []

    def assemble(s, f_):
        return W.assemble(s, f_, fix_ext=fix_ext, loss_delta=loss_delta,
                          imu_infos=imu_infos, n_obs=n_obs)

    def reduced(n, extra):
        S, rhs, Hmm_inv = reduce_camera_system(n, f.feat_valid)
        return (*all_reduce_system(S, rhs, n.chi2, extra, group, wire), Hmm_inv)

    normal = assemble(states, f)
    # λ0 = 1e-5 · min(max |diag|, 5e10) over the FULL diagonal (poses+landmarks)
    S, rhs, chi, diag, Hmm_inv = reduced(normal, torch.diagonal(normal.Hpp))
    hmm_max = _psum_hi(torch.max(torch.abs(normal.Hmm)), group, dist.ReduceOp.MAX)
    lam = 1e-5 * torch.clamp(torch.maximum(torch.max(torch.abs(diag)), hmm_max), max=5e10)
    chi2_init = chi
    ni = torch.full_like(chi, 2.0)
    last_chi = torch.full_like(chi, 1e20)
    b_prior, err_prior = f.b_prior, f.err_prior
    it = 0
    false_cnt = 0
    stop = False

    while not stop and it < max_iter:
        dx_p, dx_m = _solve_reduced(normal, S, rhs, Hmm_inv, lam)
        cand = W.apply_delta(states, dx_p, dx_m)

        # first-order prior update (problem.cc:466-478)
        cand_b_prior = b_prior - f.H_prior @ dx_p
        cand_err = -(f.Jt_prior_inv @ cand_b_prior)

        # One assembly per attempt: its chi2 IS the candidate cost, and on
        # accept the normal equations are already built for the next step.
        normal_cand = assemble(cand, f._replace(b_prior=cand_b_prior, err_prior=cand_err))
        # dxᵀ(λdx + b) with the PRE-Schur gradient: under a group bp is this
        # rank's partial, so dx_pᵀbp rides the reduce with the landmark terms
        dot = torch.dot(dx_p, normal.bp) + torch.dot(dx_m, lam * dx_m + normal.bm)
        S_c, rhs_c, temp_chi, dot, Hmm_inv_c = reduced(normal_cand, dot[None])
        scale = 0.5 * (lam * torch.dot(dx_p, dx_p) + dot[0]) + 1e-6
        rho = (chi - temp_chi) / scale
        good_t = (rho > 0) & torch.isfinite(temp_chi)
        # the attempt's only host sync: accept?, stop-if-accepted,
        # stop-if-rejected-on-overflow
        good, stop_acc, stop_rej = torch.stack([
            good_t, (last_chi - temp_chi) < 1e-5, (last_chi - chi) < 1e-5]).tolist()

        if good:
            alpha = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, max=2.0 / 3.0)
            lam = lam * torch.clamp(alpha, min=1.0 / 3.0)
            states, b_prior, err_prior = cand, cand_b_prior, cand_err
            normal, S, rhs, Hmm_inv = normal_cand, S_c, rhs_c, Hmm_inv_c
            ni = torch.full_like(ni, 2.0)
            chi = last_chi = temp_chi
            it += 1
            false_cnt = 0
            stop = stop_acc
        else:
            overflow = false_cnt + 1 >= 10
            stop = overflow and stop_rej
            lam = lam * ni
            ni = ni * 2.0
            if overflow:
                it += 1
                false_cnt = 0
                last_chi = chi
            else:
                false_cnt += 1

    stats = dict(chi2=chi, iterations=it, lam=lam, chi2_init=chi2_init,
                 allreduces=len(wire), allreduce_bytes=wire[-1] if wire else 0)
    return states, b_prior, err_prior, stats
