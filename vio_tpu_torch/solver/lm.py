"""Levenberg-Marquardt (Nielsen) solver for the sliding window.

Port of ``vio_tpu/solver/lm.py`` (reference: vins-mono/src/backend/
problem.cc:169-250 outer/inner loops, :394-451 SolveLinearSystem with
landmark Schur, :497-522 ComputeLambdaInitLM, :541-573 IsGoodStepInLM).
The JAX ``lax.while_loop`` body becomes ``_attempt``: one λ-attempt as a
transition of the device-resident ``LMState``, its ``lax.cond``
accept/reject turned into ``torch.where`` selects on every leaf and every
update gated by the loop's condition, so an attempt made after the loop
has ended changes no bit.  ``solve_window`` makes a solve one program of
those attempts and hands it to ``solver/graph.py``'s executor: captured
CUDA graphs replayed on the card, the same functions op by op on the
CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from . import graph
from . import window as W
from ..ops import linsolve
from ..parallel.collective import _psum_hi, all_reduce_system
from ..utils.tree import select


class LMState(NamedTuple):
    """The λ-loop's carry (``vio_tpu/solver/lm.py:22``), all on the device:
    the current states and prior rhs, their normal equations and reduced
    system, the damping and the Nielsen counters as 0-d tensors."""
    states: W.WindowStates
    b_prior: torch.Tensor
    err_prior: torch.Tensor
    normal: W.Normal
    S: torch.Tensor          # (P, P) landmark-reduced pose system
    rhs: torch.Tensor        # (P,)
    Hmm_inv: torch.Tensor    # (F,)
    lam: torch.Tensor
    ni: torch.Tensor
    chi: torch.Tensor
    last_chi: torch.Tensor
    it: torch.Tensor         # int64
    false_cnt: torch.Tensor  # int64
    stop: torch.Tensor       # bool


class Problem(NamedTuple):
    """What every attempt of one solve reads and never changes."""
    f: W.WindowFactors
    imu_infos: torch.Tensor  # (W, 15, 15), inverted once per solve
    max_iter: int
    fix_ext: bool
    loss_delta: float
    n_obs: int | None
    group: object = None     # torch.distributed group, or None
    wire: list | None = None  # bytes of each all_reduce, appended


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


def _assemble(p: Problem, states, f):
    return W.assemble(states, f, fix_ext=p.fix_ext, loss_delta=p.loss_delta,
                      imu_infos=p.imu_infos, n_obs=p.n_obs)


def _reduced(p: Problem, normal: W.Normal, extra):
    """The reduced system, summed with chi² and ``extra`` over the group."""
    S, rhs, Hmm_inv = reduce_camera_system(normal, p.f.feat_valid)
    return (*all_reduce_system(S, rhs, normal.chi2, extra, p.group, p.wire), Hmm_inv)


def start(states: W.WindowStates, f: W.WindowFactors, max_iter: int = 10,
          fix_ext: bool = True, loss_delta: float = 1.0, n_obs: int | None = None,
          group=None, wire=None):
    """The first assembly and λ0: returns (LMState, Problem, chi2_init)."""
    p = Problem(f, W._imu_infos(f), max_iter, fix_ext, loss_delta, n_obs, group,
                [] if wire is None else wire)
    normal = _assemble(p, states, f)
    # λ0 = 1e-5 · min(max |diag|, 5e10) over the FULL diagonal (poses+landmarks)
    S, rhs, chi, diag, Hmm_inv = _reduced(p, normal, torch.diagonal(normal.Hpp))
    hmm_max = _psum_hi(torch.max(torch.abs(normal.Hmm)), group, dist.ReduceOp.MAX)
    lam = 1e-5 * torch.clamp(torch.maximum(torch.max(torch.abs(diag)), hmm_max), max=5e10)
    zero = torch.zeros((), dtype=torch.int64, device=chi.device)
    s = LMState(states=states, b_prior=f.b_prior, err_prior=f.err_prior,
                normal=normal, S=S, rhs=rhs, Hmm_inv=Hmm_inv, lam=lam,
                ni=torch.full_like(chi, 2.0), chi=chi,
                last_chi=torch.full_like(chi, 1e20), it=zero, false_cnt=zero,
                stop=torch.zeros((), dtype=torch.bool, device=chi.device))
    return s, p, chi


def live(s: LMState, max_iter: int):
    """The loop's condition (``vio_tpu/solver/lm.py:82``), a 0-d bool."""
    return ~s.stop & (s.it < max_iter)


def _attempt(s: LMState, p: Problem) -> LMState:
    """One λ-attempt (the JAX loop's ``body``, ``vio_tpu/solver/lm.py:85-128``)
    with no host read: accept and reject are both computed and selected
    leaf by leaf, and both are masked by ``live``, so an attempt after the
    loop has ended returns ``s`` bit for bit.  A rejected candidate's chi²,
    ρ and α may be non-finite; the selects keep the old leaves then."""
    f = p.f
    go = live(s, p.max_iter)
    dx_p, dx_m = _solve_reduced(s.normal, s.S, s.rhs, s.Hmm_inv, s.lam)
    cand = W.apply_delta(s.states, dx_p, dx_m)

    # first-order prior update (problem.cc:466-478)
    cand_b_prior = s.b_prior - f.H_prior @ dx_p
    cand_err = -(f.Jt_prior_inv @ cand_b_prior)

    # One assembly per attempt: its chi2 IS the candidate cost, and on
    # accept the normal equations are already built for the next step.
    normal_cand = _assemble(p, cand, f._replace(b_prior=cand_b_prior, err_prior=cand_err))
    # dxᵀ(λdx + b) with the PRE-Schur gradient: under a group bp is this
    # rank's partial, so dx_pᵀbp rides the reduce with the landmark terms
    dot = torch.dot(dx_p, s.normal.bp) + torch.dot(dx_m, s.lam * dx_m + s.normal.bm)
    S_c, rhs_c, temp_chi, dot, Hmm_inv_c = _reduced(p, normal_cand, dot[None])
    scale = 0.5 * (s.lam * torch.dot(dx_p, dx_p) + dot[0]) + 1e-6
    rho = (s.chi - temp_chi) / scale
    good = (rho > 0) & torch.isfinite(temp_chi)
    acc = go & good
    rej = go & ~good

    # accept: Nielsen's λ shrink, the candidate becomes the state
    alpha = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, max=2.0 / 3.0)
    lam_acc = s.lam * torch.clamp(alpha, min=1.0 / 3.0)
    stop_acc = (s.last_chi - temp_chi) < 1e-5
    # reject: λ grows; ten rejects in a row count as an iteration
    overflow = s.false_cnt + 1 >= 10
    stop_rej = overflow & ((s.last_chi - s.chi) < 1e-5)
    step = acc | (rej & overflow)       # what counts as an iteration

    moved = select(acc, (cand, cand_b_prior, cand_err, normal_cand, S_c, rhs_c,
                         Hmm_inv_c, temp_chi),
                   (s.states, s.b_prior, s.err_prior, s.normal, s.S, s.rhs,
                    s.Hmm_inv, s.chi))
    states, b_prior, err_prior, normal, S, rhs, Hmm_inv, chi = moved
    lam = torch.where(acc, lam_acc, torch.where(rej, s.lam * s.ni, s.lam))
    ni = torch.where(acc, torch.full_like(s.ni, 2.0),
                     torch.where(rej, s.ni * 2.0, s.ni))
    last_chi = torch.where(acc, temp_chi,
                           torch.where(rej & overflow, s.chi, s.last_chi))
    it = s.it + step.to(s.it.dtype)
    false_cnt = torch.where(step, torch.zeros_like(s.false_cnt),
                            s.false_cnt + rej.to(s.false_cnt.dtype))
    stop = torch.where(acc, stop_acc, torch.where(rej, stop_rej, s.stop))
    return LMState(states=states, b_prior=b_prior, err_prior=err_prior,
                   normal=normal, S=S, rhs=rhs, Hmm_inv=Hmm_inv, lam=lam, ni=ni,
                   chi=chi, last_chi=last_chi, it=it, false_cnt=false_cnt, stop=stop)


def attempts(s: LMState, p: Problem, k: int) -> LMState:
    """``k`` attempts in a row, with no host read."""
    for _ in range(k):
        s = _attempt(s, p)
    return s


def _unflatten(template, it):
    if isinstance(template, tuple):
        parts = [_unflatten(t, it) for t in template]
        return type(template)(*parts) if hasattr(template, "_fields") else tuple(parts)
    return next(it)


def solve_with(loop, states: W.WindowStates, f: W.WindowFactors, max_iter: int = 10,
               fix_ext: bool = True, loss_delta: float = 1.0, n_obs: int | None = None,
               group=None, chunk: int | None = None):
    """``solve_window`` on the executor ``loop`` (``graph.loop``, or
    ``graph.EagerLoop``, the card's twin of a capture), ``chunk``
    attempts between two reads of the loop's condition (``graph.CHUNK``
    without it)."""
    tree = (states, f)

    def begin(views):
        s, p, chi2_init = start(*_unflatten(tree, iter(views)), max_iter, fix_ext, loss_delta,
                                n_obs, group, wire)
        return s, (p, chi2_init)

    leaves = graph._leaves(tree)
    device = leaves[0].device
    specs = [(tuple(t.shape), t.dtype) for t in leaves]
    key = ("solve_window", int(max_iter), bool(fix_ext), float(loss_delta),
           n_obs, tuple(specs), device)
    wire = []
    scalar = states.Ps.new_empty(())
    out = [*map(torch.empty_like, (*states, f.b_prior, f.err_prior, scalar, scalar, scalar)),
           torch.empty((), dtype=torch.int64, device=device)]
    fns = graph.loop_fns(begin, lambda s, aux, k: attempts(s, aux[0], k),
                         lambda s, aux: live(s, max_iter), lambda s, aux: [s.it])
    g = loop(key, specs, *fns, device, k=chunk,
             kept=lambda s, aux: [*s.states, s.b_prior, s.err_prior, s.chi, aux[1], s.lam, s.it])
    g.inputs.load(leaves)
    g.run(keep=out)
    n = len(states)
    b_prior, err_prior, chi, chi2_init, lam, it = out[n:]
    stats = dict(chi2=chi, iterations=it, lam=lam, chi2_init=chi2_init,
                 attempts=g.attempts, reads=g.reads,
                 allreduces=len(wire), allreduce_bytes=wire[-1] if wire else 0)
    return type(states)(*out[:n]), b_prior, err_prior, stats


def solve_window(states: W.WindowStates, f: W.WindowFactors,
                 max_iter: int = 10, fix_ext: bool = True,
                 loss_delta: float = 1.0, n_obs: int | None = None,
                 group=None, chunk: int | None = None):
    """Run LM on the window problem.  Returns (states, b_prior, err_prior,
    stats dict), all on the problem's device.  b_prior/err_prior carry the
    first-order prior update accumulated over accepted steps
    (problem.cc:466-478).  n_obs: optional live-observation cap — see
    window.assemble.

    One program on the executor ``graph.loop`` chooses (``solve_with``):
    the key's captured graphs on the card, the eager loop on the CPU;
    ``chunk`` attempts (``graph.CHUNK`` without it) between two host
    reads of the loop's condition.  Attempts past the end change nothing,
    so every ``chunk`` gives the same bits.  stats: chi2, lam, chi2_init
    and ``iterations`` as 0-d device tensors, ``attempts`` (made, wasted
    ones included) and ``reads`` as ints.

    ``group``: a ``torch.distributed`` process group over which the
    problem's features are split (``parallel.sharded.shard_problem``); a
    group's collectives cannot be captured, so the loop then runs eagerly.
    Each assembly's reduced system, chi² and the gain ratio's landmark
    terms are then summed over its ranks in ONE all_reduce inside the
    attempt; the damped pose solve is replicated, so every rank takes the
    same decisions.  stats count the all_reduces and their bytes (0
    without a group)."""
    return solve_with(graph.loop if group is None else graph.EagerLoop, states, f, max_iter,
                      fix_ext, loss_delta, n_obs, group, chunk)
