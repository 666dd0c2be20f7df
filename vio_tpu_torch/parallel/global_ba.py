"""Large-window / global bundle adjustment, on one device or split over the
ranks of a ``torch.distributed`` process group.

Port of ``vio_tpu/parallel/global_ba.py``: the scale-out generalization of
the sliding-window solver (the reference's window is fixed at 11
keyframes, vins-mono/include/parameters.h:35) — hundreds of keyframes and
tens of thousands to millions of landmarks solved together.

Structure:
- poses (N, 3)+(N, 4), 6-dof local updates; landmarks are inverse depths
  (M,) anchored in a host frame, so the landmark Hessian block is
  DIAGONAL and its Schur elimination is elementwise.
- observations are a flat batch (O,): landmark index, observing frame,
  bearing; the landmark's host frame and host bearing live in (M,) tables.
- assembly scatter-adds per-observation 6-dof pose Jacobian blocks with
  ``index_add_`` (``segment_sum`` in the JAX package) into block-pair
  (N, N, 6, 6), pose-landmark (6N, M) and diagonal landmark terms.  The
  coupling block is scattered straight into its (6N, M) layout, so the
  flat (N·M, 6) tensor the JAX package reshapes is never materialised.
- the reduced camera system S = Hpp - Hpm diag(Hmm)^-1 Hpm^T is one plain
  matrix product (``torch.matmul``, TF32 off); the damped solve is
  ``linsolve.spd_solve``: the hand-written Gauss-Jordan kernel on a CUDA
  tensor up to 6N = 1024 (its blocked regime above 176 unknowns in
  float32, 127 in float64), Jacobi-PCG above.
- distributed (``solve_sharded``): observations aligned to landmark
  blocks per rank (``align_by_landmark``), so assembly AND the landmark
  Schur step are local; each LM attempt makes ONE ``all_reduce`` of the
  packed reduced system, in float64 on the wire; the damped solve is
  replicated on every rank.

The JAX ``lax.while_loop`` body (``vio_tpu/parallel/global_ba.py:226-247``)
is ``_attempt``: one λ-attempt as a transition of the device-resident
``LMState``, its ``lax.cond`` accept/reject turned into ``torch.where``
selects on every leaf and every update gated by the loop's condition, so
an attempt made after the loop has ended changes no bit (as
``solver/lm.py``'s).  A solve is one program of those attempts
(``graph_fns``) on one of ``solver/graph.py``'s executors
(``solve_with``): ``solve`` on the card replays it from captured CUDA
graphs, and the eager loop (``solve_sharded``, PCG's damped solves, the
CPU) runs it op by op, with the same host reads of the loop's condition.

Reference lineage for the math: reprojection factor edge_reprojection.cc,
Schur solve problem.cc:409-446 — re-derived at scale.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import factors
from ..device import move, resolve
from ..ops import linsolve
from ..solver import graph, pcg
from ..utils import lie
from ..utils.tree import select
from .collective import _psum_hi, all_reduce_system


class GlobalBA(NamedTuple):
    # states
    Ps: torch.Tensor        # (N, 3)
    Qs: torch.Tensor        # (N, 4)
    inv_dep: torch.Tensor   # (M,)
    # landmark tables
    host: torch.Tensor      # (M,) int64 host frame
    bearing0: torch.Tensor  # (M, 3) unit-plane bearing in host frame
    lm_valid: torch.Tensor  # (M,) bool
    # observations
    lm_idx: torch.Tensor    # (O,) int64
    frame: torch.Tensor     # (O,) int64 observing frame (!= host)
    bearing: torch.Tensor   # (O, 3)
    valid: torch.Tensor     # (O,) bool
    # config
    sqrt_info: torch.Tensor  # () projection sqrt information


class GlobalNormal(NamedTuple):
    Hpp: torch.Tensor   # (6N, 6N)
    bp: torch.Tensor    # (6N,)
    Hpm: torch.Tensor   # (6N, M)
    Hmm: torch.Tensor   # (M,)
    bm: torch.Tensor    # (M,)
    chi2: torch.Tensor  # ()


def _fixed_diag(N: int, fix_frames: int, like: torch.Tensor):
    """(6N,) unit diagonal on the fixed poses: keeps the reduced system SPD.
    (An expand, not ``repeat_interleave``, which may read its output size
    back to the host.)"""
    fixed = (torch.arange(N, device=like.device) < fix_frames).to(like.dtype)
    return fixed[:, None].expand(N, 6).reshape(6 * N)


def _assemble_terms(p: GlobalBA, N: int, M: int, fix_frames: int,
                    loss_delta: float, lm_ofs: int = 0) -> GlobalNormal:
    """The observations' normal equations over the M landmarks of p's
    tables (the whole problem, or one rank's block starting at global
    landmark lm_ofs), without the fixed poses' unit diagonal."""
    dtype, device = p.Ps.dtype, p.Ps.device
    tic = torch.zeros(3, dtype=dtype, device=device)
    qic = lie.quat_identity(dtype, device)
    inv_dep = torch.where(p.lm_valid, p.inv_dep, torch.ones_like(p.inv_dep))

    lm = torch.clamp(p.lm_idx - lm_ofs, 0, M - 1)      # local landmark index
    hi = p.host[lm]                                    # (O,) host frame per obs
    fr = p.frame
    args = (inv_dep[lm], p.Ps[hi], p.Qs[hi], p.Ps[fr], p.Qs[fr], tic, qic,
            p.bearing0[lm], p.bearing)
    r = factors.reproj_residual(*args)
    Jd, Jpi, Jpj, _ = factors.reproj_jacobians(*args)
    # r (O,2), Jd (O,2,1), Jpi/Jpj (O,2,6)

    m = (p.valid & p.lm_valid[lm] & (hi != fr)).to(dtype)
    s2 = p.sqrt_info ** 2
    e2 = s2 * torch.sum(r * r, dim=-1)
    rho0, rho1, rho2 = factors.cauchy_rho(e2, loss_delta)
    w_err = p.sqrt_info * r
    guard = (rho1 + 2.0 * rho2 * e2 > 0.0).to(dtype)
    eye2 = torch.eye(2, dtype=dtype, device=device)
    rinfo = (rho1[..., None, None] * eye2 +
             (guard * 2.0 * rho2)[..., None, None] *
             (w_err[..., :, None] * w_err[..., None, :])) * s2   # (O,2,2)
    rinfo = rinfo * m[:, None, None]
    chi2 = torch.sum(torch.where(m > 0, rho0, torch.zeros_like(rho0)))

    # fixed-frame gauge zeroing
    Jpi = Jpi * (hi >= fix_frames).to(dtype)[:, None, None]
    Jpj = Jpj * (fr >= fix_frames).to(dtype)[:, None, None]
    Jd2 = Jd[..., 0]                                              # (O,2)

    WJi = torch.einsum("ors,osa->ora", rinfo, Jpi)                # (O,2,6)
    WJj = torch.einsum("ors,osa->ora", rinfo, Jpj)
    WJd = torch.einsum("ors,os->or", rinfo, Jd2)                  # (O,2)
    # b uses drho * J^T * info * r with info = s2*I (reference MakeHessian)
    info_r = (s2 * rho1[:, None] * m[:, None]) * r                # (O,2)

    # ---- pose-pose blocks: scatter (i,i),(i,j),(j,i),(j,j) ----
    blocks = torch.cat([torch.einsum("ora,orb->oab", Jpi, WJi),
                        torch.einsum("ora,orb->oab", Jpi, WJj),
                        torch.einsum("ora,orb->oab", Jpj, WJi),
                        torch.einsum("ora,orb->oab", Jpj, WJj)], dim=0)
    segs = torch.cat([hi * N + hi, hi * N + fr, fr * N + hi, fr * N + fr])
    Hpp = torch.zeros((N * N, 6, 6), dtype=dtype, device=device).index_add_(0, segs, blocks)
    Hpp = Hpp.reshape(N, N, 6, 6).transpose(1, 2).reshape(6 * N, 6 * N)

    bp = torch.zeros((N, 6), dtype=dtype, device=device).index_add_(
        0, torch.cat([hi, fr]),
        torch.cat([-torch.einsum("ora,or->oa", Jpi, info_r),
                   -torch.einsum("ora,or->oa", Jpj, info_r)])).reshape(6 * N)

    # ---- pose-landmark coupling, scattered into its (6N, M) layout ----
    six = torch.arange(6, device=device)
    rows = torch.cat([hi, fr])[:, None] * 6 + six                 # (2O, 6)
    Hpm = torch.zeros(6 * N * M, dtype=dtype, device=device).index_add_(
        0, (rows * M + torch.cat([lm, lm])[:, None]).reshape(-1),
        torch.cat([torch.einsum("ora,or->oa", Jpi, WJd),
                   torch.einsum("ora,or->oa", Jpj, WJd)]).reshape(-1)).reshape(6 * N, M)

    # ---- landmark diagonal ----
    zM = torch.zeros(M, dtype=dtype, device=device)
    Hmm = zM.index_add(0, lm, torch.einsum("or,or->o", Jd2, WJd))
    bm = zM.index_add(0, lm, -torch.einsum("or,or->o", Jd2, info_r))
    return GlobalNormal(Hpp=Hpp, bp=bp, Hpm=Hpm, Hmm=Hmm, bm=bm, chi2=0.5 * chi2)


def assemble(p: GlobalBA, N: int, M: int, fix_frames: int = 1,
             loss_delta: float = 1.0) -> GlobalNormal:
    """Normal equations of the whole problem, with a unit diagonal on the
    fixed poses."""
    n = _assemble_terms(p, N, M, fix_frames, loss_delta)
    return n._replace(Hpp=n.Hpp + torch.diag(_fixed_diag(N, fix_frames, n.Hpp)))


def _landmark_inverse(Hmm, lm_valid):
    """diag(Hmm)⁻¹ with unconstrained and invalid landmarks at 0."""
    zero = torch.zeros_like(Hmm)
    Hmm_inv = torch.where(Hmm > 1e-12, 1.0 / torch.clamp(Hmm, min=1e-12), zero)
    return torch.where(lm_valid, Hmm_inv, zero)


def reduce_camera_system(n: GlobalNormal, lm_valid):
    """Landmark Schur step: the reduced camera system S = Hpp - Hpm
    diag(Hmm)⁻¹ Hpmᵀ (one (6N, M, 6N) matrix product), its right-hand side
    and diag(Hmm)⁻¹."""
    Hmm_inv = _landmark_inverse(n.Hmm, lm_valid)
    tempH = n.Hpm * Hmm_inv[None, :]
    return n.Hpp - tempH @ n.Hpm.T, n.bp - tempH @ n.bm, Hmm_inv


def _damped_solve(S, rhs, lam, use_pcg: bool):
    Sd = S + lam * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    if use_pcg:
        return pcg.pcg_solve(Sd, rhs, rtol=1e-8)[0]
    return linsolve.spd_solve(Sd, rhs)


def _solve_reduced(n: GlobalNormal, S, rhs, Hmm_inv, lam, use_pcg: bool):
    """Damped pose solve of the reduced system + landmark back-substitution."""
    dxp = _damped_solve(S, rhs, lam, use_pcg)
    return dxp, Hmm_inv * (n.bm - n.Hpm.T @ dxp)


def schur_step(n: GlobalNormal, lam, lm_valid, use_pcg: bool = False):
    """Landmark Schur + damped pose solve + back-substitution.

    ``use_pcg=True`` solves the reduced system with Jacobi-PCG instead of
    the direct kernel (the reference's own answer at scale, PCGSolver
    problem.cc:580-610)."""
    return _solve_reduced(n, *reduce_camera_system(n, lm_valid), lam, use_pcg)


def apply_delta(p: GlobalBA, dxp, dxm, fix_frames: int = 1) -> GlobalBA:
    N = p.Ps.shape[0]
    d = dxp.reshape(N, 6) * (torch.arange(N, device=dxp.device) >= fix_frames).to(
        dxp.dtype)[:, None]
    Qs = lie.quat_normalize(lie.quat_mul(p.Qs, lie.so3_exp_quat(d[:, 3:6])))
    # inverse depth stays positive: a sign flip puts the landmark behind
    # its host camera, where the robust kernel saturates and the landmark
    # is stranded at zero gradient
    inv_dep = torch.clamp(p.inv_dep + dxm, min=1e-3)
    return p._replace(Ps=p.Ps + d[:, 0:3], Qs=Qs, inv_dep=inv_dep)


class LMState(NamedTuple):
    """The λ-loop's carry (``vio_tpu/parallel/global_ba.py:249``), all on
    the device: the current poses and inverse depths, their normal
    equations and reduced system, the damping and the Nielsen counters as
    0-d tensors."""
    Ps: torch.Tensor
    Qs: torch.Tensor
    inv_dep: torch.Tensor
    normal: GlobalNormal
    S: torch.Tensor          # (6N, 6N) reduced system, with the gauge diagonal
    rhs: torch.Tensor        # (6N,)
    Hmm_inv: torch.Tensor    # (M,)
    lam: torch.Tensor
    ni: torch.Tensor
    chi: torch.Tensor
    it: torch.Tensor         # int64: the attempts made, as vio_tpu counts them
    stop: torch.Tensor       # bool


class Problem(NamedTuple):
    """What every attempt of one solve reads and never changes."""
    p: GlobalBA              # the tables; its Ps, Qs, inv_dep are the start's
    fixed_diag: torch.Tensor
    max_iter: int
    fix_frames: int
    loss_delta: float
    use_pcg: bool
    ofs: int = 0             # this rank's first landmark
    group: object = None     # torch.distributed group, or None
    wire: list | None = None  # bytes of each all_reduce, appended


def _assemble(q: Problem, Ps, Qs, inv_dep) -> GlobalNormal:
    p = q.p
    return _assemble_terms(p._replace(Ps=Ps, Qs=Qs, inv_dep=inv_dep), p.Ps.shape[0],
                           p.inv_dep.shape[0], q.fix_frames, q.loss_delta, q.ofs)


def _reduced(q: Problem, norm: GlobalNormal, extra):
    """The reduced system with the gauge diagonal, summed with chi² and
    ``extra`` over the group (``all_reduce_system``)."""
    S, rhs, Hmm_inv = reduce_camera_system(norm, q.p.lm_valid)
    S, rhs, chi, extra = all_reduce_system(S, rhs, norm.chi2, extra, q.group, q.wire)
    return S + torch.diag(q.fixed_diag), rhs, chi, extra, Hmm_inv


def start(p: GlobalBA, max_iter: int, fix_frames: int, loss_delta: float,
          use_pcg: bool = False, group=None, wire=None):
    """The first assembly and λ0 over p (the whole problem when ``group``
    is None, else this rank's ``prepare_sharded`` part): returns
    (LMState, Problem, chi2_init)."""
    ofs = 0 if group is None else dist.get_rank(group) * p.inv_dep.shape[0]
    q = Problem(p, _fixed_diag(p.Ps.shape[0], fix_frames, p.Ps), max_iter, fix_frames,
                loss_delta, use_pcg, ofs, group, [] if wire is None else wire)
    norm = _assemble(q, p.Ps, p.Qs, p.inv_dep)
    # λ0 = 1e-5 · min(max |diag|, 5e10) over the summed pre-Schur Hpp (with
    # the unit gauge diagonal) and the landmark diagonal
    S, rhs, chi, diag_pre, Hmm_inv = _reduced(q, norm, torch.diagonal(norm.Hpp))
    hmm_max = _psum_hi(torch.max(torch.abs(norm.Hmm)), group, dist.ReduceOp.MAX)
    max_diag = torch.maximum(torch.max(torch.abs(diag_pre + q.fixed_diag)), hmm_max)
    lam = 1e-5 * torch.clamp(max_diag, max=5e10)
    s = LMState(Ps=p.Ps, Qs=p.Qs, inv_dep=p.inv_dep, normal=norm, S=S, rhs=rhs,
                Hmm_inv=Hmm_inv, lam=lam, ni=torch.full_like(lam, 2.0), chi=chi,
                it=torch.zeros((), dtype=torch.int64, device=chi.device),
                stop=torch.zeros((), dtype=torch.bool, device=chi.device))
    return s, q, chi


def live(s: LMState, max_iter: int):
    """The loop's condition (``vio_tpu/parallel/global_ba.py:222``), a 0-d
    bool."""
    return ~s.stop & (s.it < max_iter)


def _attempt(s: LMState, q: Problem) -> LMState:
    """One λ-attempt (the JAX loop's ``body``, ``vio_tpu/parallel/
    global_ba.py:226-247``) with no host read: accept and reject are both
    computed and selected leaf by leaf, and both are masked by ``live``,
    so an attempt after the loop has ended returns ``s`` bit for bit.  A
    rejected candidate's chi², ρ and α may be non-finite; the selects keep
    the old leaves then.  Under a group every decision reads summed values
    or the replicated solve, so every rank takes the same branch."""
    go = live(s, q.max_iter)
    dxp, dxm = _solve_reduced(s.normal, s.S, s.rhs, s.Hmm_inv, s.lam, q.use_pcg)
    cand = apply_delta(q.p._replace(Ps=s.Ps, Qs=s.Qs, inv_dep=s.inv_dep), dxp, dxm,
                       q.fix_frames)
    norm_c = _assemble(q, cand.Ps, cand.Qs, cand.inv_dep)
    # the gain ratio's dxᵀ(λdx + b) with the PRE-Schur gradient: bp is a
    # rank's partial, so dxpᵀbp rides the reduce with the landmark terms
    dot = torch.dot(dxp, s.normal.bp) + torch.dot(dxm, s.lam * dxm + s.normal.bm)
    S_c, rhs_c, chi_c, dot, Hmm_inv_c = _reduced(q, norm_c, dot[None])
    scale = 0.5 * (s.lam * torch.dot(dxp, dxp) + dot[0]) + 1e-9
    rho = (s.chi - chi_c) / scale
    good = (rho > 0) & torch.isfinite(chi_c)
    acc = go & good
    rej = go & ~good

    # accept: Nielsen's λ shrink, ν = 2, the candidate becomes the state
    alpha = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, max=2.0 / 3.0)
    lam_acc = s.lam * torch.clamp(alpha, min=1.0 / 3.0)
    stop_acc = (s.chi - chi_c) < 1e-10 * torch.clamp(s.chi, min=1.0)
    # reject: λ·ν, ν·2
    stop_rej = s.lam * s.ni > 1e16

    moved = select(acc, (cand.Ps, cand.Qs, cand.inv_dep, norm_c, S_c, rhs_c, Hmm_inv_c,
                         chi_c),
                   (s.Ps, s.Qs, s.inv_dep, s.normal, s.S, s.rhs, s.Hmm_inv, s.chi))
    Ps, Qs, inv_dep, normal, S, rhs, Hmm_inv, chi = moved
    lam = torch.where(acc, lam_acc, torch.where(rej, s.lam * s.ni, s.lam))
    ni = torch.where(acc, torch.full_like(s.ni, 2.0), torch.where(rej, s.ni * 2.0, s.ni))
    stop = torch.where(acc, stop_acc, torch.where(rej, stop_rej, s.stop))
    return LMState(Ps=Ps, Qs=Qs, inv_dep=inv_dep, normal=normal, S=S, rhs=rhs,
                   Hmm_inv=Hmm_inv, lam=lam, ni=ni, chi=chi,
                   it=s.it + go.to(s.it.dtype), stop=stop)


def attempts(s: LMState, q: Problem, k: int) -> LMState:
    """``k`` attempts in a row, with no host read."""
    for _ in range(k):
        s = _attempt(s, q)
    return s


def graph_fns(max_iter: int, fix_frames: int, loss_delta: float, use_pcg: bool = False,
              group=None, wire=None):
    """The head, chunk and tail of a solve's loop (``vio_tpu/parallel/
    global_ba.py:208-252`` under ``jax.jit``); the inputs are the leaves of
    a ``GlobalBA``."""
    def begin(views):
        s, q, chi2_init = start(GlobalBA(*views), max_iter, fix_frames, loss_delta, use_pcg,
                                group, wire)
        return s, (q, chi2_init)

    return graph.loop_fns(begin, lambda s, aux, k: attempts(s, aux[0], k),
                          lambda s, aux: live(s, max_iter), lambda s, aux: [s.it])


def graph_key(p: GlobalBA, max_iter: int, fix_frames: int, loss_delta: float) -> tuple:
    """What ``jax.jit`` holds static for ``vio_tpu``'s ``solve``
    (``max_iter``, ``fix_frames``, ``loss_delta``; ``use_pcg`` is False
    where the loop is captured) and what it traces: each leaf's shape and
    dtype, and the device."""
    return ("global_ba", int(max_iter), int(fix_frames), float(loss_delta),
            tuple((tuple(t.shape), t.dtype) for t in p), p.Ps.device)


def solve_with(loop, p: GlobalBA, max_iter: int = 20, fix_frames: int = 1,
               loss_delta: float = 1.0, use_pcg: bool = False, group=None):
    """The solve of p (on its device and in its dtype) on the executor
    ``loop`` (``graph.loop``, or ``graph.EagerLoop``, the card's twin of a
    capture, which a stage timer can time: a synchronise inside a capture
    is an error): the problem's tensors in, a ``GlobalBA`` out whose poses
    and inverse depths are fresh device tensors (the tables are p's), and
    the stats: chi2, chi2_init and lam as 0-d tensors on the problem's
    device and in its dtype; as ints the ``iterations`` (the attempts the
    loop counts, as ``vio_tpu`` counts them), the attempts made (a chunk
    may make more, which change nothing), the host reads of the loop's
    condition, and the all_reduces with the bytes of the last."""
    wire = []
    key = graph_key(p, max_iter, fix_frames, loss_delta)
    g = loop(key, list(key[4]), *graph_fns(max_iter, fix_frames, loss_delta, use_pcg, group,
                                            wire),
             p.Ps.device, kept=lambda s, aux: [s.Ps, s.Qs, s.inv_dep, s.chi, aux[1], s.lam])
    g.inputs.load(list(p))
    scalar = p.Ps.new_empty(())
    out = [torch.empty_like(t) for t in (p.Ps, p.Qs, p.inv_dep, scalar, scalar, scalar)]
    (it,) = g.run(keep=out)
    Ps, Qs, inv_dep, chi, chi2_init, lam = out
    return p._replace(Ps=Ps, Qs=Qs, inv_dep=inv_dep), dict(
        chi2=chi, chi2_init=chi2_init, iterations=int(it), lam=lam, attempts=g.attempts,
        reads=g.reads, allreduces=len(wire), allreduce_bytes=wire[-1] if wire else 0)


def solve(p: GlobalBA, max_iter: int = 20, fix_frames: int = 1,
          loss_delta: float = 1.0, use_pcg: bool = False, device=None,
          dtype=None):
    """Nielsen-LM over the global problem (``vio_tpu``'s jitted ``solve``).
    The problem is moved to ``device`` and ``dtype`` first (without them,
    the card in float32).  Returns (p, stats), stats as ``solve_with``
    says whatever the executor.

    The executor follows the static arguments, before any work, as
    ``jax.jit`` compiles one program per ``use_pcg``; it is never chosen
    on an error: ``graph.loop`` where a graph can hold the program (on a
    CUDA device the key's captured graphs replayed, one host read of the
    loop's condition per ``graph.CHUNK`` attempts; a key is captured at
    its first call and pays off where calls repeat its shapes; a map that
    grows makes a key at every size, ``graph.POOL_BUDGET`` bounds the
    pools they hold), the eager loop where the damped solve is Jacobi-PCG
    (``use_pcg``, or 6N > ``linsolve.DIRECT_MAX_P`` through
    ``spd_solve``), whose data-dependent loop reads the host; on the card
    PCG then runs from its own graphs.  ``graph.STATS`` counts each route
    (``global_ba_graphed``, ``global_ba_eager``)."""
    device, dtype = resolve(device, dtype)
    p = move(p, device, dtype)
    capturable = not use_pcg and 6 * p.Ps.shape[0] <= linsolve.DIRECT_MAX_P
    graphed = capturable and device.type == "cuda"
    graph.STATS["global_ba_graphed" if graphed else "global_ba_eager"] += 1
    return solve_with(graph.loop if capturable else graph.EagerLoop, p, max_iter, fix_frames,
                      loss_delta, use_pcg)


# ---------------------------------------------------------------------------
# Distributed: one rank per landmark block, one all_reduce per attempt
# ---------------------------------------------------------------------------

def align_by_landmark(p: GlobalBA, n_shards: int) -> GlobalBA:
    """Regroup observations so every landmark's observations live on ONE
    shard: landmarks are blocked contiguously (M/n_shards per shard) and
    the observation stream is sorted by landmark then padded per shard to
    a common length with masked rows.  This is what makes the landmark
    Schur elimination local to a rank in ``solve_sharded`` — the only
    data that crosses ranks is the reduced (6N)^2 camera system.

    Host-side problem preparation (numpy), on the problem's device and
    dtype; call once before ``local_shard``.  M must divide n_shards."""
    M = int(p.inv_dep.shape[0])
    if M % n_shards:
        raise ValueError(f"{M} landmarks do not divide into {n_shards} shards")
    M_loc = M // n_shards
    lm_idx = p.lm_idx.cpu().numpy()
    frame = p.frame.cpu().numpy()
    bearing = p.bearing.cpu().numpy()
    valid = p.valid.cpu().numpy()

    order = np.argsort(lm_idx, kind="stable")
    lm_s, fr_s, be_s, va_s = (lm_idx[order], frame[order], bearing[order],
                              valid[order])
    shard_of = lm_s // M_loc
    counts = np.bincount(shard_of, minlength=n_shards)
    cap = int(((counts.max() + 7) // 8) * 8)

    O_new = n_shards * cap
    lm_n = np.zeros(O_new, np.int64)
    fr_n = np.zeros(O_new, np.int64)
    be_n = np.tile(np.array([0.0, 0.0, 1.0], bearing.dtype), (O_new, 1))
    va_n = np.zeros(O_new, bool)
    host = p.host.cpu().numpy()
    for s in range(n_shards):
        rows = np.nonzero(shard_of == s)[0]
        dst = slice(s * cap, s * cap + len(rows))
        lm_n[dst] = lm_s[rows]
        fr_n[dst] = fr_s[rows]
        be_n[dst] = be_s[rows]
        va_n[dst] = va_s[rows]
        # padding rows: first landmark of the shard, host==frame → masked
        pad = slice(s * cap + len(rows), (s + 1) * cap)
        lm_n[pad] = s * M_loc
        fr_n[pad] = host[s * M_loc]
    dev = p.lm_idx.device
    return p._replace(lm_idx=torch.as_tensor(lm_n, device=dev),
                      frame=torch.as_tensor(fr_n, device=dev),
                      bearing=torch.as_tensor(be_n, device=dev),
                      valid=torch.as_tensor(va_n, device=dev))


def local_shard(p: GlobalBA, rank: int, world: int) -> GlobalBA:
    """Rank ``rank``'s part of a landmark-aligned problem
    (``align_by_landmark(p, world)``): poses and ``sqrt_info`` replicated;
    the landmark tables cut into ``world`` contiguous blocks of M/world,
    this rank's starting at landmark rank·M/world; the observations cut
    into ``world`` equal blocks, which alignment made the ones of this
    rank's landmarks.  Landmark indices stay global.

    Takes the place of the JAX package's GSPMD placement
    (``shard_problem``, ``make_mesh_2d``, ``shard_problem_2d``,
    ``_obs_shardings``): there a mesh and shardings place the arrays and
    ``shard_map`` hands each device its block; here each rank holds its
    block itself."""
    M = p.inv_dep.shape[0]
    O = p.lm_idx.shape[0]
    if M % world or O % world:
        raise ValueError(f"{M} landmarks and {O} observations must divide by {world} ranks")
    lm = slice(rank * (M // world), (rank + 1) * (M // world))
    ob = slice(rank * (O // world), (rank + 1) * (O // world))
    return p._replace(inv_dep=p.inv_dep[lm], host=p.host[lm],
                      bearing0=p.bearing0[lm], lm_valid=p.lm_valid[lm],
                      lm_idx=p.lm_idx[ob], frame=p.frame[ob],
                      bearing=p.bearing[ob], valid=p.valid[ob])


def prepare_sharded(p: GlobalBA, rank: int, world: int) -> GlobalBA:
    """align_by_landmark + this rank's ``local_shard``."""
    return local_shard(align_by_landmark(p, world), rank, world)


def solve_sharded(p_loc: GlobalBA, group=None, max_iter: int = 20,
                  fix_frames: int = 1, loss_delta: float = 1.0,
                  use_pcg: bool = False, device=None, dtype=None):
    """Distributed global BA over the ranks of ``group`` (None: the
    default process group); every rank calls it with its own
    ``prepare_sharded`` part.  Assembly and the landmark Schur step are
    local, so each λ-attempt makes ONE all_reduce: the packed reduced
    system [S | rhs] with chi² and the gain ratio's landmark terms, in
    float64 on the wire.  The damped pose solve is replicated compute on
    every rank; landmark back-substitution and the state update stay
    local.  A rank that fails makes the others' next collective wait out
    the group's timeout (set it in ``init_process_group``).

    The program is ``solve``'s, with the group, on the eager loop
    (``graph.EagerLoop``): gloo cannot be captured into a graph.  Returns
    (this rank's part of the problem, stats), stats as ``solve``'s with
    the all_reduce count and bytes."""
    device, dtype = resolve(device, dtype)
    return solve_with(graph.EagerLoop, move(p_loc, device, dtype), max_iter, fix_frames,
                      loss_delta, use_pcg, dist.group.WORLD if group is None else group)
