"""SE3 pose-graph optimization on the LM solver.

Port of ``vio_tpu/loop/posegraph.py`` (the reference reads pose-graph
config flags but never compiles a pose-graph node: config/
euroc_config.yaml:66-70 loop_closure / pose_graph_save_path; relocalization
plumbing at estimator.cpp:622-642).  Sequential odometry edges + loop
edges, residual log(ΔT_meas⁻¹·Ti⁻¹Tj), solved with the generic dense LM.

The JAX package differentiates the whole 6M residual vector by the whole
6N parameter vector with forward mode.  An edge touches two poses, so
here forward mode (``torch.func.jacfwd``) runs per edge over its 12 local
parameters, batched over the edges, and the 12 x 12 blocks are summed
into the same dense H = JᵀJ with ``index_add_``: the same numbers without
the (6M, 6N) Jacobian.

``vio_tpu`` jits the normal equations and runs the LM on the host.  Here
the whole LM runs on the device (``solver/generic.py``'s branch-free
Nielsen attempt), the damped solve included.  The problem is padded:
the poses to a multiple of ``POSE_BUCKET`` (a padded pose is the identity,
held fixed), the edges to ``EDGES_PER_POSE`` times the padded poses, or
to the next multiple of ``EDGE_BUCKET`` above that (a padded edge
joins pose 0 to itself and weighs 0, and its rows are masked with
``torch.where``: a degenerate edge's forward-mode tangent may be NaN,
which a product with 0 keeps).  A padded pose adds a zero block to H,
whose damped step is 0; a padded edge adds nothing; so chi², max|diag H|,
ρ and every decision of the LM are those of the unpadded problem.  The
buckets let a growing graph (a loop closer's keyframes and loops) share
keys; a closer's graph has at most two edges a keyframe (its odometry
edge and one loop), so its key follows its poses alone, and ``prepare``
captures the keys a graph will reach before its solves do.  A solve is
one program (``generic.graph_fns``) on one of ``solver/graph.py``'s
executors, as ``parallel/global_ba.py``'s is: ``optimize`` on the card
replays the captured graphs of ``graph_key``, one host read of the
loop's condition per ``graph.CHUNK`` attempts, one upload, one read of
the results, the damped solve the library's Cholesky
(``linsolve.cholesky_solve``) inside the same graphs at every size; on
the CPU the eager loop runs the same attempts op by op, as
``optimize_eager`` does on any device (the graphs' twin on the card).

``STATS`` counts, over the process, the solves, their unpadded poses,
LM attempts and iterations, the graphs the solves captured and the
seconds capturing; ``ATTEMPTS_BY_P`` tallies the attempts (one damped
solve each) by the padded P = 6 × padded poses.
"""
from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch

from ..ops import linsolve
from ..solver import generic, graph
from ..utils import lie

POSE_BUCKET = 32          # poses padded to a multiple of this
EDGE_BUCKET = 64          # edges padded to a multiple of this
EDGES_PER_POSE = 2        # ... and to at least this many a padded pose
STOP_DELTA_CHI = 1e-5     # lm_solve_dense's default, which vio_tpu's optimize keeps

STATS: Counter = Counter()   # solves, poses, attempts, iterations, captures, capture_s
ATTEMPTS_BY_P: Counter = Counter()   # padded P -> attempts


def se3_edge_residual(Pi, qi, Pj, qj, dP, dq):
    """6-dim residual of one relative-pose edge: [dθ, dp].  Batched over
    leading dimensions."""
    q_ij = lie.quat_mul(lie.quat_conj(qi), qj)
    p_ij = lie.quat_rotate(lie.quat_conj(qi), Pj - Pi)
    r_rot = lie.quat_log(lie.quat_mul(lie.quat_conj(dq), q_ij))
    r_t = p_ij - dP
    return torch.cat([r_rot, r_t], dim=-1)


class PoseGraph(NamedTuple):
    """The padded problem: a graph's inputs, in this order."""
    Ps0: torch.Tensor    # (N, 3) initial positions
    qs0: torch.Tensor    # (N, 4) initial quaternions
    ei: torch.Tensor     # (M,) int64
    ej: torch.Tensor     # (M,) int64
    dP: torch.Tensor     # (M, 3)
    dq: torch.Tensor     # (M, 4)
    w: torch.Tensor      # (M,) edge weights, 0 on padded edges
    free: torch.Tensor   # (N,) 1 where a pose moves, 0 where it is held


def _bucket(n: int, size: int) -> int:
    return max(-(-n // size) * size, size)


def padded(Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq, edge_weights=None,
           fix_first: bool = True) -> list[np.ndarray]:
    """The padded problem as host arrays, in ``PoseGraph``'s order."""
    N, M = len(Ps0), len(edges_i)
    n = _bucket(N, POSE_BUCKET)
    m = _bucket(max(M, EDGES_PER_POSE * n), EDGE_BUCKET)
    Ps = np.zeros((n, 3))
    qs = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    ei, ej = np.zeros(m, np.int64), np.zeros(m, np.int64)
    dP = np.zeros((m, 3))
    dq = np.tile([0.0, 0.0, 0.0, 1.0], (m, 1))
    w, free = np.zeros(m), np.zeros(n)
    Ps[:N], qs[:N] = Ps0, qs0
    ei[:M], ej[:M], dP[:M], dq[:M] = edges_i, edges_j, edges_dP, edges_dq
    w[:M] = 1.0 if edge_weights is None else edge_weights
    free[:N] = 1.0
    if fix_first:
        free[0] = 0.0
    return [Ps, qs, ei, ej, dP, dq, w, free]


def _edge_residual(d, Pi0, qi0, Pj0, qj0, dP_m, dq_m):
    """One edge's residual as a function of its two poses' local updates
    d (12,)."""
    qi = lie.quat_mul(qi0, lie.so3_exp_quat(d[0:3]))
    qj = lie.quat_mul(qj0, lie.so3_exp_quat(d[6:9]))
    return se3_edge_residual(Pi0 + d[3:6], qi, Pj0 + d[9:12], qj, dP_m, dq_m)


_edge_jac = torch.func.vmap(torch.func.jacfwd(_edge_residual))


def problem(g: PoseGraph, max_iter: int):
    """The LM's problem over ``g`` (device tensors): (DenseProblem, x0,
    outputs), ``outputs(x)`` the poses [Ps, qs].  Parameterization: local
    [dθ(3), dp(3)] per pose around the initial guess, accumulated
    multiplicatively.  Reads nothing back to the host."""
    N, M = g.Ps0.shape[0], g.ei.shape[0]
    on = g.w != 0                                               # the real edges
    six = torch.arange(6, device=g.ei.device)
    # the 12 parameters of edge m in x: pose ei[m]'s six, then pose ej[m]'s
    cols = torch.cat([6 * g.ei[:, None] + six, 6 * g.ej[:, None] + six], dim=1)  # (M, 12)
    flat = (cols[:, :, None] * (6 * N) + cols[:, None, :]).reshape(-1)           # H's entries
    col_w = g.w[:, None] * torch.cat([g.free[g.ei][:, None].expand(M, 6),
                                      g.free[g.ej][:, None].expand(M, 6)], dim=1)

    def local(x):
        return x.reshape(N, 6) * g.free[:, None]

    def unpack(x):
        d = local(x)
        return [g.Ps0 + d[:, 3:6], lie.quat_mul(g.qs0, lie.so3_exp_quat(d[:, 0:3]))]

    def residuals(x):
        Ps, qs = unpack(x)
        r = se3_edge_residual(Ps[g.ei], qs[g.ei], Ps[g.ej], qs[g.ej], g.dP, g.dq)
        return torch.where(on[:, None], r * g.w[:, None], 0.0)        # (M, 6)

    def normal_fn(x):
        r = residuals(x)
        d = local(x)
        J = _edge_jac(torch.cat([d[g.ei], d[g.ej]], dim=1), g.Ps0[g.ei], g.qs0[g.ei],
                      g.Ps0[g.ej], g.qs0[g.ej], g.dP, g.dq)           # (M, 6, 12)
        J = torch.where(on[:, None, None], J * col_w[:, None, :], 0.0)
        H = x.new_zeros(36 * N * N).index_add_(
            0, flat, (J.transpose(1, 2) @ J).reshape(-1)).reshape(6 * N, 6 * N)
        b = x.new_zeros(6 * N).index_add_(
            0, cols.reshape(-1), -(J.transpose(1, 2) @ r[:, :, None]).reshape(-1))
        return H, b, 0.5 * torch.sum(r * r)

    q = generic.DenseProblem(normal_fn, lambda a, dx: a + dx, max_iter, STOP_DELTA_CHI)
    return q, g.Ps0.new_zeros(6 * N), unpack


def graph_key(n_pad: int, m_pad: int, dtype, fix_first: bool, max_iter: int,
              stop_delta_chi: float, device) -> tuple:
    """What is static for a solve's graphs: the padded pose and edge
    counts, the dtype, ``fix_first``, ``max_iter``, the stop threshold and
    the device.  The poses, edges, weights and the free mask are the
    graphs' inputs."""
    return ("posegraph", int(n_pad), int(m_pad), dtype, bool(fix_first), int(max_iter),
            float(stop_delta_chi), torch.device(device))


def _solve(loop, arrays, fix_first: bool, max_iter: int, device, dtype):
    """The padded problem ``arrays`` solved on the executor ``loop``
    (``graph.loop``, or ``graph.EagerLoop``): the padded poses (host
    float64) and the stats; ``STATS`` gains the graphs captured and their
    seconds."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:   # the key holds the index
        device = torch.device("cuda", torch.cuda.current_device())
    key = graph_key(len(arrays[0]), len(arrays[2]), dtype, fix_first, max_iter,
                    STOP_DELTA_CHI, device)
    fns = generic.graph_fns(lambda views: problem(PoseGraph(*views), max_iter))
    g = loop(key, [graph.spec_of(a, dtype) for a in arrays], *fns, device)
    graphed = isinstance(g, graph.LoopGraph)
    if graphed:
        linsolve.warm_cholesky(device, dtype)
    g.inputs.upload(arrays)
    c0, s0 = graph.STATS["captures"], graph.STATS["capture_s"]
    Ps, qs, chi, it, log_chi, log_lam = g.run()
    STATS["captures"] += graph.STATS["captures"] - c0
    STATS["capture_s"] += graph.STATS["capture_s"] - s0
    stats = dict(generic.device_stats(chi, it, log_chi, log_lam, g.attempts, g.reads),
                 key=key if graphed else None)
    return Ps, qs, stats


def _optimize(loop, Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq, edge_weights, fix_first,
              max_iter, device, dtype):
    arrays = padded(Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq, edge_weights, fix_first)
    Ps, qs, stats = _solve(loop, arrays, fix_first, max_iter, device, dtype)
    N = len(Ps0)
    STATS["solves"] += 1
    STATS["poses"] += N
    STATS["attempts"] += stats["attempts"]
    STATS["iterations"] += stats["iterations"]
    ATTEMPTS_BY_P[6 * len(arrays[0])] += stats["attempts"]
    return Ps[:N], qs[:N], stats


def prepare(n_poses: int, fix_first: bool = True, max_iter: int = 50, *, device,
            dtype) -> int:
    """Capture the graphs that a solve of ``n_poses`` poses (and at most
    ``EDGES_PER_POSE`` edges a padded pose) replays, before its first
    solve: a chain of identity poses, as many as the padded poses, is
    solved once from them.  Returns the graphs captured: 0 where the key
    was captured already, and on the CPU, which captures nothing.
    ``STATS`` counts the captures and their seconds, not the solve."""
    if torch.device(device).type != "cuda":
        return 0
    n = _bucket(n_poses, POSE_BUCKET)
    chain = np.arange(n - 1)
    arrays = padded(np.zeros((n, 3)), np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), chain,
                    chain + 1, np.zeros((n - 1, 3)), np.tile([0.0, 0.0, 0.0, 1.0], (n - 1, 1)),
                    fix_first=fix_first)
    c0 = STATS["captures"]
    _solve(graph.loop_graph, arrays, fix_first, max_iter, device, dtype)
    return STATS["captures"] - c0


def optimize_eager(Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq, edge_weights=None,
                   fix_first: bool = True, max_iter: int = 50, *, device, dtype):
    """``optimize`` on ``graph.EagerLoop`` on any device: the card's twin of
    a capture."""
    return _optimize(graph.EagerLoop, Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq,
                     edge_weights, fix_first, max_iter, device, dtype)


def optimize(Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq,
             edge_weights=None, fix_first: bool = True,
             max_iter: int = 50, *, device, dtype):
    """Optimize N poses given M relative edges (``vio_tpu``'s ``optimize``).

    Ps0 (N,3), qs0 (N,4) initial guesses; edges_* (M,)/(M,3)/(M,4), host
    arrays.  Returns (Ps, qs, stats): the poses as host float64 numpy;
    stats chi2, iterations and the chi²/λ log as ``vio_tpu`` returns
    them, with the attempts made, the host reads of the loop's condition
    and the graphs' key (None on the eager loop).  The executor is
    ``graph.loop``'s: on a CUDA device the captured graphs, on the CPU the
    eager loop; the same padded, branch-free attempts."""
    return _optimize(graph.loop, Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq, edge_weights,
                     fix_first, max_iter, device, dtype)
