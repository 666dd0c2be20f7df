"""Jacobi-preconditioned conjugate gradients for the reduced camera system.

Port of ``vio_tpu/solver/pcg.py`` (reference: vins-mono/src/backend/
problem.cc:580-610 PCGSolver — Jacobi preconditioner, stop at
‖r‖ < rtol·‖b‖ or n iterations).  The ``lax.while_loop`` body becomes
``_iteration``: one CG step as a transition of the device-resident carry
(x, r, p, rz, k), masked by the loop's condition (``live``, the JAX
``cond``), so that an iteration made after the loop has ended changes no
bit.  A solve is one program of those iterations (``graph_fns``) on
one of ``solver/graph.py``'s executors (``solve_with``): on a CUDA tensor
``pcg_solve`` replays the key's captured graphs; on the CPU the eager
loop runs the same iterations op by op.  Either reads the condition once
per ``CHUNK`` iterations, and the result does not depend on ``CHUNK``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import graph

# CG iterations between two host reads of the loop's condition (and in a
# graph's head).  Chosen on the card from {1, 8, 32, 128} (PERF.md §6).
CHUNK = 8


class CG(NamedTuple):
    """The loop's carry (``vio_tpu/solver/pcg.py:51``)."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    k: torch.Tensor          # int64: the iterations made


class System(NamedTuple):
    """What every iteration reads and never changes."""
    H: torch.Tensor
    Minv: torch.Tensor       # the Jacobi preconditioner, diag(H)⁻¹
    thresh: torch.Tensor     # rtol·‖b‖
    iters: int               # the iteration cap


def start(H, b, rtol, max_iter: int = 0):
    """The carry before the first iteration and the system: (CG, System).
    ``rtol`` is a number or a 0-d tensor of b's type (a graph's input)."""
    n = b.shape[0]
    d = torch.diagonal(H)
    Minv = torch.where(torch.abs(d) > 1e-30, 1.0 / d, torch.zeros_like(d))
    r = b.clone()
    p = Minv * r
    c = CG(x=torch.zeros_like(b), r=r, p=p, rz=torch.dot(r, p),
           k=torch.zeros((), dtype=torch.int64, device=b.device))
    return c, System(H, Minv, rtol * torch.linalg.norm(b), max_iter if max_iter > 0 else 2 * n)


def live(c: CG, sy: System):
    """The loop's condition (``vio_tpu/solver/pcg.py:35-37``), a 0-d bool."""
    return (c.k < sy.iters) & (torch.linalg.norm(c.r) > sy.thresh)


def _iteration(c: CG, sy: System) -> CG:
    """One CG step (``vio_tpu/solver/pcg.py:39-49``) with no host read,
    masked by ``live``: after the loop's end it returns ``c`` bit for
    bit."""
    go = live(c, sy)
    Hp = sy.H @ c.p
    alpha = c.rz / torch.clamp(torch.dot(c.p, Hp), min=1e-300)
    x = c.x + alpha * c.p
    r = c.r - alpha * Hp
    z = sy.Minv * r
    rz = torch.dot(r, z)
    beta = rz / torch.clamp(c.rz, min=1e-300)
    p = z + beta * c.p
    return CG(*(torch.where(go, new, old) for new, old in zip((x, r, p, rz), c[:4])),
              k=c.k + go.to(c.k.dtype))


def iterations(c: CG, sy: System, k: int) -> CG:
    """``k`` iterations in a row, with no host read."""
    for _ in range(k):
        c = _iteration(c, sy)
    return c


def graph_fns(max_iter: int):
    """The head, chunk and tail of a solve's loop
    (``vio_tpu/solver/pcg.py:19-52`` under ``jax.jit``); the inputs are
    rtol (0-d), H and b."""
    def begin(views):
        rtol, H, b = views
        return start(H, b, rtol, max_iter)

    return graph.loop_fns(begin, iterations, live, lambda c, sy: [c.k])


def graph_key(H, b, max_iter: int) -> tuple:
    """What ``jax.jit`` holds static for ``vio_tpu``'s ``pcg_solve``
    (``max_iter``) and what it traces: the shapes and dtype of rtol (an
    input, 0-d), H and b, and the device."""
    specs = ((), b.dtype), (tuple(H.shape), H.dtype), (tuple(b.shape), b.dtype)
    return ("pcg", int(max_iter), specs, H.device)


def solve_with(loop, H, b, max_iter: int = 0, rtol: float = 1e-6):
    """``pcg_solve`` on the executor ``loop`` (``graph.loop``, or
    ``graph.EagerLoop``, the card's twin of a capture), rtol an input of
    the key's, ``CHUNK`` iterations between two host reads of the
    condition.  Returns (x, a fresh device tensor; the iterations, an
    int)."""
    key = graph_key(H, b, max_iter)
    g = loop(key, list(key[2]), *graph_fns(max_iter), H.device,
             kept=lambda c, sy: [c.x], k=CHUNK)
    g.inputs.upload([rtol])
    g.inputs.load([H, b], start=1)
    x = torch.empty_like(b)
    (k,) = g.run(keep=[x])
    return x, int(k)


def pcg_solve(H, b, max_iter: int = 0, rtol: float = 1e-6):
    """Solve H x = b (H SPD) with Jacobi-PCG.  max_iter=0 → 2·dim like the
    reference's default (problem.cc:445).  Returns (x, iterations), x on
    H's device.  The executor is ``graph.loop``'s: on a CUDA tensor the
    key's captured graphs (keyed like ``jax.jit``: ``max_iter`` and the
    shapes; ``rtol`` is an input), counted in ``graph.STATS``
    (``pcg_solves``, ``pcg_iterations``); on the CPU the eager loop."""
    x, k = solve_with(graph.loop, H, b, max_iter, rtol)
    if H.is_cuda:
        graph.STATS["pcg_solves"] += 1
        graph.STATS["pcg_iterations"] += k
    return x, k
