"""Jacobi-preconditioned conjugate gradients for the reduced camera system.

Port of ``vio_tpu/solver/pcg.py`` (reference: vins-mono/src/backend/
problem.cc:580-610 PCGSolver — Jacobi preconditioner, stop at
‖r‖ < rtol·‖b‖ or n iterations).  The ``lax.while_loop`` body becomes
``_iteration``: one CG step as a transition of the device-resident carry
(x, r, p, rz, k), masked by the loop's condition (``live``, the JAX
``cond``), so that an iteration made after the loop has ended changes no
bit.  On a CUDA tensor ``pcg_solve`` replays the key's captured graphs
(``pcg_solve_graphed``, on ``graph.LoopGraph``); on the CPU
``pcg_solve_eager`` runs the same iterations op by op.  Either reads the
condition once per ``CHUNK`` iterations, and the result does not depend
on ``CHUNK``.
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


def pcg_solve_eager(H, b, max_iter: int = 0, rtol: float = 1e-6):
    """``pcg_solve`` op by op on the inputs' device: ``CHUNK`` iterations
    between two host reads of the loop's condition.  Returns (x, the
    iterations made as an int)."""
    c, sy = start(H, b, rtol, max_iter)
    n = 0
    while n < sy.iters:
        c = iterations(c, sy, CHUNK)
        n += CHUNK
        if not bool(live(c, sy)):
            break
    return c.x, int(c.k)


def graph_fns(max_iter: int):
    """The head, chunk and tail of a solve's ``graph.LoopGraph``
    (``vio_tpu/solver/pcg.py:19-52`` under ``jax.jit``); the inputs are
    rtol (0-d), H and b."""
    def head(views, k):
        rtol, H, b = views
        c, sy = start(H, b, rtol, max_iter)
        c = iterations(c, sy, k)
        return c, sy, live(c, sy)

    def step(c, sy, k):
        c = iterations(c, sy, k)
        return c, live(c, sy)

    def tail(c, sy):
        return [c.k]

    return head, step, tail


def graph_key(H, b, max_iter: int) -> tuple:
    """What ``jax.jit`` holds static for ``vio_tpu``'s ``pcg_solve``
    (``max_iter``) and what it traces: the shapes and dtype of rtol (an
    input, 0-d), H and b, and the device."""
    specs = ((), b.dtype), (tuple(H.shape), H.dtype), (tuple(b.shape), b.dtype)
    return ("pcg", int(max_iter), specs, H.device)


def pcg_solve_graphed(H, b, max_iter: int = 0, rtol: float = 1e-6):
    """``pcg_solve`` on the card from the captured graphs of ``graph_key``
    (rtol is an input): H and b copied into the key's inputs on the device,
    ``CHUNK`` iterations between two host reads of the condition.  Returns
    (x, a fresh device tensor; the iterations, an int).  Raises on CPU
    tensors; there is no eager fallback."""
    graph.require_cuda(H.device, "pcg.pcg_solve_graphed")
    key = graph_key(H, b, max_iter)
    g = graph.loop_graph(key, list(key[2]), *graph_fns(max_iter), H.device,
                         kept=lambda c, sy: [c.x], k=CHUNK)
    g.inputs.upload([rtol])
    g.inputs.load([H, b], start=1)
    x = torch.empty_like(b)
    (k,) = g.run(keep=[x])
    graph.STATS["pcg_solves"] += 1
    graph.STATS["pcg_iterations"] += int(k)
    return x, int(k)


def pcg_solve(H, b, max_iter: int = 0, rtol: float = 1e-6):
    """Solve H x = b (H SPD) with Jacobi-PCG.  max_iter=0 → 2·dim like the
    reference's default (problem.cc:445).  Returns (x, iterations).  On a
    CUDA tensor ``pcg_solve_graphed`` (graphs keyed like ``jax.jit``:
    ``max_iter`` and the shapes; ``rtol`` is an input), x on the device;
    on the CPU ``pcg_solve_eager``."""
    if H.is_cuda:
        return pcg_solve_graphed(H, b, max_iter, rtol)
    return pcg_solve_eager(H, b, max_iter, rtol)
