"""Captured CUDA graphs for the LM loop: the port's counterpart of
``jax.jit``'s cache and of the JAX loop's one device program.

``vio_tpu`` runs a frame as one jitted program (``vio_tpu/solver/
frame_step.py:72``), its λ-attempts inside a ``lax.while_loop``.  Here a
``LoopGraph`` holds three graphs captured once per key, the key being what
``jax.jit`` would hold static (the static arguments, the shapes, the dtype
and the device):

- the head: from the inputs to the loop's state after its first ``CHUNK``
  attempts (``lm._attempt``, branch-free, masked by the loop's condition);
- the chunk: ``CHUNK`` more attempts, written back into the same state;
- the tail: from the state to the outputs, packed into one buffer.

A call is then one host-to-device copy of the inputs from one pinned
staging buffer, a replay of the head, a one-byte read of the loop's
condition after it and after each replay of the chunk, a replay of the
tail and one device-to-host copy of the outputs.  Attempts replayed after
the loop has ended change no bit, so the result does not depend on
``CHUNK``.

There is no fallback: a capture or a replay that fails raises.  Capture
runs on a stream of its own in ``thread_local`` mode, so a thread that
launches work on the card meanwhile (``runner.run_images_async``'s
tracker) is not stopped by it.  Each thread's first capture on a device in
a dtype is preceded by one eager run of the head with no attempt and of
the tail on the capture stream, which creates the library handles and
workspaces that must not be created inside a capture; the λ-attempts,
and so the ``gj_solve`` kernel, run only in replays.
``ops.linsolve.gj_solve`` counts the launches a capture records
(``gj_solve.captured``); each replay adds them to ``gj_solve.launches``.

Nothing here runs on the CPU: the CPU runs the same functions eagerly
(``lm.solve_window``, ``frame_step.frame_step``).
"""
from __future__ import annotations

import threading
import time
from collections import Counter

import numpy as np
import torch

from ..ops import _build, linsolve
from . import lm

# λ-attempts between two host reads of the loop's condition (and in the
# head).  Chosen on the card from K in {1, 2, 4, 8} (PERF.md §6).
CHUNK = 1

# Totals over the process: keys, graphs captured, seconds spent capturing
# (the warm-ups included), replays, the attempts they made, host reads of
# the condition, and the bytes the keys' memory pools hold.
# ``reset_stats`` zeroes them.
STATS: Counter = Counter()

_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.bool: np.bool_, torch.int64: np.int64}
_CACHE: dict = {}
_LOCK = threading.Lock()
_WARM: set = set()
_STREAMS: dict = {}


def reset_stats() -> None:
    STATS.clear()


def clear() -> None:
    """Drop every captured key (their memory pools go with them)."""
    with _LOCK:
        _CACHE.clear()


def cached_keys() -> list:
    """The keys captured so far in this process."""
    with _LOCK:
        return list(_CACHE)


def spec_of(x, dtype) -> tuple:
    """(shape, torch dtype) a host array takes on the card: floats in
    ``dtype``, integers as int64 indices, booleans as booleans (the rule
    of ``convert.to_tensor``)."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        t = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        t = torch.int64
    else:
        t = dtype
    return tuple(a.shape), t


class Slab:
    """Typed views into one device buffer, with a pinned host twin: the
    inputs of a ``LoopGraph`` are filled on the host and cross in one
    copy."""

    def __init__(self, specs, device):
        sizes = [int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dt).element_size()
                 for shape, dt in specs]
        ends = np.cumsum([-(-nb // 16) * 16 for nb in sizes])   # 16-byte aligned views
        n = max(int(ends[-1]) if sizes else 0, 16)
        self.host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        self.dev = torch.empty(n, dtype=torch.uint8, device=device)
        host_np = self.host.numpy()
        self.views, self.host_views = [], []
        for (shape, dt), nb, o in zip(specs, sizes, [0, *ends[:-1].tolist()]):
            self.views.append(self.dev[o:o + nb].view(dt).view(shape))
            self.host_views.append(host_np[o:o + nb].view(_NP[dt]).reshape(shape))

    def upload(self, arrays) -> None:
        """Write host arrays into the staging buffer, then one copy."""
        for v, a in zip(self.host_views, arrays):
            v[...] = a
        self.dev.copy_(self.host, non_blocking=True)

    def load(self, tensors) -> None:
        """Copy device tensors into the views (one copy each)."""
        for v, t in zip(self.views, tensors):
            v.copy_(t)


def _capture_stream(device):
    with _LOCK:
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        return _STREAMS[device]


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


class LoopGraph:
    """head(inputs, k) -> (carry, aux, live) and chunk(carry, aux, k) ->
    (carry, live), each making k λ-attempts; tail(carry, aux) -> list of
    tensors.  ``carry`` is a pytree of tensors, rewritten in place by each
    replay of the chunk; ``aux`` is what the chunk and the tail read and
    never change."""

    def __init__(self, key, specs, head, chunk, tail, device):
        if CHUNK < 1:
            raise ValueError(f"graph.CHUNK must be at least 1, not {CHUNK}")
        self.key = key
        self.chunk = CHUNK        # the attempts the head and the chunk make
        self.device = torch.device(device)
        self.inputs = Slab(specs, self.device)
        self._fns = (head, chunk, tail)
        self.graphs = None
        self.launches = {}        # gj_solve launches each graph holds
        self.pool_bytes = 0

    def _capture(self, name, fn, pool, stream):
        g = torch.cuda.CUDAGraph()
        before = linsolve.gj_solve.captured
        with torch.cuda.graph(g, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
        self.launches[name] = linsolve.gj_solve.captured - before
        STATS["captures"] += 1
        return g, out

    def _capture_all(self) -> None:
        head, chunk, tail = self._fns
        stream = _capture_stream(self.device)
        t0 = time.perf_counter()
        _build.load()                     # nvcc must never run inside a capture
        warm_key = (threading.get_ident(), self.device,
                    tuple(v.dtype for v in self.inputs.views))
        stream.wait_stream(torch.cuda.current_stream(self.device))
        if warm_key not in _WARM:
            # library handles and workspaces come into being here, on the
            # capture stream, not inside the capture
            with torch.cuda.stream(stream):
                carry, aux, _ = head(self.inputs.views, 0)
                tail(carry, aux)
            stream.synchronize()
            _WARM.add(warm_key)
        torch.cuda.empty_cache()          # the pool's size: what stays reserved
        reserved = torch.cuda.memory_reserved(self.device)
        pool = torch.cuda.graph_pool_handle()

        g_head, (carry, aux, live) = self._capture(
            "head", lambda: head(self.inputs.views, self.chunk), pool, stream)
        self.carry, self.aux, self.live = carry, aux, live

        def do_chunk():
            new, new_live = chunk(self.carry, self.aux, self.chunk)
            for dst, src in zip(_leaves(self.carry), _leaves(new)):
                if src is not dst:
                    dst.copy_(src)
            self.live.copy_(new_live)

        g_chunk, _ = self._capture("chunk", do_chunk, pool, stream)

        def do_tail():
            outs = tail(self.carry, self.aux)
            packed = torch.cat([t.reshape(-1).to(torch.float64) for t in outs])
            return packed, [tuple(t.shape) for t in outs]

        g_tail, (packed, shapes) = self._capture("tail", do_tail, pool, stream)
        self.packed, self.shapes = packed, shapes
        self.out_host = torch.empty(packed.shape, dtype=torch.float64, pin_memory=True)
        self.graphs = (g_head, g_chunk, g_tail)
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        STATS["pool_bytes"] += self.pool_bytes
        STATS["capture_s"] += time.perf_counter() - t0

    def _replay(self, i: int, name: str) -> None:
        self.graphs[i].replay()
        linsolve.gj_solve.launches += self.launches[name]
        STATS["replays"] += 1
        if name != "tail":
            STATS["attempts"] += self.chunk

    def _live(self) -> bool:
        STATS["reads"] += 1
        return bool(self.live)

    def run(self) -> list[np.ndarray]:
        """Replay the loop on the inputs loaded last (``inputs.upload`` or
        ``inputs.load``); returns the tail's outputs as float64 host
        arrays."""
        if self.graphs is None:
            self._capture_all()
        self._replay(0, "head")
        while self._live():
            self._replay(1, "chunk")
        self._replay(2, "tail")
        self.out_host.copy_(self.packed)          # synchronises
        flat = self.out_host.numpy().copy()
        out, o = [], 0
        for shape in self.shapes:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(flat[o:o + n].reshape(shape))
            o += n
        return out


def loop_graph(key, specs, head, chunk, tail, device) -> LoopGraph:
    """The cached ``LoopGraph`` of ``key`` at the current ``CHUNK``, made
    on first use."""
    with _LOCK:
        g = _CACHE.get((key, CHUNK))
        if g is None:
            g = _CACHE[(key, CHUNK)] = LoopGraph(key, specs, head, chunk, tail, device)
            STATS["keys"] = len(_CACHE)
        return g


def _unflatten(template, it):
    if isinstance(template, tuple):
        parts = [_unflatten(t, it) for t in template]
        return type(template)(*parts) if hasattr(template, "_fields") else tuple(parts)
    return next(it)


def window_fns(tree, max_iter: int, fix_ext: bool, loss_delta: float,
               n_obs: int | None):
    """The head, chunk and tail of a window solve's ``LoopGraph``; the
    inputs are the leaves of ``tree`` = (states, factors)."""
    def head(views, k):
        st, ff = _unflatten(tree, iter(views))
        s, p, chi2_init = lm.start(st, ff, max_iter, fix_ext, loss_delta, n_obs)
        s = lm.attempts(s, p, k)
        return s, (p, chi2_init), lm.live(s, max_iter)

    def step(s, aux, k):
        s = lm.attempts(s, aux[0], k)
        return s, lm.live(s, max_iter)

    def tail(s, aux):
        return [*s.states, s.b_prior, s.err_prior, s.chi, aux[1], s.it, s.lam]

    return head, step, tail


def solve_window(states, f, max_iter: int = 10, fix_ext: bool = True,
                 loss_delta: float = 1.0, n_obs: int | None = None):
    """``lm.solve_window`` on the card from captured graphs: device tensors
    in (``states``, ``f``, one copy each into the key's inputs), host
    float64 arrays out.  Returns (states, b_prior, err_prior, stats) with
    stats chi2, iterations (an int), lam and chi2_init."""
    tree = (states, f)
    leaves = _leaves(tree)
    device = leaves[0].device
    specs = [(tuple(t.shape), t.dtype) for t in leaves]
    key = ("solve_window", int(max_iter), bool(fix_ext), float(loss_delta),
           n_obs, tuple(specs), device)
    g = loop_graph(key, specs, *window_fns(tree, max_iter, fix_ext, loss_delta, n_obs),
                   device)
    g.inputs.load(leaves)
    out = g.run()
    n = len(states)
    b_prior, err_prior, chi, chi2_init, it, lam = out[n:]
    return (type(states)(*out[:n]), b_prior, err_prior,
            dict(chi2=chi, iterations=int(it), lam=lam, chi2_init=chi2_init))
