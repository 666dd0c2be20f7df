"""The executors of the port's device loops: captured CUDA graphs, the
port's counterpart of ``jax.jit``'s cache and of the JAX loop's one device
program, and their eager twin.

``vio_tpu`` runs a frame as one jitted program (``vio_tpu/solver/
frame_step.py:72``), its λ-attempts inside a ``lax.while_loop``.  Here
each such loop is one program, a ``(head, chunk, tail)`` triple of
branch-free functions written beside its solver (``loop_fns``; the
frame's in ``frame_step.py``, the window LM's in ``lm.py``, global BA's
in ``parallel/global_ba.py``, Jacobi-PCG's in ``pcg.py``, the pose
graph's in ``generic.py``): the head takes the inputs to the loop's state
after its first ``k`` attempts (``lm._attempt``, masked by the loop's
condition), the chunk makes ``k`` more, the tail gives the outputs.
Attempts made after the loop has ended change no bit, so the result does
not depend on ``k``.  Two executors run a program, and ``loop`` chooses
by the device:

- ``LoopGraph``, on the card: three graphs captured once per key, the key
  being what ``jax.jit`` would hold static (the static arguments, the
  shapes, the dtype and the device).  A call is one host-to-device copy
  of the inputs from one pinned staging buffer (or device-to-device
  copies of device tensors), a replay of the head, a one-byte read of the
  loop's condition after it and after each replay of the chunk, a replay
  of the tail and one device-to-host copy of the outputs; what the caller
  keeps on the device (global BA's poses) is copied out of the state into
  the caller's tensors;
- ``EagerLoop``, op by op with the same host reads: the CPU's executor,
  and on the card the one for a program a graph cannot hold (a damped
  solve by PCG, whose own loop reads the host; a ``torch.distributed``
  group), which its solver takes itself, and a capture's twin for
  verification.

A key is captured once per process and kept while it is used: the route
pays off where calls repeat a shape, as ``jax.jit``'s cache does.  A
solver whose shapes change at every call (a map that grows) makes a key
at every call, so the keys' pools together are held to ``POOL_BUDGET``:
past it, the least recently used keys are dropped.

There is no fallback: a capture or a replay that fails raises.  Capture
runs on a stream of its own in ``thread_local`` mode, so a thread that
launches work on the card meanwhile (``runner.run_images_async``'s
tracker) is not stopped by it.  Each thread's first capture on a device in
a dtype is preceded by one eager run of the head with no attempt and of
the tail on the capture stream, which creates the library handles and
workspaces that must not be created inside a capture; the λ-attempts,
and so the ``gj_solve`` kernel, run only in replays.  Every kernel wrapper
registered with ``ops._build.counted`` counts the launches a capture
records (``.captured``), and each replay adds them to its ``.launches``:
``imu.preintegrate_kernel`` once in every frame key's head,
``window.imu_factor_kernel`` once an assembly (1 + ``CHUNK`` in a frame
key's head, ``CHUNK`` in its chunk, one in its tail where it marginalizes
the oldest frame).

A ``ProgramGraph`` is the one-shot counterpart, for a jitted function
with no loop in it (the tracker's programs, ``features/tracker.py``): a
pinned input slab, one graph, one replay a call and one device-to-host
copy of its packed outputs; what the function keeps on the device (the
tracker's image) is copied into the caller's tensors after the replay.
It keeps ``LoopGraph``'s rules, and ``run_eagerly`` runs the same
function without a graph: the CPU's path.  Captures are serialised by
one lock (a thread that captures calls ``torch.cuda.synchronize()`` on
entry, which must not meet another thread's capture); replays are not.

The host's part of a graph's call is timed by spans (``trace.py``): a
slab's upload (``graph.upload``), each replay's enqueue
(``graph.replay``), the host blocked on a condition read or an output
readback (``graph.wait``) and a key's warm-up and capture
(``graph.capture``, the interval that ``STATS["capture_s"]`` sums).  The
eager executors open no span and add nothing to ``STATS``.
"""
from __future__ import annotations

import threading
from collections import Counter

import numpy as np
import torch

from .. import trace
from ..ops import _build

# λ-attempts between two host reads of the loop's condition (and in the
# head).  Chosen on the card from K in {1, 2, 4, 8} (PERF.md §6).
CHUNK = 1

# The most device memory the cached keys' pools hold together; a capture
# that takes them past it drops the least recently used other keys.  One
# global-BA key at 1M observations holds ~3 GiB (PERF.md §5).
POOL_BUDGET = 8 << 30

# Totals over the process: keys cached, graphs captured, seconds spent
# capturing (the warm-ups included, the kernels' build not), the bytes the
# captures' memory pools took, the keys dropped to keep POOL_BUDGET
# (evicted); of the LoopGraphs the replays, the attempts (or CG iterations)
# they made and the host reads of the condition; of the ProgramGraphs the
# replays and the host reads of the outputs (program_replays,
# program_reads); global BA's routes (global_ba_graphed, global_ba_eager:
# ``global_ba.solve``) and the graphed PCG solves with their CG iterations
# (pcg_solves, pcg_iterations).  ``reset_stats`` zeroes them.
STATS: Counter = Counter()

_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.bool: np.bool_, torch.int64: np.int64}
_CACHE: dict = {}
_LOCK = threading.Lock()
_CAPTURE_LOCK = threading.Lock()
_WARM: set = set()
_STREAMS: dict = {}


def reset_stats() -> None:
    STATS.clear()


def clear() -> None:
    """Drop every captured key (their memory pools go with them)."""
    with _LOCK:
        _CACHE.clear()
        STATS["keys"] = 0


def _cached(key, make):
    """The cached graph of ``key``, made by ``make()`` on first use; a use
    makes it the most recently used."""
    with _LOCK:
        g = _CACHE.pop(key, None)
        if g is None:
            g = make()
        _CACHE[key] = g
        STATS["keys"] = len(_CACHE)
        return g


def _evict(current) -> None:
    """Drop the least recently used keys other than ``current`` while the
    pools of the cached keys hold more than ``POOL_BUDGET`` bytes.  A
    dropped graph that a thread still runs lives until that run ends."""
    with _LOCK:
        total = sum(g.pool_bytes for g in _CACHE.values())
        for key, g in list(_CACHE.items()):
            if total <= POOL_BUDGET:
                break
            if g is not current:
                del _CACHE[key]
                total -= g.pool_bytes
                STATS["evicted"] += 1
        STATS["keys"] = len(_CACHE)


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
        self.ends = ends.tolist() if sizes else []
        self.views, self.host_views = [], []
        for (shape, dt), nb, o in zip(specs, sizes, [0, *ends[:-1].tolist()]):
            self.views.append(self.dev[o:o + nb].view(dt).view(shape))
            self.host_views.append(host_np[o:o + nb].view(_NP[dt]).reshape(shape))

    def upload(self, arrays) -> None:
        """Write host arrays into the first views' staging buffer, then
        one copy of those views."""
        arrays = list(arrays)
        with trace.span("graph.upload"):
            for v, a in zip(self.host_views, arrays):
                v[...] = a
            if arrays:
                end = self.ends[len(arrays) - 1]
                self.dev[:end].copy_(self.host[:end], non_blocking=True)

    def load(self, tensors, start: int = 0) -> None:
        """Copy device tensors into the views from ``start`` on (one copy
        each)."""
        for v, t in zip(self.views[start:], tensors):
            v.copy_(t)


def _capture_stream(device):
    with _LOCK:
        if device not in _STREAMS:
            _STREAMS[device] = torch.cuda.Stream(device)
        return _STREAMS[device]


def _captured() -> dict:
    return {fn: fn.captured for fn in _build.COUNTED}


def _replayed(counts: dict) -> None:
    """Add a replay's launches to each counted wrapper."""
    for fn, n in counts.items():
        fn.launches += n


def _leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _capture_key(device, dtypes: tuple, warm_up, body) -> int:
    """Capture one key's graphs: under the capture lock, ``warm_up()``
    eagerly on the capture stream if this thread has captured nothing on
    ``device`` in ``dtypes`` yet, then ``body(stream)``, which captures.
    Adds the seconds and the bytes the key's pool keeps to STATS and
    returns those bytes.  The kernels are built first (nvcc must never run
    inside a capture), outside the seconds counted."""
    _build.load()
    with trace.span("graph.capture") as sp:
        stream = _capture_stream(device)
        with _CAPTURE_LOCK:
            warm_key = (threading.get_ident(), device, dtypes)
            stream.wait_stream(torch.cuda.current_stream(device))
            if warm_key not in _WARM:
                # library handles and workspaces come into being here, on
                # the capture stream, not inside the capture
                with torch.cuda.stream(stream):
                    warm_up()
                stream.synchronize()
                _WARM.add(warm_key)
            torch.cuda.empty_cache()          # the pool's size: what stays reserved
            reserved = torch.cuda.memory_reserved(device)
            body(stream)
            torch.cuda.empty_cache()
            pool_bytes = torch.cuda.memory_reserved(device) - reserved
    STATS["pool_bytes"] += pool_bytes
    STATS["capture_s"] += sp.seconds
    return pool_bytes


def _capture(fn, stream, pool=None):
    """One graph of ``fn()`` on ``stream``: (the graph, ``fn``'s output,
    {counted wrapper: its launches the graph holds})."""
    g = torch.cuda.CUDAGraph()
    before = _captured()
    with torch.cuda.graph(g, pool=pool, stream=stream, capture_error_mode="thread_local"):
        out = fn()
    STATS["captures"] += 1
    return g, out, {fn: n - before.get(fn, 0) for fn, n in _captured().items()}


def _pack(outs) -> tuple:
    """Inside a capture: the tensors ``outs`` as one float64 device buffer
    (None for none), and each one's shape and host dtype."""
    packed = torch.cat([t.reshape(-1).to(torch.float64) for t in outs]) if outs else None
    return packed, [(tuple(t.shape), _NP[t.dtype]) for t in outs]


class _Readback:
    """A graph's packed outputs (``_pack``) and the pinned host buffer
    they come back to in one device-to-host copy."""

    def __init__(self, packed, meta):
        self.packed, self.meta = packed, meta
        self.host = (torch.empty(packed.shape, dtype=torch.float64, pin_memory=True)
                     if packed is not None else None)

    def read(self) -> list[np.ndarray]:
        """The outputs as host arrays of the dtypes in ``meta`` (one copy,
        which synchronises)."""
        if self.packed is None:
            return []
        with trace.span("graph.wait"):
            self.host.copy_(self.packed)
        flat = self.host.numpy()
        out, o = [], 0
        for shape, dt in self.meta:
            n = int(np.prod(shape, dtype=np.int64))
            out.append(flat[o:o + n].reshape(shape).astype(dt))
            o += n
        return out


class LoopGraph:
    """head(inputs, k) -> (carry, aux, live) and chunk(carry, aux, k) ->
    (carry, live), each making k λ-attempts; tail(carry, aux) -> list of
    tensors.  ``carry`` is a pytree of tensors, rewritten in place by each
    replay of the chunk; ``aux`` is what the chunk and the tail read and
    never change.  ``kept(carry, aux)`` names the tensors a call hands back
    on the device (None: none); ``k`` is the attempts the head and the chunk
    make.  After a call, ``attempts`` and ``reads`` are the attempts its
    replays made and its host reads of the condition.  Refuses a device
    other than CUDA."""

    def __init__(self, key, specs, head, chunk, tail, device, kept, k: int):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a LoopGraph runs on a CUDA device, not {self.device}")
        self.key = key
        self.chunk = _chunk(k)    # the attempts the head and the chunk make
        self.inputs = Slab(specs, self.device)
        self._fns = (head, chunk, tail, kept)
        self.graphs = None
        self.launches = {}        # {name: {counted wrapper: launches}} of each graph
        self.pool_bytes = 0
        self.attempts = self.reads = 0

    def _capture_all(self) -> None:
        head, chunk, tail, kept = self._fns

        def warm_up():
            carry, aux, _ = head(self.inputs.views, 0)
            tail(carry, aux)

        def body(stream):
            pool = torch.cuda.graph_pool_handle()
            g_head, (carry, aux, live), self.launches["head"] = _capture(
                lambda: head(self.inputs.views, self.chunk), stream, pool)
            self.carry, self.aux, self.live = carry, aux, live
            self.kept = kept(carry, aux) if kept else []

            def do_chunk():
                new, new_live = chunk(self.carry, self.aux, self.chunk)
                for dst, src in zip(_leaves(self.carry), _leaves(new)):
                    if src is not dst:
                        dst.copy_(src)
                self.live.copy_(new_live)

            g_chunk, _, self.launches["chunk"] = _capture(do_chunk, stream, pool)
            # the outputs come back as float64, whatever their type
            g_tail, (packed, meta), self.launches["tail"] = _capture(
                lambda: _pack(tail(self.carry, self.aux)), stream, pool)
            self.out = _Readback(packed, [(shape, np.float64) for shape, _ in meta])
            self.graphs = (g_head, g_chunk, g_tail)

        self.pool_bytes = _capture_key(self.device, tuple(v.dtype for v in self.inputs.views),
                                       warm_up, body)
        _evict(self)

    def _replay(self, i: int, name: str) -> None:
        with trace.span("graph.replay"):
            self.graphs[i].replay()
        _replayed(self.launches[name])
        STATS["replays"] += 1
        if name != "tail":
            STATS["attempts"] += self.chunk
            self.attempts += self.chunk

    def _live(self) -> bool:
        STATS["reads"] += 1
        self.reads += 1
        with trace.span("graph.wait"):
            return bool(self.live)

    def run(self, keep=()) -> list[np.ndarray]:
        """Replay the loop on the inputs loaded last (``inputs.upload`` or
        ``inputs.load``); copies the ``kept`` tensors into ``keep`` (the
        caller's device tensors, so the next replay cannot overwrite a
        result) and returns the tail's outputs as float64 host arrays."""
        if self.graphs is None:
            self._capture_all()
        self.attempts = self.reads = 0
        self._replay(0, "head")
        while self._live():
            self._replay(1, "chunk")
        self._replay(2, "tail")
        for dst, src in zip(keep, self.kept):
            dst.copy_(src)
        return self.out.read()


def loop_fns(begin, advance, live, tail):
    """A loop program's head and chunk from its parts, with its tail:
    ``begin(inputs) -> (carry, aux)``, ``advance(carry, aux, k)`` making k
    attempts, ``live(carry, aux)`` the loop's condition (a 0-d bool) and
    ``tail(carry, aux)`` the outputs."""
    def head(views, k):
        carry, aux = begin(views)
        carry = advance(carry, aux, k)
        return carry, aux, live(carry, aux)

    def chunk(carry, aux, k):
        carry = advance(carry, aux, k)
        return carry, live(carry, aux)

    return head, chunk, tail


def _chunk(k) -> int:
    """The attempts a head and a chunk make: ``k``, or ``CHUNK`` for None."""
    k = CHUNK if k is None else k
    if k < 1:
        raise ValueError(f"a loop's chunk must be at least 1, not {k}")
    return k


def loop_graph(key, specs, head, chunk, tail, device, kept=None, k=None) -> LoopGraph:
    """The cached ``LoopGraph`` of ``key`` at ``k`` attempts a chunk (the
    current ``CHUNK`` without it), made on first use."""
    k = _chunk(k)
    return _cached((key, k), lambda: LoopGraph(key, specs, head, chunk, tail, device, kept, k))


class EagerLoop:
    """``LoopGraph``'s twin with no capture: it takes what a ``LoopGraph``
    takes and runs the program op by op on its device, the head once,
    then the chunk while the condition holds, with a host read of the
    condition after the head and after each chunk, then the tail.  Its
    inputs load as a ``LoopGraph``'s do (``inputs.upload``, ``inputs.load``:
    the loop is its own ``inputs``): host arrays become tensors of their
    specs (``convert.to_tensor``'s copy), device tensors are taken as they
    are.  ``attempts`` and ``reads`` count as a ``LoopGraph``'s do; nothing
    is added to ``STATS``, and nothing is cached under ``key``."""

    def __init__(self, key, specs, head, chunk, tail, device, kept=None, k=None):
        self.chunk = _chunk(k)
        self.device = torch.device(device)
        self.specs = list(specs)
        self.views = [None] * len(self.specs)
        self._fns = (head, chunk, tail, kept)
        self.attempts = self.reads = 0

    @property
    def inputs(self):
        return self

    def upload(self, arrays) -> None:
        for i, a in enumerate(arrays):
            self.views[i] = torch.as_tensor(np.array(a), dtype=self.specs[i][1],
                                            device=self.device)

    def load(self, tensors, start: int = 0) -> None:
        for i, t in enumerate(tensors, start):
            self.views[i] = t

    def run_tensors(self, keep=()) -> list[torch.Tensor]:
        """Run the loop on the inputs loaded last; copies the ``kept``
        tensors into ``keep`` and returns the tail's outputs as tensors on
        their device."""
        head, chunk, tail, kept = self._fns
        self.attempts, self.reads = self.chunk, 1
        carry, aux, live = head(self.views, self.chunk)
        while bool(live):
            carry, live = chunk(carry, aux, self.chunk)
            self.attempts += self.chunk
            self.reads += 1
        out = tail(carry, aux)
        for dst, src in zip(keep, kept(carry, aux) if kept else []):
            dst.copy_(src)
        return out

    def run(self, keep=()) -> list[np.ndarray]:
        """``LoopGraph.run``: ``run_tensors`` with the outputs as float64
        host arrays."""
        return [t.to(torch.float64).cpu().numpy() for t in self.run_tensors(keep)]


def loop(key, specs, head, chunk, tail, device, kept=None, k=None):
    """The executor of a loop program on ``device``: the cached
    ``LoopGraph`` on a CUDA device, an ``EagerLoop`` elsewhere.  Takes what
    both take."""
    if torch.device(device).type == "cuda":
        return loop_graph(key, specs, head, chunk, tail, device, kept, k)
    return EagerLoop(key, specs, head, chunk, tail, device, kept, k)


class ProgramGraph:
    """One device program, captured once: ``fn(*inputs) -> (outputs,
    kept)``, each a list of tensors.  The inputs are the views of one
    ``Slab`` (``specs``), host arrays first and device tensors after;
    ``outputs`` come back to the host in one copy after each replay,
    ``kept`` are copied into the caller's device tensors.  Safe to call
    from several threads: one call at a time runs a given graph."""

    def __init__(self, key, specs, fn, device):
        self.key = key
        self.device = torch.device(device)
        self.inputs = Slab(specs, self.device)
        self.fn = fn
        self.graph = None
        self.launches = {}        # {counted wrapper: launches} the graph holds
        self.pool_bytes = 0
        self._lock = threading.Lock()

    def _capture(self) -> None:
        def program():
            outs, kept = self.fn(*self.inputs.views)
            return _pack(outs), kept

        def body(stream):
            self.graph, (outs, kept), self.launches = _capture(program, stream)
            self.out, self.kept = _Readback(*outs), list(kept)

        self.pool_bytes = _capture_key(self.device, tuple(v.dtype for v in self.inputs.views),
                                       lambda: self.fn(*self.inputs.views), body)
        _evict(self)

    def run(self, host=(), device=(), keep=()) -> list[np.ndarray]:
        """One call: the inputs loaded (``host`` arrays in one upload, then
        ``device`` tensors), a replay (capturing at the first call), the
        kept tensors copied into ``keep`` (device tensors of theirs), and
        the outputs back as host arrays of their own dtypes (one
        device-to-host copy, which synchronises; none when the program has
        no outputs)."""
        with self._lock:
            host = list(host)
            self.inputs.upload(host)
            self.inputs.load(device, start=len(host))
            if self.graph is None:
                self._capture()
            with trace.span("graph.replay"):
                self.graph.replay()
            _replayed(self.launches)
            STATS["program_replays"] += 1
            for dst, src in zip(keep, self.kept):
                dst.copy_(src)
            if self.out.packed is None:
                return []
            STATS["program_reads"] += 1
            return self.out.read()


def program_graph(key, specs, fn, device) -> ProgramGraph:
    """The cached ``ProgramGraph`` of ``key``, made on first use."""
    return _cached(key, lambda: ProgramGraph(key, specs, fn, device))


def run_eagerly(specs, fn, host=(), device=(), keep=(), on=None) -> list[np.ndarray]:
    """``ProgramGraph.run`` without a graph, on device ``on``: the host
    arrays become tensors of their specs there, ``fn`` runs op by op, the
    kept tensors are copied into ``keep``, the outputs come back as host
    arrays."""
    host = [torch.as_tensor(np.asarray(a), dtype=dt, device=on)
            for a, (_, dt) in zip(host, specs)]
    outs, kept = fn(*host, *device)
    for dst, src in zip(keep, kept):
        dst.copy_(src)
    return [t.cpu().numpy() for t in outs]
