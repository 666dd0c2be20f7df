"""Spans of the port's host work, on the telemetry's clock and the
profiler's.

``span(name)`` times a block of host work.  It always adds the block's
seconds and one opening to the calling thread's totals under ``name``;
only while a ``torch.profiler`` is recording does it also open a
``record_function("vio." + name)`` range, which puts the block on the
same trace as the card's kernels and copies.  With no profiler running a
span costs two ``perf_counter`` calls and a dict update, and never enters
``record_function``.

The totals are per thread, so one thread's spans never enter another's
record: ``runner.run_images_async``'s tracker thread opens its own.  The
estimator takes ``mark()`` before a frame and ``since(mark)`` after it,
and writes the difference into the frame's telemetry record
(``Estimator.process_image``).

Spans by name (``est.*`` in ``estimator.py``, ``graph.*`` in
``solver/graph.py``, ``loop.*`` in ``loop/closer.py``):

- ``est.frame``: ``process_image``, the whole call;
- ``est.features``: the rolling-shutter shift, the feature manager's
  parallax check, the frame record, the extrinsic calibration;
- ``est.triangulate``: ``fm.triangulate``;
- ``est.pack``: the host pack of the frame step's inputs;
- ``est.step``: the frame step (graphed on the card; eager and fetched on
  the CPU), the ``graph.*`` spans inside it;
- ``est.unpack``: the solution back into the estimator's state;
- ``est.outliers``: the post-solve reprojection gate's flags;
- ``est.prior``: the host float64 prior chain, its forgetting and the
  solve's record (``marg_ms``);
- ``est.slide``: failure detection, td, the window slide, the last pose;
- ``est.loop``: with loop closing, the keyframe handed to the closer
  (its landmarks and ``LoopCloser.add_keyframe``), the ``loop.*`` inside;
- ``loop.query``: the closer's vocabulary training, database insert and
  query;
- ``loop.verify``: a retrieved loop's Hamming match and two PnP solves;
- ``loop.solve``: the pose-graph solve after an accepted loop;
- ``graph.upload``: a ``Slab``'s staging writes and its copy to the card;
- ``graph.replay``: a captured graph's replay, enqueued;
- ``graph.wait``: the host blocked on a read of the loop's condition or
  of a graph's outputs;
- ``graph.capture``: a key's warm-up and capture (``STATS["capture_s"]``).
"""
from __future__ import annotations

import threading
import time

import torch

PREFIX = "vio."

_local = threading.local()


def _totals() -> dict:
    """The calling thread's [seconds, openings] by span."""
    t = getattr(_local, "totals", None)
    if t is None:
        t = _local.totals = {}
    return t


class span:
    """``with span("est.pack"): ...``: the block's host seconds into the
    thread's totals (and, once it ends, into ``.seconds``), and a
    ``vio.est.pack`` range on a recording profiler's trace."""

    __slots__ = ("name", "t0", "rf", "seconds")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        spans = _totals()
        s = spans.get(self.name)
        if s is None:
            spans[self.name] = [dt, 1]
        else:
            s[0] += dt
            s[1] += 1
        return False


def mark() -> dict:
    """The thread's totals now, for ``since``."""
    return {k: tuple(v) for k, v in _totals().items()}


def since(m: dict) -> dict:
    """The seconds by span that the thread added after ``mark()`` gave
    ``m``, for each span opened since."""
    secs = {}
    for k, (s, n) in _totals().items():
        s_was, n_was = m.get(k, (0.0, 0))
        if n != n_was:
            secs[k] = s - s_was
    return secs
