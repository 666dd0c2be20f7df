"""The traced run's device trace and the harness's spans.

``Tracer`` runs ``torch.profiler`` over the last ``trace_seconds`` of the
window (the workload's file) and the harness's spans (``span``) over the
frames before it: while the profiler runs, a span marks the trace with a
``bench.<name>`` range; before it, a span adds its host seconds to
``Run.spans``, so that the profiler's own cost is in none of the
host-clock readings.  Once the window has closed, the trace is written
as Chrome JSON to a fixed file under ``benchmark/.cache`` and ``summary``
reduces it to the device's busy seconds (the union of its kernels,
copies and fills), the slice's length, the device operations that took
most time, the idle gaps summed by the innermost span open across them,
and the device seconds of kernels by name, beside the program's counters
read at the slice's ends.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import time

from benchmark.harness.core import BENCH

SPAN_PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    def __init__(self, run, counters):
        """``counters()`` returns the program's counters as a dict."""
        self.run = run
        self.on = run.trace and run.device != "cpu"
        self.counters = counters
        self.prof = None
        self.done = False
        self.c0 = None

    @contextlib.contextmanager
    def span(self, name: str):
        r = self.run
        if not r.trace or r.window_start is None or r.window_end is not None or self.done:
            yield
            return
        if self.prof is not None:
            import torch
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
            return
        t = time.perf_counter()
        yield
        r.span(name, time.perf_counter() - t)

    def tick(self) -> None:
        """After each window frame: start the profiler once the window's
        last ``trace_seconds`` have begun."""
        r = self.run
        if not self.on or self.prof is not None or self.done:
            return
        left = r.seconds - (time.perf_counter() - r.window_start)
        if left > float(r.cell.workload["trace_seconds"]):
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        r.traced_from = r.n_frames
        self.c0 = self.counters()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.slice = torch.profiler.record_function(SPAN_PREFIX + "slice")
        self.slice.__enter__()

    def stop(self) -> None:
        """At the window's close: end the slice and reduce its trace."""
        if self.prof is None:
            return
        import torch
        torch.cuda.synchronize()
        self.slice.__exit__(None, None, None)
        c1 = self.counters()
        prof, self.prof, self.done = self.prof, None, True
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        path = BENCH / ".cache" / "trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            path.unlink(missing_ok=True)
        s = summary(events)
        s["counters"] = {k: c1[k] - self.c0[k] for k in self.c0}
        s["card"] = card()
        s["reduce_s"] = time.perf_counter() - t
        self.run.trace_summary = s


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summary(events) -> dict:
    """The traced slice reduced, from Chrome trace events (µs): busy and
    window seconds, the top device operations and idle gaps, device
    seconds by kernel name."""
    dev, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((name, t0, t1))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            if name == SPAN_PREFIX + "slice":
                window = (t0, t1)
            else:
                spans.append((name[len(SPAN_PREFIX):], t0, t1))
    if window is None:
        raise RuntimeError("the trace holds no bench.slice range")
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in dev])
    by_name: dict[str, float] = {}
    for n, s, e in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps, each named by the innermost span open across its middle
    spans.sort(key=lambda x: x[1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps: dict[str, float] = {}
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        inner = None
        for n, ss, se in spans:
            if ss > mid:
                break
            if se >= mid:
                inner = n
        name = inner or "harness"
        gaps[name] = gaps.get(name, 0.0) + (e - s) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=sum(e - s for s, e in busy) * 1e-6, window_s=(w1 - w0) * 1e-6,
                device_ops=[[n, v] for n, v in ops], idle_gaps=[[n, v] for n, v in idle],
                kernel_s=by_name)


def kernel_seconds(summary_: dict, *parts: str) -> float:
    """Device seconds of the kernels whose names hold any of ``parts``."""
    return sum(v for n, v in summary_["kernel_s"].items() if any(p in n for p in parts))


def card() -> dict | None:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    name, limit = (x.strip() for x in out[0].split(","))
    return dict(name=name, power_limit=limit)
