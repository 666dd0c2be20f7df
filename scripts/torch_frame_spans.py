"""Where the card's idle time goes, by the port's ``vio.`` ranges
(``vio_tpu_torch/trace.py``): one traced run of a benchmark cell.

    python3 scripts/torch_frame_spans.py --seed <n> [--workload sim_features]
        [--seconds 16] [--device cuda] [--out frame_spans.jsonl]

Runs the cell as ``benchmark/run.py --trace 1`` does (the same harness,
warm-up, window, judges and readers) and keeps the traced slice's Chrome
events on their way to the harness's reduction.  It prints one JSON line
(and appends it to ``--out``):

- ``metrics``: the cell's per-layer metrics, as the harness read them;
- ``program_gaps``: the slice's device idle seconds, each instant of a
  gap put down to the innermost ``vio.`` range open over it, ``outside``
  where none is (the top ten, as ``program_idle_gaps``);
- ``replay_idle_pct`` (``graph.wait``'s gaps: the card idle while the host
  waits on work it has enqueued), ``host_idle_pct`` (every other range's:
  the card waiting on the host's own work) and ``outside_idle_pct``, as
  shares of the slice, beside the harness's ``idle_gaps``.

On the CPU (``--device cpu``, a short warm-up) it rehearses the path:
nothing is traced there, so the idle numbers are absent.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_v] = "1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PREFIX = "vio."


def _innermost(spans, w0, w1) -> list[tuple[float, float, str | None]]:
    """The slice cut into pieces, each with the innermost range open over
    it (the latest started of those open; None where none is)."""
    marks = sorted([(s, 1, i) for i, (_, s, _e) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, _s, e) in enumerate(spans)])
    pieces, open_, t = [], [], w0
    for x, starts, i in marks:
        x = min(max(x, w0), w1)
        if x > t:
            pieces.append((t, x, spans[open_[-1]][0] if open_ else None))
            t = x
        if starts:
            open_.append(i)
        else:
            open_.remove(i)
    if t < w1:
        pieces.append((t, w1, spans[open_[-1]][0] if open_ else None))
    return pieces


def program_gaps(events) -> dict:
    """The slice's idle seconds by the innermost ``vio.`` range open over
    each instant of each gap (``outside`` where none is), from Chrome
    trace events (µs), with the harness's slice and device categories."""
    from benchmark.harness.trace import DEVICE_CATS, SPAN_PREFIX, _union
    dev, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((t0, t1))
        elif cat == "user_annotation":
            if name == SPAN_PREFIX + "slice":
                window = (t0, t1)
            elif name.startswith(PREFIX):
                spans.append((name[len(PREFIX):], t0, t1))
    if window is None:
        raise RuntimeError("the trace holds no slice range")
    w0, w1 = window
    busy = _union([(max(s, w0), min(e, w1)) for s, e in dev if e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    gaps: dict[str, float] = {}
    j = 0
    for s, e, name in _innermost(spans, w0, w1):
        while j < len(idle) and idle[j][1] <= s:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < e:
            d = min(e, idle[k][1]) - max(s, idle[k][0])
            if d > 0:
                gaps[name or "outside"] = gaps.get(name or "outside", 0.0) + d * 1e-6
            k += 1
    return gaps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="sim_features")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=16.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warmup-frames", type=int, default=None,
                    help="override the cell's warm-up (a CPU rehearsal's short one)")
    ap.add_argument("--out", default=None, help="JSONL file the line is appended to")
    a = ap.parse_args(argv)

    from benchmark.harness import core
    from benchmark.harness import trace as htrace
    core.cache_env()
    kept = {}
    reduce = htrace.summary

    def keep(events):
        kept["events"] = events
        return reduce(events)

    htrace.summary = keep
    cell = core.Cell(a.workload)
    if a.warmup_frames is not None:
        cell.workload["warmup_frames"] = a.warmup_frames
    args = core.parse(["--workload", a.workload, "--seed", str(a.seed), "--seconds",
                       str(a.seconds), "--trace", "1", "--device", a.device])
    out = core.execute(args, T0, cell=cell)
    run = out.pop("_run")

    line = dict(workload=a.workload, seed=a.seed, device=out["device"], card=out.get("card"),
                correct=out["correct"], attempted=out["attempted"], failed=out["failed"],
                metrics={k: v["value"] for k, v in out["metrics"].items()})
    if "events" in kept:
        s = run.trace_summary
        gaps = program_gaps(kept["events"])
        w = s["window_s"]
        line.update(
            window_s=w, busy_s=s["busy_s"],
            program_idle_gaps=sorted(([n, v] for n, v in gaps.items()),
                                     key=lambda x: -x[1])[:10],
            replay_idle_pct=100.0 * gaps.get("graph.wait", 0.0) / w,
            host_idle_pct=100.0 * sum(v for n, v in gaps.items()
                                      if n not in ("graph.wait", "outside")) / w,
            outside_idle_pct=100.0 * gaps.get("outside", 0.0) / w,
            idle_gaps=s["idle_gaps"])
    text = json.dumps(line)
    print(text, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
