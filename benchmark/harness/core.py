"""The benchmark's run: one process, one cell, one seed.

``main`` resolves the cell by its name in ``BENCHMARK.json`` to its
files (``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json``), checks the card, hands the run to the cell's
entry driver (``drivers/<driver>.py``), which sets up, warms up and
drives the window through ``Run``'s stamps, then judges what the
window's recorders sampled by the judges the workload names
(``reference/judges/<judge>.py``, ``reference/check.py``), reads every metric
the cell reports by its reader (``metrics/<name>.py``) and prints the
result as the last line of standard output.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import os
import random
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "vio_tpu"}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ.setdefault("USE_FLAX", "0")


class Cell:
    """A cell's entries and files, found by its name."""

    def __init__(self, name: str, bench: dict | None = None):
        self.bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
        entries = {w["name"]: w for w in self.bench["workloads"]}
        if name not in entries:
            raise SystemExit(f"no cell {name!r} in BENCHMARK.json: {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config = load_json(BENCH / "configs" / f"{self.entry['config']}.json")
        self.traffic = load_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.workload = load_json(BENCH / "workloads" / f"{name}.json")

    def metrics(self, trace: bool) -> list[dict]:
        """The metrics this cell reports: its end-to-end ones, or with
        ``trace`` its per-layer ones."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or self.name in m["workloads"]]


class Run:
    """What one run stamps, counts and records, for the readers."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t0: float, control: bool = False):
        self.cell = cell
        self.seed = seed
        self.seconds = float(seconds)
        self.trace = trace
        self.device = device
        self.control = control
        self.t0 = t0
        self.frames: list[dict] = []       # window frames: t_in, t_out, ok
        self.window_start = self.window_end = None
        self.spans: dict[str, float] = {}  # summed seconds of the harness's spans
        self.counts: dict[str, float] = {}  # counter deltas over the window
        self.telemetry: list[dict] = []    # the estimator's records of the window
        # what each recorder of ``program`` sampled, by its name; a judge
        # reads one recorder's records
        self.recorded: dict[str, list] = {"frame_steps": []}
        self.trace_summary: dict | None = None
        self.memory_peak = 0
        self.traced_from = None            # the window's first frame in the traced slice
        self.judged: list[tuple] = []      # (judge, its numbers of one record) for each record
        self.check_s = 0.0
        self._warm = 0
        self._last_logged = 0
        self.capture_log: list[str] = []

    # -- warm-up -----------------------------------------------------------
    def warm(self, captures: int) -> bool:
        """Called between warm-up frames with the graph cache's captures so
        far; True once the workload's ``warmup_frames`` have run."""
        self._warm += 1
        self.note_captures(captures)
        return self._warm >= self.cell.workload["warmup_frames"]

    # -- the window ----------------------------------------------------------
    def open_window(self) -> None:
        """The window opens; the set-up's objects (the stream, the frames)
        move out of the collector's way first."""
        gc.collect()
        gc.freeze()
        self.window_start = time.perf_counter()

    def is_open(self) -> bool:
        return time.perf_counter() - self.window_start < self.seconds

    def frame(self, t_in: float, t_out: float | None, ok: bool,
              captures: int | None = None) -> None:
        self.frames.append(dict(t_in=t_in, t_out=t_out, ok=ok))
        if captures is not None:
            self.note_captures(captures)

    def note_captures(self, n: int) -> None:
        """Log the frames at which the graph cache captured (warm-up frames
        counted from 1, window frames as w<k>)."""
        if n != self._last_logged:
            where = f"w{self.n_frames}" if self.window_start is not None else str(self._warm)
            self.capture_log.append(f"{where}:{n}")
            self._last_logged = n

    def close_window(self) -> None:
        self.window_end = self.window_start + self.seconds
        gc.unfreeze()

    def span(self, name: str, seconds: float) -> None:
        self.spans[name] = self.spans.get(name, 0.0) + seconds

    def exhausted(self, n_frames: int) -> None:
        ceiling = self.cell.workload["ceiling_frames_per_s"]
        raise SystemExit(f"the stream ran out after {n_frames} frames with the window "
                         f"still open: it is sized for {ceiling} frames/s over "
                         f"{self.seconds:g} s (ceiling_frames_per_s in "
                         f"workloads/{self.cell.name}.json)")

    # -- what the judges and the readers use ----------------------------------
    @property
    def records(self) -> list:
        """The sampled frame steps (inputs, outputs)."""
        return self.recorded["frame_steps"]

    @records.setter
    def records(self, items: list) -> None:
        self.recorded["frame_steps"] = items

    @property
    def reference_device(self) -> str:
        """Where the plain references run: on the card where the run does."""
        return "cpu" if self.device == "cpu" else "cuda"

    @property
    def setup_s(self) -> float:
        return self.window_start - self.t0

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    @property
    def host_frames(self) -> int:
        """The window's frames before the traced slice, which the host-clock
        spans and the telemetry readers average over."""
        return self.n_frames if self.traced_from is None else self.traced_from

    def host_telemetry(self) -> list[dict]:
        """The estimator's records of the frames before the traced slice."""
        return self.telemetry[:self.host_frames]


class Sampler:
    """Keeps ``k`` items of a stream of unknown length, each equally
    likely (reservoir sampling), drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.n = 0

    def offer(self, make):
        """Keep the item that ``make()`` builds, or skip it unbuilt."""
        if self.n < self.k:
            self.items.append(make())
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.items[j] = make()
        self.n += 1


def _forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _device_info(run: Run) -> dict:
    import torch
    if run.device == "cpu":
        info = dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    else:
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=run.cell.chips, memory_peak_bytes=int(run.memory_peak))
    if run.trace and run.trace_summary is not None:
        info["busy_s"] = run.trace_summary["busy_s"]
        info["window_s"] = run.trace_summary["window_s"]
    return info


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the benchmark) or cpu (the harness's own tests)")
    return ap.parse_args(argv)


def execute(args, t0: float, cell: Cell | None = None, control: bool = False,
            patch=None) -> dict:
    """Set up, run and judge one cell; returns the result line's object.
    ``control`` runs the cell's precision control in the program's place
    (``readings.py --control-seeds``); ``patch(run)`` is called once the
    system is built (the harness's fault tests break the timed path
    there)."""
    cell = cell or Cell(args.workload)
    import torch
    if args.device != "cpu":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"cell {cell.name} needs {cell.chips} CUDA device(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    run = Run(cell, args.seed, args.seconds, bool(args.trace), args.device, t0, control)
    driver = importlib.import_module(f"benchmark.drivers.{cell.workload['driver']}")
    driver.run(run, patch)
    if args.device != "cpu":
        torch.cuda.synchronize()
        run.memory_peak = torch.cuda.max_memory_allocated()
    driver.release(run)

    from benchmark.reference import check
    t_check = time.perf_counter()
    numbers = check.evaluate(run)
    run.check_s = time.perf_counter() - t_check
    metrics = {}
    for m in cell.metrics(run.trace):
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        v = reader.read(run)
        if v is not None:
            if not math.isfinite(v):
                raise SystemExit(f"metric {m['name']} read {v}")
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    out = dict(correct=all(n["value"] is not None and n["value"] <= n["limit"]
                            for n in numbers.values()),
               attempted=run.n_frames,
               failed=sum(not f["ok"] for f in run.frames),
               metrics=metrics, device=_device_info(run))
    if run.trace and run.trace_summary is not None:
        out["breakdown"] = dict(device_ops=run.trace_summary["device_ops"],
                                idle_gaps=run.trace_summary["idle_gaps"])
        out["card"] = run.trace_summary.get("card")
    out["check"] = numbers
    out["_run"] = run
    return out


def report(out: dict) -> None:
    """The run's account on standard error (its last lines: each number
    compared, with its limit), then the result line on standard output."""
    run = out.pop("_run")
    c = run.counts
    print(f"run: warm-up {run._warm} frames, setup {run.setup_s:.3f} s, window "
          f"{run.n_frames} frames, captures in the window {c.get('captures')}, "
          f"check {run.check_s:.3f} s over {len(run.judged)} records", file=sys.stderr)
    print("captures (frame:total): " + " ".join(run.capture_log), file=sys.stderr)
    if run.trace_summary is not None:
        print(f"trace: reduced in {run.trace_summary['reduce_s']:.3f} s, card "
              f"{run.trace_summary['card']}, counters {run.trace_summary['counters']}",
              file=sys.stderr)
    for name, j in run.judged:
        print(f"{name}: " + " ".join(f"{k} {v!r}" for k, v in j.items()), file=sys.stderr)
    for name, n in out["check"].items():
        print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=sys.stderr)
    # the last gate before the result: whatever the run loaded, the
    # reference and the readers included
    bad = _forbidden_modules()
    if bad:
        raise SystemExit(f"modules loaded in the run's process that the benchmark "
                         f"forbids: {bad}")
    print(json.dumps(out), flush=True)


def main(argv, t0: float) -> int:
    cache_env()
    report(execute(parse(argv), t0))
    return 0
