"""A cell run on the CPU at a size a test can hold: a short warm-up and
window, the same harness and judges."""
import time

from benchmark.harness import core


def run_cell(name: str, seed: int, seconds: float = 2.5, trace: bool = False,
             control: bool = False, patch=None, warm: int = 30) -> dict:
    cell = core.Cell(name)
    cell.workload["warmup_frames"] = warm
    cell.workload["check"]["sample_frames"] = 6
    args = core.parse(["--workload", name, "--seed", str(seed), "--seconds", str(seconds),
                       "--trace", str(int(trace)), "--device", "cpu"])
    out = core.execute(args, time.perf_counter(), cell=cell, control=control, patch=patch)
    out.pop("_run")
    return out
