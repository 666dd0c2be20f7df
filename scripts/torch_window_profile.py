"""Where a bench window solve goes on a CUDA device, at F=256 and F=1024
feature slots (``vio_tpu_torch.bench``'s two window stages: the same 84
features and 840 live factors in a grid 4× larger).

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_window_profile.py [--device cpu]

For each F: the wall ms per solve (``bench.wall_ms``, CUDA events), then
one solve traced by ``torch.profiler`` (CPU and CUDA): the operator calls,
device kernels, copies and fills, their summed device time, and the
operators that take the most host time, with their call counts; then
the dense products (``aten.mm``) of one solve by shape, with their flops
(2·m·k·n, counted from the shapes).  The last section lists the
operators whose host time grows most from F=256 to F=1024.  ``--device
cpu`` rehearses it (float64): host numbers and the counts only, "not
measured" for every device number.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_tpu_torch import bench  # noqa: E402
from vio_tpu_torch.device import resolve  # noqa: E402

SIZES = (256, 1024)
TOP = 12


class MatmulShapes(TorchDispatchMode):
    """Flops of every ``aten.mm`` by (m, k, n)."""

    def __init__(self):
        super().__init__()
        self.flops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            (m, k), n = args[0].shape, args[1].shape[1]
            self.flops[(m, k, n)] += 2 * m * k * n
        return func(*args, **(kwargs or {}))


def one(F: int, device, dtype) -> dict:
    states, f, pert, n_obs, live = bench.window_problem(F, device, dtype)

    def step():
        return bench.window_solve(states, f, pert, n_obs)

    wall = bench.wall_ms(step, 5, device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        step()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ops = {a.key: (a.count, a.self_cpu_time_total / 1e3) for a in prof.key_averages()
           if a.key.startswith("aten::")}
    print(f"F={F}: live {live}, n_obs {n_obs}, wall {wall:.3f} ms a solve, "
          f"{sum(c for c, _ in ops.values())} aten calls, host self time of aten ops "
          f"{sum(t for _, t in ops.values()):.3f} ms (traced)")
    if dev:
        print(f"F={F}: {len(dev)} device events, device {sum(e.time_range.elapsed_us() for e in dev) / 1e3:.3f} ms")
    else:
        print(f"F={F}: device events not measured")
    for k, (c, t) in sorted(ops.items(), key=lambda kv: -kv[1][1])[:TOP]:
        print(f"  {k}: {c} calls, {t:.3f} ms host")
    shapes = MatmulShapes()
    with shapes:     # eagerly: a graph's replay dispatches no operator
        bench.window_solve(states, f, pert, n_obs, eager=True)
    print(f"F={F}: aten.mm {sum(shapes.flops.values()) / 1e9:.3f} GFLOP a solve, by (m, k, n):")
    for (m, k, n), fl in shapes.flops.most_common(4):
        print(f"  ({m} x {k})·({k} x {n}): {fl / 1e9:.3f} GFLOP")
    return ops


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    device, dtype = resolve(args.device)
    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    small, large = (one(F, device, dtype) for F in SIZES)
    print(f"host time that grows from F={SIZES[0]} to F={SIZES[1]} (traced):")
    grow = {k: (large[k][1] - small.get(k, (0, 0.0))[1], small.get(k, (0, 0.0))[0], large[k][0])
            for k in large}
    for k, (dt, c0, c1) in sorted(grow.items(), key=lambda kv: -kv[1][0])[:TOP]:
        print(f"  {k}: +{dt:.3f} ms ({c0} → {c1} calls)")


if __name__ == "__main__":
    main()
