"""Global BA's solve and Jacobi-PCG as captured CUDA graphs
(``vio_tpu_torch/solver/graph.py``) against their eager twins.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_global_ba_graph_profile.py [--phases] [--no-1m] [--no-fresh]
                                                     [--device cpu]

1. ``--phases``: ``chip_smoke.py``'s phases 11, 12 and 24 alone, with
   their holds and lines (the kernels are built first);
2. ``turns``: ``global_ba.solve`` (graphed on the card) and
   ``chip_smoke.global_ba_eager`` (the program on ``graph.EagerLoop``) in turns (eager, graphed, graphed, eager) at
   the bench's 100-keyframe problem (float32, max_iter 10) and at phase
   12's 1,048,576 observation slots (float32, max_iter 8; ``--no-1m``
   leaves it out): each turn's wall ms a solve (host clock around a
   synchronised solve, the mean of 3 after a warm one) and device ms
   (``torch.profiler``'s device events over one solve), with the
   iterations, replays and reads;
3. ``pcg``: PCG's chunk (``pcg.CHUNK``, iterations between two host
   reads) in {1, 8, 32, 128} at P = 600 and 1200 in float32 and float64
   on phase 24's systems: wall and device ms a solve, iterations, reads,
   and the result's bits against K = 1's;
4. ``fresh`` (on the card; ``--no-fresh`` leaves it out): what a key
   costs where shapes do not repeat.  Two new processes (the kernels
   already built) each solve the 100-keyframe problem first, one graphed
   and one eager: the first call's wall with the capture seconds (the
   thread's warm-up included); then the graphed one grows the map a
   keyframe at a time (N = 101-105, M = 4N): each size's first graphed
   call (a fresh key in a warm thread), its second (replays only) and
   the eager solve of that size.

Every time is the card's, printed with its name and power limit, and two
versions are compared only within one call.  ``--device cpu`` rehearses
2 and 3 at small sizes; there the "graphed" solve is the CPU's eager one
and the times say nothing of the card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from vio_tpu_torch import bench, testing  # noqa: E402
from vio_tpu_torch.device import resolve  # noqa: E402
from vio_tpu_torch.ops import _build  # noqa: E402
from vio_tpu_torch.parallel import global_ba  # noqa: E402
from vio_tpu_torch.solver import graph, pcg  # noqa: E402

CHUNKS = (1, 8, 32, 128)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, device, n: int = 3) -> float:
    """Mean host milliseconds of ``n`` synchronised calls after a warm one."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        sync(device)
    return 1e3 * (time.perf_counter() - t0) / n


def turns(label, p, kw, device, tag) -> None:
    """Eager, graphed, graphed, eager on one problem."""
    runs = {"eager": lambda: chip_smoke.global_ba_eager(p, **kw),
            "graphed": lambda: global_ba.solve(p, **kw)}
    for name in ("eager", "graphed", "graphed", "eager"):
        fn = runs[name]
        ms = wall_ms(fn, device)
        dev = bench.device_ms(fn, 1, device)
        s0 = dict(graph.STATS)
        _, st = fn()
        d = {k: graph.STATS[k] - s0.get(k, 0) for k in ("replays", "reads")}
        reads = st["reads"]
        dev_s = f"{dev:.3f}" if dev is not None else "not measured"
        print(f"{label} {name}: wall {ms:.3f} ms, device {dev_s} ms a solve, "
              f"{st['iterations']} iterations, {d['replays']} replays, {reads} reads {tag}")


def pcg_sweep(P, dtype, device, tag) -> None:
    Hn, bn = chip_smoke.spd_system(P, chip_smoke.PCG_COND, seed=P)
    H = torch.as_tensor(Hn, dtype=dtype, device=device)
    b = torch.as_tensor(bn, dtype=dtype, device=device)
    rtol = chip_smoke.PCG_RTOL[dtype]
    ref = None
    saved = pcg.CHUNK
    try:
        for k in CHUNKS:
            pcg.CHUNK = k
            fn = lambda: pcg.pcg_solve(H, b, rtol=rtol)  # noqa: E731
            ms = wall_ms(fn, device)
            dev = bench.device_ms(fn, 1, device)
            s0 = dict(graph.STATS)
            x, its = fn()
            reads = graph.STATS["reads"] - s0.get("reads", 0)
            ref = x if ref is None else ref
            same = torch.equal(x, ref)
            dev_s = f"{dev:.3f}" if dev is not None else "not measured"
            print(f"pcg {str(dtype)[6:]} P={P} K={k}: wall {ms:.3f} ms, device {dev_s} ms a "
                  f"solve, {its} iterations, {reads} reads, bits equal to K=1's: {same} {tag}")
            if not same:
                raise AssertionError(f"pcg P={P} K={k}: the chunk changed the result")
    finally:
        pcg.CHUNK = saved


def timed(fn) -> tuple[float, float, object]:
    """(wall ms of one synchronised call, the capture seconds it added,
    its stats)."""
    c0 = graph.STATS["capture_s"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), graph.STATS["capture_s"] - c0, st


def fresh(first: str, tag: str) -> None:
    """A new process's first solve (``first``: graphed or eager) at 100
    keyframes, then the other route; after a graphed start, the map grows
    a keyframe at a time."""
    _build.load()
    kw = dict(max_iter=10, fix_frames=2, loss_delta=50.0, dtype=torch.float32)

    def problem(N):
        gt, _ = testing.make_global_problem(N=N, M=4 * N, obs_per_lm=8, dtype=torch.float32)
        return testing.perturb_global(gt, **chip_smoke.GLOBAL_PERTURB)

    routes = {"graphed": global_ba.solve, "eager": chip_smoke.global_ba_eager}
    p = problem(100)
    for i, name in enumerate((first, "eager" if first == "graphed" else "graphed")):
        ms, cap, st = timed(lambda: routes[name](p, **kw))
        print(f"fresh process, {'first' if i == 0 else 'second'} solve at 100 kf: {name} "
              f"{ms:.3f} ms wall, {cap:.3f} s of it capturing, {st['iterations']} "
              f"iterations {tag}")
    if first != "graphed":
        return
    for N in range(101, 106):
        p = problem(N)
        ms1, cap, _ = timed(lambda: global_ba.solve(p, **kw))
        ms2, _, _ = timed(lambda: global_ba.solve(p, **kw))
        ms_e, _, st = timed(lambda: chip_smoke.global_ba_eager(p, **kw))
        print(f"growing map N={N}: graphed first call {ms1:.3f} ms ({cap:.3f} s capturing, "
              f"a fresh key in a warm thread), second {ms2:.3f} ms; eager {ms_e:.3f} ms; "
              f"{st['iterations']} iterations; pools {graph.STATS['pool_bytes'] / 2**20:.1f} "
              f"MiB over {graph.STATS['keys']} keys {tag}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--no-1m", action="store_true")
    ap.add_argument("--no-fresh", action="store_true")
    ap.add_argument("--fresh", choices=("graphed", "eager"), help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    device, _ = resolve(args.device)
    cuda = device.type == "cuda"
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip()
        tag = f"[{smi.splitlines()[0]}]"
        info = _build.build()
        _build.load()
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc "
              f"{info['seconds']:.2f} s; graph.CHUNK {graph.CHUNK}, pcg.CHUNK {pcg.CHUNK} {tag}")
    else:
        tag = "[CPU rehearsal, no device numbers]"
    if args.fresh:
        fresh(args.fresh, tag)
        return 0
    if args.phases:
        if not cuda:
            raise SystemExit("--phases runs chip_smoke's phases on a CUDA device")
        t0 = time.perf_counter()
        _, gba64 = chip_smoke.global_ba_one_card(tag)
        chip_smoke.global_ba_scaling_size(tag)
        graph.clear()
        torch.cuda.empty_cache()
        chip_smoke.pcg_on_card(tag, gba64)
        print(f"phases 11, 12, 24 took {time.perf_counter() - t0:.1f} s {tag}")

    sizes = [("100 kf", chip_smoke.GLOBAL_BENCH,
              dict(max_iter=10, fix_frames=2, loss_delta=50.0))]
    if not args.no_1m:
        sizes.append(("1M obs", chip_smoke.GLOBAL_SCALING, dict(max_iter=8, fix_frames=2)))
    if not cuda:
        sizes = [("16 kf (rehearsal)", dict(N=16, M=64, obs_per_lm=4), sizes[0][2])]
    for label, size, kw in sizes:
        gt, _ = testing.make_global_problem(**size, device=device, dtype=torch.float32)
        p = testing.perturb_global(gt, **chip_smoke.GLOBAL_PERTURB)
        turns(f"global BA {label} float32", p, dict(kw, device=device, dtype=torch.float32),
              device, tag)
        if cuda:
            g = {k: graph.STATS[k] for k in ("keys", "captures", "capture_s", "pool_bytes")}
            print(f"graphs so far: {g['keys']} keys, {g['captures']} captures in "
                  f"{g['capture_s']:.3f} s, pools {g['pool_bytes'] / 2**20:.1f} MiB {tag}")
        del gt, p
        graph.clear()
        if cuda:
            torch.cuda.empty_cache()
    for P in (chip_smoke.PCG_SIZES if cuda else (60,)):
        for dtype in (torch.float32, torch.float64):
            pcg_sweep(P, dtype, device, tag)
    if cuda and not args.no_fresh:
        for first in ("graphed", "eager"):
            sys.stdout.flush()
            subprocess.run([sys.executable, __file__, "--fresh", first], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
