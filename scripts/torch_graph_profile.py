"""The LM loop and the estimator's frame as captured CUDA graphs
(``vio_tpu_torch/solver/graph.py``) against the eager path, on a CUDA
device, in float32.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_graph_profile.py [--quick] [--full]

1. ``capture``: the bench's window solve (W=10, F=256, 840 live factors,
   10 forced iterations) graphed and eager: iterations, max |ΔPs|;
2. ``frames``: the first post-init frames of ``run_sim`` graphed, each
   rerun through the eager ``frame_step``: iterations and max |Δstates|;
3. ``window``: wall ms a solve (CUDA events around back-to-back solves),
   device ms (``torch.profiler`` device events) and host operator calls
   (``aten::`` events under the profiler), eager against graphed;
4. ``chunk``: K in {1, 2, 4, 8} attempts between reads, for the window
   solve (attempts made, wasted after the loop ended, reads, wall ms) and
   for a 150-frame ``run_sim`` (frames/s, attempts, reads, replays a frame);
5. ``e2e``: ``bench.bench_e2e_sim`` (120 frames after a 30-frame warm run,
   device ms of 4 traced post-init frames, busy share) eager, graphed with
   vio_tpu's IMU bucket (32, floor 64) and graphed with the port's
   (``estimator.IMU_BUCKET``), and for each the keys, captures, capture
   seconds and the graph pools' memory;
6. ``--full`` adds the keys a 600-frame run creates.

``--quick`` stops after 2, ``--e2e-only`` leaves out 3 and 4.  The
graphed runs use ``graph.CHUNK`` as the package sets it.  Every time is
the card's, printed with its name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_tpu_torch import bench, estimator, metrics, runner, sim  # noqa: E402
from vio_tpu_torch.ops import linsolve  # noqa: E402
from vio_tpu_torch.solver import frame_step, graph  # noqa: E402

N_FRAMES = 150
WINDOW_SOLVES = 10
CHUNKS = (1, 2, 4, 8)


def eager_frame(*args, **kw):
    return frame_step.fetch(frame_step.frame_step(*args, **kw))


def fresh(chunk: int) -> None:
    graph.clear()
    graph._WARM.clear()
    graph.reset_stats()
    graph.CHUNK = chunk


def traced(fn, device):
    """(device ms, aten calls) of one call under the profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    dev = sum(e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA) / 1e3
    calls = sum(a.count for a in prof.key_averages() if a.key.startswith("aten::"))
    return dev, calls


def window_case(device):
    states, f, pert, n_obs, live = bench.window_problem(bench.WINDOW_F, device)
    solve = {m: (lambda m=m: bench.window_solve(states, f, pert, n_obs, eager=(m == "eager")))
             for m in ("eager", "graphed")}
    return states, f, pert, n_obs, live, solve


def capture_check(device, tag) -> None:
    *_, solve = window_case(device)
    Ps_e, chi_e, it_e = solve["eager"]()
    fresh(graph.CHUNK)
    Ps_g, chi_g, it_g = solve["graphed"]()
    d = float((Ps_g.double() - Ps_e.double()).abs().max())
    print(f"capture: window solve graphed: iterations {it_g} (eager {int(it_e)}), chi2 "
          f"{float(chi_g):.6e} (eager {float(chi_e):.6e}), max |dPs| {d:.3e} m, gj_solve "
          f"launches held by each graph "
          f"{[{n: c.get(linsolve.gj_solve, 0) for n, c in g.launches.items()} for g in graph._CACHE.values()]} {tag}")


def frames_check(data, tag) -> None:
    fresh(graph.CHUNK)
    rec = []
    orig = frame_step.frame_step_graphed

    def recording(*args, **kw):
        out = orig(*args, **kw)
        rec.append((args, kw, out))
        return out

    frame_step.frame_step_graphed = recording
    try:
        runner.run_sim(data, n_frames=40)
    finally:
        frame_step.frame_step_graphed = orig
    worst = 0.0
    for args, kw, out in rec[:8]:
        ref = eager_frame(*args, **kw)
        d = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(out.states, ref.states))
        worst = max(worst, d)
        print(f"frames: n_obs {kw['n_obs']} M {args[1].shape[1]} marg_old {kw['marg_old']}: "
              f"iterations {out.iterations} eager {ref.iterations}, max |dstates| {d:.3e} {tag}")
    print(f"frames: {len(rec)} graphed frames, largest |dstates| of the first 8 {worst:.3e}; "
          f"keys {len(graph.cached_keys())}, captures {graph.STATS['captures']}, "
          f"{graph.STATS['capture_s']:.2f} s capturing, pools {graph.STATS['pool_bytes'] / 2**20:.1f} MiB {tag}")


def window_compare(device, tag) -> None:
    fresh(graph.CHUNK)
    *_, solve = window_case(device)
    for m in ("eager", "graphed", "graphed", "eager"):
        wall = bench.wall_ms(solve[m], WINDOW_SOLVES, device)
        dev, calls = traced(solve[m], device)
        print(f"window {m}: wall {wall:.3f} ms a solve, device {dev:.3f} ms, "
              f"{calls} aten calls a solve (traced) {tag}")


def chunk_sweep(data, device, tag) -> None:
    chosen = graph.CHUNK
    *_, solve = window_case(device)
    base = None
    for k in CHUNKS:
        fresh(k)
        solve["graphed"]()                         # capture
        s0 = dict(graph.STATS)
        wall = bench.wall_ms(solve["graphed"], WINDOW_SOLVES, device)
        n = WINDOW_SOLVES + 1
        att = (graph.STATS["attempts"] - s0.get("attempts", 0)) / n
        reads = (graph.STATS["reads"] - s0.get("reads", 0)) / n
        base = att if base is None else base
        print(f"chunk K={k} window: {att:.1f} attempts a solve ({att - base:.1f} wasted), "
              f"{reads:.1f} reads, wall {wall:.3f} ms {tag}")
    base = None
    for k in CHUNKS:
        fresh(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est, traj = runner.run_sim(data, n_frames=N_FRAMES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = len(est.telemetry)
        att = graph.STATS["attempts"]
        base = att if base is None else base
        gt, _ = runner.sim_ground_truth_at(data, traj["t"])
        print(f"chunk K={k} run_sim {N_FRAMES} frames: {N_FRAMES / wall:.3f} frames/s "
              f"(captures included: {graph.STATS['captures']} graphs, "
              f"{graph.STATS['capture_s']:.2f} s), {att / n:.2f} attempts a solve "
              f"({(att - base) / n:.2f} wasted), {graph.STATS['reads'] / n:.2f} reads, "
              f"{graph.STATS['replays'] / n:.2f} replays a solve, APE "
              f"{metrics.ape_rmse(traj['p'], gt)['rmse']:.6f} m {tag}")
    graph.CHUNK = chosen


def jax_bucket(pack):
    """``Estimator._pack_imu_raw`` padded further to vio_tpu's capacity:
    the configured 64, or the longest buffer rounded up to 32."""
    def packed(self):
        dts, accs, gyrs, mask, acc0, gyr0, valid = pack(self)
        longest = int(mask.sum(axis=1).max())
        M = max(self.cfg.max_imu_per_interval, -(-longest // 32) * 32)
        pad = lambda a: np.pad(a, [(0, 0), (0, M - a.shape[1])] + [(0, 0)] * (a.ndim - 2))  # noqa: E731
        return (*map(pad, (dts, accs, gyrs, mask)), acc0, gyr0, valid)
    return packed


def e2e(tag, device, full) -> None:
    variants = (("eager", False, False),
                ("graphed, vio_tpu's IMU bucket (32, floor 64)", True, True),
                (f"graphed, the port's IMU bucket ({estimator.IMU_BUCKET})", True, False))
    orig_step, orig_pack = frame_step.frame_step_graphed, estimator.Estimator._pack_imu_raw
    for name, graphed, jax in variants:
        fresh(graph.CHUNK)
        if not graphed:
            frame_step.frame_step_graphed = eager_frame
        if jax:
            estimator.Estimator._pack_imu_raw = jax_bucket(orig_pack)
        try:
            r = bench.bench_e2e_sim(n_frames=120, trace_frames=4, device=device)
        finally:
            frame_step.frame_step_graphed = orig_step
            estimator.Estimator._pack_imu_raw = orig_pack
        print(f"e2e {name}: {r['wall_fps']:.3f} frames/s, device {r['device_ms_per_frame']:.3f} ms "
              f"a post-init frame, busy {100 * r['busy_share']:.2f} %, launches "
              f"{r['gj_solve_launches']}, per frame replays {r['graph_replays_per_frame']:.2f} "
              f"reads {r['graph_reads_per_frame']:.2f}; keys {len(graph.cached_keys())}, "
              f"captures {graph.STATS['captures']} in {graph.STATS['capture_s']:.2f} s, pools "
              f"{graph.STATS['pool_bytes'] / 2**20:.1f} MiB, reserved "
              f"{torch.cuda.memory_reserved() / 2**20:.1f} MiB {tag}")
    if full:
        fresh(graph.CHUNK)
        data = sim.generate(noise=False)
        t0 = time.perf_counter()
        est, traj = runner.run_sim(data)
        wall = time.perf_counter() - t0
        keys = graph.cached_keys()
        gt, _ = runner.sim_ground_truth_at(data, traj["t"])
        print(f"600 frames: {len(data.cam_t) / wall:.3f} frames/s, {len(keys)} keys "
              f"(n_obs {sorted({k[0].n_obs for k in keys})}, M {sorted({k[0].M for k in keys})}, "
              f"marg_old {sorted({k[0].marg_old for k in keys})}), captures "
              f"{graph.STATS['captures']} in {graph.STATS['capture_s']:.2f} s, pools "
              f"{graph.STATS['pool_bytes'] / 2**20:.1f} MiB, APE "
              f"{metrics.ape_rmse(traj['p'], gt)['rmse']:.6f} m, failures {est.failure_count} {tag}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--e2e-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_graph_profile.py measures the card: no CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tag = f"[{smi}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, K={graph.CHUNK} {tag}")
    print("CUDAGraph conditional-node entry points:",
          [n for n in dir(torch._C._CUDAGraph) if "cond" in n.lower() or "while" in n.lower()])
    t0 = time.perf_counter()
    data = sim.generate(noise=False)
    capture_check(device, tag)
    frames_check(data, tag)
    if not args.quick:
        if not args.e2e_only:
            window_compare(device, tag)
            chunk_sweep(data, device, tag)
        e2e(tag, device, args.full)
    print(f"torch_graph_profile: {time.perf_counter() - t0:.1f} s {tag}")


if __name__ == "__main__":
    main()
