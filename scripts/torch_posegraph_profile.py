"""One pose-graph solve of one or two trees of the repository on the card:
wall ms, device ms, where the time goes, and the graphs' capture.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_posegraph_profile.py [--parent DIR] [--n 189]
        [--reps 5] [--out FILE.json] [--device cpu]

The problem is ``testing.posegraph_circuit(n)`` of this tree (a drifting
circuit of n keyframes with three loop edges; n = 189 is the loop
circuit's last size), float64, ``max_iter`` 40 as ``LoopCloser`` calls
it, written once to an .npz in a temporary directory.  Each turn is a new process that imports
``vio_tpu_torch`` from its tree and calls ``loop.posegraph.optimize`` on
the card:

- the first call (a key's capture, where the tree has graphs) and
  ``--reps`` more, each synchronised: wall ms;
- one more under ``torch.profiler``: the device ms (the durations of the
  card's events summed: kernels, copies, fills) and the share of
  ``gj_solve``'s kernels in it;
- where the tree runs the LM on the host (``solver/generic.py``'s
  ``lm_solve_dense``): one more call with its parts timed, each
  synchronised: ``normal_fn`` (the normal equations on the card),
  ``chi2_fn``, the copies of H and b to the host, ``np.linalg.solve``,
  and the rest (the host loop);
- where the tree has the graphed route: before the first call, a fresh
  process's first-use costs (the kernels' build, the card's first op, a
  first float64 batched product, the normal equations' first and second
  evaluations, a first eager solve), then the key's capture seconds and
  pool MiB, the attempts and host reads a solve, and the eager twin's
  wall ms (``optimize_eager`` on the card).

With ``--parent`` pointing at a checkout of another commit (``git archive``
unpacked into a git-ignored directory), the turns are parent, change,
change, parent, in one call on one card.  ``--device cpu`` rehearses the
turns on the CPU (wall ms only; no device number).  The card's name and
power limit are printed with every line; all turns go to ``--out``
when it is given.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no card"


def write_problem(path: Path, n: int) -> None:
    sys.path.insert(0, str(ROOT))
    from vio_tpu_torch import testing

    _, _, args, w = testing.posegraph_circuit(n)
    np.savez(path, *args, w)


def timed(fn, sync) -> tuple:
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, 1e3 * (time.perf_counter() - t0)


def host_split(posegraph, generic, solve, sync) -> dict:
    """One solve of a tree whose LM is the host loop, its parts timed."""
    parts = dict(normal_fn_ms=0.0, chi2_fn_ms=0.0, copies_ms=0.0, host_solve_ms=0.0)
    counts = dict(normal_fn=0, chi2_fn=0, host_solve=0)

    def clocked(fn, name, count=None):
        def run(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            parts[name] += 1e3 * (time.perf_counter() - t0)
            if count:
                counts[count] += 1
            return out
        return run

    lm, host, np_solve = generic.lm_solve_dense, generic._host, generic.np.linalg.solve

    def lm_clocked(normal_fn, chi2_fn, *a, **k):
        return lm(clocked(normal_fn, "normal_fn_ms", "normal_fn"),
                  clocked(chi2_fn, "chi2_fn_ms", "chi2_fn"), *a, **k)

    generic.lm_solve_dense = lm_clocked
    generic._host = clocked(host, "copies_ms")
    generic.np.linalg.solve = clocked(np_solve, "host_solve_ms", "host_solve")
    try:
        _, wall = timed(solve, sync)
    finally:
        generic.lm_solve_dense, generic._host, generic.np.linalg.solve = lm, host, np_solve
    parts["rest_ms"] = wall - sum(parts.values())
    return dict(split_wall_ms=wall, **parts, **counts)


def turn(root: str, problem: str, reps: int, device: str) -> dict:
    """One tree's measurements, in this process."""
    sys.path.insert(0, root)
    import torch
    from vio_tpu_torch.loop import posegraph
    from vio_tpu_torch.solver import generic

    z = np.load(problem)
    args, w = [z[f"arr_{i}"] for i in range(6)], z["arr_6"]
    kw = dict(edge_weights=w, max_iter=40, device=device, dtype=torch.float64)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    graphed = hasattr(posegraph, "graph_key")
    rec = dict(root=root, card=card(), route="graphed" if graphed else "host LM",
               n=len(args[0]), edges=len(args[2]))
    if graphed:
        from vio_tpu_torch.ops import _build
        from vio_tpu_torch.solver import graph
        if device == "cuda":
            # a fresh process's first call, taken apart: the kernels' build,
            # the card's first op, a first float64 batched product, the
            # normal equations' first and second evaluations, a first eager
            # solve, then the capture (the graphed call below)
            rec["build_ms"] = timed(_build.load, sync)[1]
            rec["first_op_ms"] = timed(lambda: torch.zeros(1, device=device), sync)[1]
            a = torch.ones((len(args[2]), 12, 6), dtype=torch.float64, device=device)
            rec["first_bmm_ms"] = timed(lambda: a @ a.transpose(1, 2), sync)[1]
            g = posegraph.PoseGraph(*(torch.as_tensor(
                v, dtype=torch.float64 if v.dtype.kind == "f" else torch.int64, device=device)
                for v in posegraph.padded(*args, edge_weights=w)))
            q, x0, _ = posegraph.problem(g, 40)
            rec["normal_fn_first_ms"] = timed(lambda: q.normal_fn(x0), sync)[1]
            rec["normal_fn_second_ms"] = timed(lambda: q.normal_fn(x0), sync)[1]
            rec["first_eager_ms"] = timed(lambda: posegraph.optimize_eager(*args, **kw),
                                          sync)[1]
        s0 = dict(graph.STATS)
    (_, _, st), rec["first_ms"] = timed(lambda: posegraph.optimize(*args, **kw), sync)
    walls = [timed(lambda: posegraph.optimize(*args, **kw), sync)[1] for _ in range(reps)]
    rec.update(wall_ms=walls, wall_ms_median=statistics.median(walls),
               iterations=st["iterations"])
    if graphed:
        rec.update(attempts=st["attempts"], reads=st["reads"], key=str(st["key"]),
                   capture_s=graph.STATS["capture_s"] - s0.get("capture_s", 0.0),
                   captures=graph.STATS["captures"] - s0.get("captures", 0),
                   pool_mib=(graph.STATS["pool_bytes"] - s0.get("pool_bytes", 0)) / 2 ** 20)
        rec["eager_ms"] = [timed(lambda: posegraph.optimize_eager(*args, **kw), sync)[1]
                           for _ in range(2)]
    else:
        rec.update(host_split(posegraph, generic, lambda: posegraph.optimize(*args, **kw),
                              sync))
    if device == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (_, prof_wall) = timed(lambda: posegraph.optimize(*args, **kw), sync)
        device_us = solve_us = 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                device_us += e.time_range.elapsed_us()
                if "gj_" in e.name:
                    solve_us += e.time_range.elapsed_us()
        rec.update(profiled_wall_ms=prof_wall, device_ms=device_us / 1e3,
                   gj_solve_device_ms=solve_us / 1e3,
                   solve_share=solve_us / device_us if device_us else None)
    return rec


def run_turn(root: str, problem: Path, a) -> dict | None:
    """One turn in a new process started in ``root``: its record, printed
    as one line (None, with the process's output, if it failed)."""
    r = subprocess.run([sys.executable, __file__, "--turn", str(Path(root).resolve()),
                        str(problem), "--reps", str(a.reps), "--device", a.device],
                       capture_output=True, text=True, cwd=root)
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
        return None
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    if "capture_s" in rec:
        parts = (f"build {rec.get('build_ms', 0):.1f} ms, first op "
                 f"{rec.get('first_op_ms', 0):.1f} ms, first bmm "
                 f"{rec.get('first_bmm_ms', 0):.1f} ms, normal_fn first "
                 f"{rec.get('normal_fn_first_ms', 0):.1f} ms second "
                 f"{rec.get('normal_fn_second_ms', 0):.1f} ms, first eager "
                 f"{rec.get('first_eager_ms', 0):.1f} ms, capture {rec['capture_s']:.3f} s, "
                 f"pool {rec['pool_mib']:.1f} MiB, {rec['attempts']} attempts "
                 f"{rec['reads']} reads, eager {min(rec['eager_ms']):.3f} ms")
    else:
        parts = (f"normal_fn {rec['normal_fn_ms']:.3f} ms ({rec['normal_fn']}), chi2_fn "
                 f"{rec['chi2_fn_ms']:.3f} ({rec['chi2_fn']}), copies {rec['copies_ms']:.3f}, "
                 f"host solve {rec['host_solve_ms']:.3f} ({rec['host_solve']}), rest "
                 f"{rec['rest_ms']:.3f} of {rec['split_wall_ms']:.3f}")
    device = (f"device ms {rec['device_ms']:.3f}, gj_solve share {rec['solve_share'] or 0.0:.3f}; "
              if "device_ms" in rec else "")
    print(f"{rec['route']:8s} {rec['root']}: N={rec['n']} M={rec['edges']} "
          f"{rec['iterations']} iterations; wall ms median {rec['wall_ms_median']:.3f} "
          f"(first {rec['first_ms']:.3f}); {device}{parts} [{rec['card']}]", flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of another commit, timed in turns")
    ap.add_argument("--n", type=int, default=189)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="a JSON file for every turn's numbers")
    ap.add_argument("--turn", nargs=2, metavar=("ROOT", "PROBLEM"), help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        print(json.dumps(turn(a.turn[0], a.turn[1], a.reps, a.device)))
        return 0
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("torch_posegraph_profile: no CUDA device (--device cpu rehearses)",
                  file=sys.stderr)
            return 2
    with tempfile.TemporaryDirectory() as tmp:
        problem = Path(tmp) / "problem.npz"
        write_problem(problem, a.n)
        turns = []
        for root in ([a.parent, str(ROOT), str(ROOT), a.parent] if a.parent else [str(ROOT)]):
            rec = run_turn(root, problem, a)
            if rec is None:
                return 1
            turns.append(rec)
    if a.out:
        Path(a.out).write_text(json.dumps(dict(n=a.n, device=a.device, turns=turns), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
