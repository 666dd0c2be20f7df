"""The pose graph's damped solve on the card, the library's Cholesky
(``linsolve.cholesky_solve``), and pose graphs above the Gauss-Jordan
kernel's sizes.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_posegraph_route.py [--kernels-P 2304]
        [--graphs 700 1000] [--out FILE.json] [--device cpu]

1. The library route's kernels: one captured replay of a float64 solve at
   ``--kernels-P`` under ``torch.profiler``: each kernel's name and
   device ms (the names that
   ``benchmark/metrics/posegraph_solve_roofline.py`` reads).
2. Pose graphs of ``--graphs`` keyframes (``testing.posegraph_circuit``,
   float64, ``max_iter`` 40 as ``LoopCloser`` calls it) through
   ``posegraph.optimize`` on the card (the graphs: a first call that
   captures, a second timed), against the eager twin and judged by the
   benchmark's plain reference (``benchmark/reference/posegraph.py``) on
   the card: its cost left, pose gap and pose 0's move.

``--device cpu`` rehearses 2 at small sizes (no device number).  The card's
name and power limit are printed first; everything goes to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except OSError:
        return "no nvidia-smi"


def spd(P: int, dtype, seed: int):
    """A damped normal-equations-like SPD system on the card."""
    gen = torch.Generator().manual_seed(seed)
    M = torch.randn((P, P), generator=gen, dtype=torch.float64)
    A = M @ M.T / P + torch.eye(P, dtype=torch.float64)
    b = torch.randn((P,), generator=gen, dtype=torch.float64)
    return A.to("cuda", dtype), b.to("cuda", dtype)


def library_kernels(P: int) -> dict:
    """Kernel names and device ms of one captured float64 library solve."""
    from torch.profiler import ProfilerActivity, profile

    from vio_tpu_torch.ops import linsolve
    A, b = spd(P, torch.float64, seed=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        linsolve.cholesky_solve(A, b)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        linsolve.cholesky_solve(A, b)
    g.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.replay()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    out = dict(P=P, kernels_ms=dict(sorted(by_name.items(), key=lambda kv: -kv[1])))
    print(json.dumps(out), flush=True)
    return out


def graphs(ns, device: str) -> list[dict]:
    from benchmark.reference import posegraph as ref
    from vio_tpu_torch import testing
    from vio_tpu_torch.loop import posegraph
    from vio_tpu_torch.ops import linsolve
    rows = []
    on_card = device == "cuda"
    for n in ns:
        _, _, args, w = testing.posegraph_circuit(n)
        kw = dict(edge_weights=w, max_iter=40, dtype=torch.float64)

        def timed(fn):
            if on_card:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, device=device, **kw)
            if on_card:
                torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t0)

        c0 = linsolve.cholesky_solve.launches
        _, first_ms = timed(posegraph.optimize)
        (Ps, qs, st), ms = timed(posegraph.optimize)
        (Pe, qe, se), eager_ms = timed(posegraph.optimize_eager)
        rec = dict(inputs=dict(Ps0=np.asarray(args[0], np.float64),
                               qs0=np.asarray(args[1], np.float64),
                               ei=np.asarray(args[2], np.int64), ej=np.asarray(args[3], np.int64),
                               dP=np.asarray(args[4], np.float64),
                               dq=np.asarray(args[5], np.float64),
                               w=np.asarray(w, np.float64), fix_first=True, max_iter=40),
                   outputs=dict(Ps=Ps, qs=qs, iterations=st["iterations"]))
        t0 = time.perf_counter()
        j = ref.judge(rec, device)
        row = dict(n=n, padded_P=6 * posegraph._bucket(n, posegraph.POSE_BUCKET),
                   iterations=st["iterations"], attempts=st["attempts"],
                   eager_iterations=se["iterations"], first_ms=first_ms, ms=ms,
                   eager_ms=eager_ms, cholesky_launches=linsolve.cholesky_solve.launches - c0,
                   dP_eager=float(np.abs(Ps - Pe).max()),
                   cost_left=j["cost_gap_out"] / j["cost_gap_in"] if j["cost_gap_in"] > 0
                   else None, pose_gap=j["pose_gap"], fix_gap=j["fix_gap"],
                   judge_s=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-P", type=int, default=2304)
    ap.add_argument("--graphs", type=int, nargs="*", default=[700, 1000])
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = dict(card=card() if a.device == "cuda" else "cpu")
    print(f"card: {out['card']}", flush=True)
    if a.device == "cuda":
        out["library_kernels"] = library_kernels(a.kernels_P)
    out["graphs"] = graphs(a.graphs, a.device)
    out["seconds"] = time.perf_counter() - t0
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print(f"seconds {out['seconds']:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
