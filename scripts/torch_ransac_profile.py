"""The RANSAC kernels of one tree of the repository on the card, and the
tracker's reject program that runs them: ``chip_smoke.py``'s phase 23
alone, plus the device ms of the reject program's replay.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_ransac_profile.py [--root DIR] [--frames 30]

It imports ``chip_smoke`` and ``vio_tpu_torch`` from ``--root`` (default:
this repository), builds that tree's kernels (nvcc's register report of
the RANSAC kernels is printed), then:

1. phase 8: the CLAHE + radtan tracker over 30 rendered frames,
   graphed against its eager twin to the bit;
2. phase 23: phase 7's stream through a graphed tracker and its eager twin,
   then the sweep and the refit (and ``refit_best``, where the tree has
   it) against their plain versions in float32 and float64, with their
   times, the plain versions', the library calls' and the bounds;
3. the device ms a call of each of those kernels on phase 23's inputs, 20
   calls captured into a CUDA graph and replayed 10 times (the tree's own
   phase 23 may time them back to back from Python only);
4. the device ms of one replay of each captured reject program (plain and
   CLAHE + radtan), 20 replays between CUDA events.

With ``--root`` pointing at a checkout of another commit (``git archive``
unpacked into a git-ignored directory), one call times two trees on one
card in turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch


def graph_ms(fn, calls: int = 20, reps: int = 10) -> float:
    """Mean device ms a call of ``fn``, ``calls`` calls captured into one
    CUDA graph and replayed ``reps`` times (chip_smoke.py's, for trees
    whose chip_smoke.py has none)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * reps)


def kernel_ms(recorded, cfg) -> dict:
    """Device ms a call of the tree's RANSAC kernels on phase 23's inputs
    (the frame with the most valid rows), by type; the refit on the best
    hypothesis's consensus set."""
    from vio_tpu_torch import runner
    from vio_tpu_torch.ops import ransac

    cam = runner.camera_from_config(cfg)
    thresh = cfg.f_threshold / cfg.focal_length
    pos, p1, ok, idx = max(recorded, key=lambda r: int(r[2].sum()))
    out = {}
    for dtype in (torch.float32, torch.float64):
        x0 = cam.lift(torch.as_tensor(pos, dtype=dtype, device="cuda"))
        x1 = cam.lift(torch.as_tensor(p1, dtype=dtype, device="cuda"))
        valid = torch.as_tensor(ok, device="cuda")
        idx_d = torch.as_tensor(idx, device="cuda")
        E, n = ransac.sweep(x0, x1, valid, idx_d, thresh)
        best = int(torch.argmax(n))
        w = ((ransac.epipolar_err(E[best], *ransac.masked(x0, x1, valid)) < thresh ** 2)
             & valid).to(dtype)
        row = {"sweep": graph_ms(lambda: ransac.sweep(x0, x1, valid, idx_d, thresh)),
               "refit": graph_ms(lambda: ransac.refit(x0, x1, valid, w, thresh))}
        if hasattr(ransac, "refit_best"):
            row["refit_best"] = graph_ms(lambda: ransac.refit_best(x0, x1, valid, E, n, thresh))
        out[str(dtype)[6:]] = row
    return out


def reject_replay_ms() -> dict:
    """Device ms of one replay of every captured reject program, by the
    key's CLAHE flag."""
    from vio_tpu_torch.solver import graph

    out = {}
    for k, g in list(graph._CACHE.items()):
        if isinstance(g, graph.ProgramGraph) and k[0] == "reject":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            g.graph.replay()
            ev[0].record()
            for _ in range(20):
                g.graph.replay()
            ev[1].record()
            torch.cuda.synchronize()
            out["clahe+radtan" if k[1].equalize else "plain"] = ev[0].elapsed_time(ev[1]) / 20
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ransac_profile: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke
    from vio_tpu_torch import sim
    from vio_tpu_torch.config import sim_images_config
    from vio_tpu_torch.ops import _build

    if Path(chip_smoke.__file__).resolve().parent != root:
        raise RuntimeError(f"chip_smoke came from {chip_smoke.__file__}, not {root}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    tag = f"[{smi.splitlines()[0]}; {root.name}]"
    print(smi)
    t0 = time.perf_counter()
    info = _build.build()
    print(f"build of {root}: {'compiled' if info['built'] else 'up to date'}, nvcc "
          f"{info['seconds']:.2f} s")
    lines = info["log"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("sweep" in line or "refit" in line):
            print("  ptxas:", line.strip())
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt or "spill" in nxt or "stack" in nxt:
                    print("  ptxas:", nxt.strip())
    _build.load()
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.clahe_and_distortion_on_card(tag)
    recorded, _ = chip_smoke.tracker_graphs_against_eager(
        sim_images_config(), sim.generate(noise=False), args.frames,
        "tracker graphs against eager", tag)
    chip_smoke.ransac_kernel_against_plain(recorded, sim_images_config(), tag)
    for name, row in kernel_ms(recorded, sim_images_config()).items():
        print(f"kernels {name}, device ms a call (a graph's replays): "
              + ", ".join(f"{k} {v:.4f}" for k, v in row.items()) + f" {tag}")
    replay = reject_replay_ms()
    print("reject program, device ms of one replay: "
          + ", ".join(f"{k} {v:.4f}" for k, v in replay.items()) + f" {tag}")
    print(f"torch_ransac_profile: {time.perf_counter() - t0:.1f} s {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
