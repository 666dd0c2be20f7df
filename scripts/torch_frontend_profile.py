"""Where a ``FeatureTracker.read_image`` of the PyTorch port goes on a CUDA
device: time per device program and on the host, device kernels and host
round trips per frame, the device's busy share, and the programs replayed
from their captured graphs against the same programs run eagerly.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_frontend_profile.py [--frames 40] [--out DIR]

Two configurations of the rendered 640×640 simulator stream
(``sim.render_image``), 150 feature slots, float32:

- ``plain``: ``sim_images_config()`` — what ``runner.run_images`` drives
  in ``chip_smoke.py``: no CLAHE, an undistorted pinhole camera;
- ``clahe+radtan``: ``equalize=True`` and EuRoC-magnitude radtan
  distortion, so CLAHE runs and ``camera.lift`` takes its 8 fixed-point
  steps.

For each it makes these passes over the same frames (all frames but the
first two, which capture the graphs, enter the medians):

1. *programs*: every device program of ``read_image`` (``_run``: the
   upload, the replay and the read) is wrapped with a
   ``torch.cuda.synchronize()`` before and after and timed on the host
   clock; the RANSAC samples' host draw (``sfm.ransac_samples``) is timed
   too, and what is left of the frame is the tracker's numpy
   bookkeeping.  Then each program's graph is replayed alone, 20 times
   between two CUDA events, on the last frame's inputs: its device time;
2. *whole frames*: synchronised ``read_image`` with nothing wrapped, in
   turns graphed, eager, eager, graphed (the eager tracker runs the same
   programs op by op, ``_run_eager``);
3. *trace*: a ``torch.profiler`` trace of the last 10 frames of a fresh
   graphed tracker: device kernels, device-to-host and host-to-device
   copies and synchronising runtime calls per frame, the kernels' summed
   device time and its share of the traced wall time, and the kernels
   that take the most device time.

Then, for ``plain`` only, the tracker inside the image path
(``runner.run_images`` over ``--image-frames`` frames, estimator float64,
as chip_smoke.py's phase 7): synchronised ``read_image``, its programs and
the samples' draw, first as shipped (``sfm.ransac_samples`` on one
intra-op thread), then with the draw on the process's intra-op threads.

``--device cpu`` rehearses the script where there is no card; it then
prints host times only and says "not measured" for every device number.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vio_tpu_torch import runner, sim  # noqa: E402
from vio_tpu_torch.config import sim_images_config  # noqa: E402
from vio_tpu_torch.features import tracker as tracker_mod  # noqa: E402
from vio_tpu_torch.solver import graph  # noqa: E402

DISTORT = dict(k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
TRACED_FRAMES = 10
WARM = 2           # frames left out of the medians (the captures)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tracker(cfg, device, eager=False):
    trk = runner.make_tracker(cfg, device=device)
    if eager:
        trk._run = trk._run_eager
    return trk


def program_pass(cfg, frames, times, device):
    """Per-frame milliseconds of each program (host clock, synchronised),
    of the samples' host draw and of the whole frame; then the device
    milliseconds of one replay of each program's graph (None on the
    CPU)."""
    trk = _tracker(cfg, device)
    run, draw = trk._run, tracker_mod.sfm.ransac_samples
    row = {}

    def timed_run(name, key, host, *args, **kwargs):
        _sync(trk.device)
        t0 = time.perf_counter()
        out = run(name, key, host, *args, **kwargs)
        _sync(trk.device)
        row[name] = 1e3 * (time.perf_counter() - t0)
        return out

    def timed_draw(*args, **kwargs):
        t0 = time.perf_counter()
        out = draw(*args, **kwargs)
        row["ransac_samples (host)"] = 1e3 * (time.perf_counter() - t0)
        return out

    trk._run = timed_run
    tracker_mod.sfm.ransac_samples = timed_draw
    rows = []
    try:
        for img, t in zip(frames, times):
            row.clear()
            _sync(trk.device)
            t0 = time.perf_counter()
            trk.read_image(img, t)
            _sync(trk.device)
            row["read_image"] = 1e3 * (time.perf_counter() - t0)
            rows.append(dict(row))
    finally:
        tracker_mod.sfm.ransac_samples = draw
    replay_ms = None
    if trk.device.type == "cuda":
        key = trk.key(frames[0].shape)
        replay_ms = {}
        for k, g in graph._CACHE.items():
            if isinstance(g, graph.ProgramGraph) and k[1] == key:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                g.graph.replay()
                ev[0].record()
                for _ in range(20):
                    g.graph.replay()
                ev[1].record()
                torch.cuda.synchronize()
                replay_ms[k[0]] = ev[0].elapsed_time(ev[1]) / 20
    return rows[WARM:], int(trk.valid.sum()), replay_ms


def whole_pass(cfg, frames, times, device, eager):
    """Synchronised read_image milliseconds with nothing wrapped."""
    trk = _tracker(cfg, device, eager)
    ms = []
    for img, t in zip(frames, times):
        _sync(trk.device)
        t0 = time.perf_counter()
        trk.read_image(img, t)
        _sync(trk.device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms[WARM:]


def trace_pass(cfg, frames, times, device, out_dir, label):
    """Counts per frame, device busy share and the top kernels over the
    last TRACED_FRAMES frames of a graphed tracker.  None without a CUDA
    device."""
    trk = _tracker(cfg, device)
    if trk.device.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    warm = len(frames) - TRACED_FRAMES
    for img, t in zip(frames[:warm], times[:warm]):
        trk.read_image(img, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for img, t in zip(frames[warm:], times[warm:]):
            trk.read_image(img, t)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = copies_d2h = copies_h2d = syncs = 0
    device_us = 0.0
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("Memcpy DtoH"):
                copies_d2h += 1
            elif e.name.startswith("Memcpy HtoD"):
                copies_h2d += 1
            elif not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
            us = e.time_range.elapsed_us()
            device_us += us
            by_name[e.name] = by_name.get(e.name, 0.0) + us
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize"):
            syncs += 1
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"frontend_profile_{label}.txt").write_text(
            prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
    n = TRACED_FRAMES
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(kernels=kernels / n, d2h=copies_d2h / n, h2d=copies_h2d / n,
                syncs=syncs / n, device_ms=device_us / 1e3 / n, wall_ms=wall_ms / n,
                top=[(name, us / 1e3 / n) for name, us in top])


def _draw_on_all_threads(valid, n_hyp, generator):
    """``sfm.ransac_samples`` without its one-thread setting."""
    p = torch.as_tensor(np.asarray(valid), dtype=torch.float64) + 1e-9
    return torch.multinomial(p.expand(n_hyp, p.shape[0]), 8, replacement=False,
                             generator=generator)


def image_path_pass(data, cfg, n_frames, device, draw):
    """Medians over the image path's frames (the first two left out):
    read_image, each program and the samples' draw, all synchronised;
    and the run's wall seconds."""
    trk = _tracker(cfg, device)
    run, read_image, saved = trk._run, trk.read_image, tracker_mod.sfm.ransac_samples
    ms: dict[str, list[float]] = {}

    def clocked(name, fn):
        def timed(*args, **kwargs):
            _sync(trk.device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(trk.device)
            ms.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            return out
        return timed

    trk._run = lambda name, *a, **k: clocked(name, run)(name, *a, **k)
    trk.read_image = clocked("read_image", read_image)
    tracker_mod.sfm.ransac_samples = clocked("ransac_samples (host)", draw)
    t0 = time.perf_counter()
    try:
        runner.run_images(runner.sim_image_frames(data, n_frames=n_frames), data.imu_t,
                          data.acc, data.gyr, cfg, tracker=trk, device=device,
                          dtype=torch.float64)
    finally:
        tracker_mod.sfm.ransac_samples = saved
    wall = time.perf_counter() - t0
    return {k: statistics.median(v[WARM:] or v) for k, v in ms.items()}, wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' rehearses without one")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the profiler's tables")
    ap.add_argument("--image-frames", type=int, default=70,
                    help="frames of the image-path pass (0: leave it out)")
    args = ap.parse_args()
    if args.frames < TRACED_FRAMES + 5:
        ap.error(f"--frames must be at least {TRACED_FRAMES + 5}")
    if args.device is None and not torch.cuda.is_available():
        print("torch_frontend_profile: no CUDA device (pass --device cpu to rehearse)",
              file=sys.stderr)
        return 2
    on_card = args.device is None or torch.device(args.device).type == "cuda"
    tag = "[cpu rehearsal]"
    if on_card:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        tag = f"[{smi.splitlines()[0]}]"
        print(smi)

    for label, overrides in (("plain", {}),
                             ("clahe+radtan", dict(equalize=True, **DISTORT))):
        cam = {k: v for k, v in overrides.items() if k in DISTORT}
        data = sim.generate(noise=False, **cam)
        cfg = sim_images_config(**overrides)
        frames = [sim.render_image(data, k) for k in range(args.frames)]
        times = [float(t) for t in data.cam_t[:args.frames]]

        before = dict(graph.STATS)
        rows, live, replay_ms = program_pass(cfg, frames, times, args.device)
        n_frames = len(rows) + WARM
        total = statistics.median(r["read_image"] for r in rows)
        print(f"== {label}: {len(rows)} frames of 640x640, {cfg.max_cnt} slots, "
              f"{live} live tracks at the end {tag}")
        print(f"read_image, programs synchronised: median {total:.3f} ms {tag}")
        names = sorted({k for r in rows for k in r if k != "read_image"})
        for name in names:
            vals = [r.get(name, 0.0) for r in rows]
            calls = sum(name in r for r in rows) / len(rows)
            print(f"  {name:<28s} median {statistics.median(vals):8.3f} ms/frame, mean "
                  f"{statistics.mean(vals):8.3f}, in {100 * calls:5.1f} % of frames {tag}")
        host = [r["read_image"] - sum(v for k, v in r.items() if k != "read_image")
                for r in rows]
        print(f"  {'host bookkeeping (the rest)':<28s} median {statistics.median(host):8.3f} "
              f"ms/frame {tag}")
        if replay_ms is None:
            print("  device ms of one replay of each program: not measured")
        else:
            print("  device ms of one replay: " + ", ".join(
                f"{k} {v:.3f}" for k, v in sorted(replay_ms.items())) + f" {tag}")
        d = {k: graph.STATS[k] - before.get(k, 0)
             for k in ("program_replays", "program_reads", "captures", "capture_s")}
        print(f"  graphs: {d['program_replays'] / n_frames:.2f} replays, "
              f"{d['program_reads'] / n_frames:.2f} reads a frame; {d['captures']} captured "
              f"in {d['capture_s']:.2f} s (the process's first configuration pays them) {tag}")

        whole = {}
        for eager in (False, True, True, False):
            whole.setdefault(eager, []).append(
                whole_pass(cfg, frames, times, args.device, eager))
        for eager in (False, True):
            meds = [statistics.median(ms) for ms in whole[eager]]
            print(f"read_image {'eager' if eager else 'graphed'}, nothing wrapped: medians "
                  f"{meds[0]:.3f} / {meds[1]:.3f} ms (in turns: graphed, eager, eager, "
                  f"graphed) {tag}")

        tr = trace_pass(cfg, frames, times, args.device, args.out, label.replace("+", "_"))
        if tr is None:
            print("  device kernels, copies, synchronisations, busy share: not measured")
            continue
        print(f"  traced {TRACED_FRAMES} graphed frames: {tr['kernels']:.1f} device "
              f"kernels/frame, {tr['d2h']:.1f} device-to-host copies/frame, {tr['h2d']:.1f} "
              f"host-to-device copies/frame, {tr['syncs']:.1f} synchronising runtime "
              f"calls/frame {tag}")
        untraced = statistics.median(whole[False][-1][-TRACED_FRAMES:])
        print(f"  device time {tr['device_ms']:.3f} ms/frame: busy share "
              f"{100 * tr['device_ms'] / tr['wall_ms']:.1f} % of the traced wall "
              f"({tr['wall_ms']:.3f} ms/frame; tracing slows the host), "
              f"{100 * tr['device_ms'] / untraced:.1f} % of the same frames' untraced "
              f"read_image ({untraced:.3f} ms median) {tag}")
        for name, ms in tr["top"]:
            print(f"    {ms:8.3f} ms/frame  {name[:110]} {tag}")

    if args.image_frames:
        data, cfg = sim.generate(noise=False), sim_images_config()
        for label, draw in (("the draw on one thread (as shipped)",
                             tracker_mod.sfm.ransac_samples),
                            (f"the draw on {torch.get_num_threads()} intra-op threads",
                             _draw_on_all_threads)):
            med, wall = image_path_pass(data, cfg, args.image_frames, args.device, draw)
            print(f"== image path, {args.image_frames} frames, {label}: "
                  f"{args.image_frames / wall:.3f} frames/s ({wall:.2f} s, rendering and "
                  f"synchronisation included); medians: " + ", ".join(
                      f"{k} {v:.3f} ms" for k, v in sorted(med.items())) + f" {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
