"""Where a ``FeatureTracker.read_image`` of the PyTorch port goes on a CUDA
device: host-clock time per stage, device kernels and host round trips
per frame, and the device's busy share.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_frontend_profile.py [--frames 40] [--out DIR]

Two configurations of the rendered 640×640 simulator stream
(``sim.render_image``), 150 feature slots, float32:

- ``plain``: ``sim_images_config()`` — what ``runner.run_images`` drives
  in ``chip_smoke.py``: no CLAHE, an undistorted pinhole camera;
- ``clahe+radtan``: ``equalize=True`` and EuRoC-magnitude radtan
  distortion, so CLAHE runs and ``camera.lift`` takes its 8 fixed-point
  steps.

For each it makes two passes over the same frames:

1. *stages*: every device stage of ``read_image`` is wrapped with a
   ``torch.cuda.synchronize()`` before and after and timed on the host
   clock; what is left of the frame is the tracker's numpy bookkeeping
   and transfers ("host + copies").  The synchronisations make the sum a
   little larger than an unwrapped frame, which is timed too;
2. *trace*: a ``torch.profiler`` trace of the last 10 frames of a fresh
   tracker with nothing wrapped: device kernels, device-to-host copies
   and synchronising runtime calls per frame, the kernels' summed device
   time and its share of the traced wall time; then the same counts with
   the RANSAC sweep (``sfm.essential_ransac``) replaced by a stub that
   accepts every track, which leaves what the rest of the frame launches.

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
from vio_tpu_torch.features import clahe as clahe_mod  # noqa: E402
from vio_tpu_torch.features import detect, klt  # noqa: E402
from vio_tpu_torch.init import sfm  # noqa: E402

DISTORT = dict(k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
TRACED_FRAMES = 10
# (stage name, module, attribute) of what read_image calls on the device
STAGES = (("clahe", clahe_mod, "clahe"), ("track_fb", klt, "track_fb"),
          ("refine_on_templates", klt, "refine_on_templates"),
          ("essential_ransac", sfm, "essential_ransac"),
          ("occupancy_from_points", detect, "occupancy_from_points"),
          ("detect", detect, "detect"),
          ("sample_templates", klt, "sample_templates"))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StageClock:
    """Wraps the stage functions on their modules for the life of a
    ``with`` block; ``ms[name]`` collects one entry per call."""

    def __init__(self, device):
        self.device = device
        self.ms: dict[str, list[float]] = {}
        self._saved = []

    def timed(self, name, fn):
        def wrapper(*args, **kwargs):
            _sync(self.device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            _sync(self.device)
            self.ms.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapper

    def __enter__(self):
        for name, mod, attr in STAGES:
            self._saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, self.timed(name, getattr(mod, attr)))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def stage_pass(cfg, frames, times, device):
    """Per-frame milliseconds of each stage, synchronised, over all frames
    but the first two (the first has nothing to track, the second pays
    the allocator's and cuSOLVER's first use)."""
    trk = runner.make_tracker(cfg, device=device)
    with StageClock(trk.device) as clock:
        trk._lift = clock.timed("camera.lift", trk._lift)
        per_frame = []
        for img, t in zip(frames, times):
            before = {k: len(v) for k, v in clock.ms.items()}
            _sync(trk.device)
            t0 = time.perf_counter()
            trk.read_image(img, t)
            _sync(trk.device)
            total = 1e3 * (time.perf_counter() - t0)
            row = {k: sum(v[before.get(k, 0):]) for k, v in clock.ms.items()}
            row["host + copies"] = total - sum(row.values())
            row["read_image"] = total
            row["calls"] = {k: len(v) - before.get(k, 0) for k, v in clock.ms.items()}
            per_frame.append(row)
    return per_frame[2:], int(trk.valid.sum())


def plain_pass(cfg, frames, times, device):
    """Synchronised read_image milliseconds with nothing wrapped."""
    trk = runner.make_tracker(cfg, device=device)
    ms = []
    for img, t in zip(frames, times):
        _sync(trk.device)
        t0 = time.perf_counter()
        trk.read_image(img, t)
        _sync(trk.device)
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms[2:]


def _accept_all(x0, x1, valid, generator, thresh=0.0, n_hyp=0):
    """Stands in for sfm.essential_ransac in the trace that leaves it out."""
    return None, valid, valid.sum()


def trace_pass(cfg, frames, times, device, out_dir, label, ransac=True):
    """Counts per frame and device busy share over the last TRACED_FRAMES
    frames; with ``ransac=False`` the RANSAC sweep is left out, to count
    what the rest of the frame launches.  Returns None without a CUDA
    device."""
    trk = runner.make_tracker(cfg, device=device)
    if trk.device.type != "cuda":
        return None
    if not ransac:
        saved = sfm.essential_ransac
        sfm.essential_ransac = _accept_all
        try:
            return trace_pass(cfg, frames, times, device, None, label)
        finally:
            sfm.essential_ransac = saved
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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("Memcpy DtoH"):
                copies_d2h += 1
            elif e.name.startswith("Memcpy HtoD"):
                copies_h2d += 1
            elif not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
                device_us += e.time_range.elapsed_us()
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize"):
            syncs += 1
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"frontend_profile_{label}.txt").write_text(
            prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=60))
    n = TRACED_FRAMES
    return dict(kernels=kernels / n, d2h=copies_d2h / n, h2d=copies_h2d / n,
                syncs=syncs / n, device_ms=device_us / 1e3 / n,
                wall_ms=wall_ms / n)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' rehearses without one")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for the profiler's tables")
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

        rows, live = stage_pass(cfg, frames, times, args.device)
        whole = plain_pass(cfg, frames, times, args.device)
        names = [k for k in rows[-1] if k not in ("calls", "read_image")]
        print(f"== {label}: {len(rows)} frames of 640x640, {cfg.max_cnt} slots, "
              f"{live} live tracks at the end {tag}")
        print(f"read_image, nothing wrapped: median {statistics.median(whole):.3f} ms "
              f"(min {min(whole):.3f}, max {max(whole):.3f}) {tag}")
        total = statistics.median(r["read_image"] for r in rows)
        print(f"read_image, stages synchronised: median {total:.3f} ms {tag}")
        for name in names:
            med = statistics.median(r.get(name, 0.0) for r in rows)
            calls = statistics.median(r["calls"].get(name, 0) for r in rows)
            print(f"  {name:<22s} median {med:8.3f} ms/frame  {100 * med / total:5.1f} %  "
                  f"calls/frame {calls:g} {tag}")

        tr = trace_pass(cfg, frames, times, args.device, args.out,
                        label.replace("+", "_"))
        if tr is None:
            print("  device kernels, copies, synchronisations, busy share: not measured")
            continue
        print(f"  traced {TRACED_FRAMES} frames: {tr['kernels']:.1f} device kernels/frame, "
              f"{tr['d2h']:.1f} device-to-host copies/frame, {tr['h2d']:.1f} host-to-device "
              f"copies/frame, {tr['syncs']:.1f} synchronising runtime calls/frame {tag}")
        rest = trace_pass(cfg, frames, times, args.device, None, label, ransac=False)
        print(f"  the same without essential_ransac: {rest['kernels']:.1f} device kernels/frame, "
              f"{rest['d2h']:.1f} device-to-host copies/frame, {rest['syncs']:.1f} "
              f"synchronising runtime calls/frame, device time {rest['device_ms']:.3f} ms/frame "
              f"of {rest['wall_ms']:.3f} ms traced wall/frame {tag}")
        untraced = statistics.median(whole[-TRACED_FRAMES:])
        print(f"  device time {tr['device_ms']:.3f} ms/frame: busy share "
              f"{100 * tr['device_ms'] / tr['wall_ms']:.1f} % of the traced wall "
              f"({tr['wall_ms']:.3f} ms/frame; tracing slows the host), "
              f"{100 * tr['device_ms'] / untraced:.1f} % of the same frames' untraced "
              f"read_image ({untraced:.3f} ms median) {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
