"""What the EuRoC layout changes in a run: ``runner.run_images`` over
rendered simulator frames at the simulator's stamps (chip_smoke.py phase
7's run), ``runner.run_euroc`` over the same frames written with
``io.write_euroc`` (stamps rounded to nanoseconds, as the layout stores
them), and ``run_images`` over the rendered frames at the layout's
rounded stamps, all with phase 7's precisions (tracker float32, estimator
float64).  Prints, for each pair, the published frames, the poses, the
largest stamp and position differences at equal stamps, and each run's
APE against the layout's ground-truth file (nearest stamp, as the CLI
pairs them): the numbers chip_smoke.py phase 18 holds on the card.

    python scripts/torch_euroc_stamps.py [--device cpu] [--frames 60] [--half]

``--half`` renders at 320×320 (focal 230), the CPU tests' size.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vio_tpu_torch import io as vio_io  # noqa: E402
from vio_tpu_torch import metrics, runner, sim  # noqa: E402
from vio_tpu_torch.cli import nearest_stamp  # noqa: E402
from vio_tpu_torch.config import sim_images_config  # noqa: E402


def compare(a, b):
    """(paired poses, max |dt|, max |dp|) at stamps equal to 1e-6 s."""
    i, j = np.nonzero(np.abs(a["t"][:, None] - b["t"][None, :]) < 1e-6)
    pa, pb = a["p"].reshape(-1, 3), b["p"].reshape(-1, 3)
    return (len(i), np.abs(a["t"][i] - b["t"][j]).max(initial=0.0),
            np.abs(pa[i] - pb[j]).max(initial=0.0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--half", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(1)
    if args.half:
        cam = dict(fx=230.0, fy=230.0, cx=159.5, cy=159.5)
        data = sim.generate(noise=False, image_w=320.0, image_h=320.0, **cam)
        cfg = sim_images_config(focal_length=230.0, image_width=320, image_height=320,
                                min_dist=8, **cam)
        render = dict(height=320, width=320)
    else:
        data, cfg, render = sim.generate(noise=False), sim_images_config(), {}

    def tracker():
        return runner.make_tracker(cfg, device=args.device, dtype=torch.float32)

    def images(d):
        return runner.run_images(
            runner.sim_image_frames(d, n_frames=args.frames, **render),
            d.imu_t, d.acc, d.gyr, cfg, tracker=tracker(), device=args.device,
            dtype=torch.float64)[1]

    runs, secs = {}, {}
    t0 = time.perf_counter()
    runs["phase 7"] = images(data)
    secs["phase 7"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as seq:
        vio_io.write_euroc(data, seq, n_frames=args.frames, render_kw=render)
        t0 = time.perf_counter()
        _, runs["run_euroc"], back = runner.run_euroc(
            seq, cfg, tracker=tracker(), device=args.device, dtype=torch.float64)
        secs["run_euroc"] = time.perf_counter() - t0
    rounded = dataclasses.replace(data, imu_t=back.imu_t,
                                  cam_t=np.concatenate([back.cam_t, data.cam_t[args.frames:]]))
    t0 = time.perf_counter()
    runs["rounded stamps"] = images(rounded)
    secs["rounded stamps"] = time.perf_counter() - t0
    size = " (320x320)" if args.half else ""
    for name, traj in runs.items():
        ape = (metrics.ape_rmse(traj["p"], back.gt_p[nearest_stamp(back.gt_t, traj["t"])])["rmse"]
               if len(traj["t"]) else float("nan"))
        first = int(np.argmax(traj["initialized"])) if traj["initialized"].any() else -1
        print(f"{name}{size}: {args.frames} frames, {len(traj['initialized'])} published, "
              f"first pose at published frame {first}, {len(traj['t'])} poses, "
              f"APE {ape:.6f} m, {secs[name]:.1f} s")
    for a, b in (("run_euroc", "phase 7"), ("run_euroc", "rounded stamps")):
        n, dt, dp = compare(runs[a], runs[b])
        print(f"{a} against {b}: {n} poses at equal stamps, max |dt| {dt:.3e} s, "
              f"max |dp| {dp:.3e} m")


if __name__ == "__main__":
    main()
