"""Command-line entry points: `python -m vio_tpu_torch.cli <cmd>`
(installed as ``vio-torch``).

Port of ``vio_tpu/cli.py`` (reference: vins-mono/test/run_euroc.cpp,
run_vio_simulation.cpp, simulator/src/main.cpp):

  run — play a dataset through the estimator, dump TUM trajectory + APE
  sim — generate the analytic dataset (optionally reference-format CSVs)
  bench — time the bench's stages (the port's ``bench.py``): the headline
          JSON line first, the details merged into ``--details``

The device work runs on the CUDA device unless ``--device cpu`` is given
(``device.resolve``).  The estimator's dtype is float32 on the card for
the simulation dataset and float64 for the image datasets, whose
configurations need it (the tracker keeps its device's default);
``--dtype`` overrides it.  Each run prints one JSON line, which includes
the Gauss-Jordan, RANSAC, preintegration and IMU-factor kernels' launches and the
CUDA graphs' keys, replays and host reads (``solver/graph.py``; 0 on the
CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}


def _dump_telemetry(est, path):
    if not path:
        return
    with open(path, "w") as fh:
        for rec in est.pop_telemetry():
            fh.write(json.dumps(rec) + "\n")


class _MaybeProfile:
    """torch.profiler over the run when a directory is given; writes a
    Chrome trace (``trace.json``) there."""

    def __init__(self, trace_dir):
        self.trace_dir = trace_dir
        self.prof = None

    def __enter__(self):
        if self.trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            os.makedirs(self.trace_dir, exist_ok=True)
            self.prof.export_chrome_trace(os.path.join(self.trace_dir, "trace.json"))
        return False


def _result(dataset, est, traj, wall, **extra):
    from . import imu
    from .ops import linsolve, ransac
    from .solver import graph, window
    return dict(dataset=dataset, frames=len(traj["t"]),
                failures=est.failure_count, wall_s=round(wall, 1),
                fps=round(est.frame_solved / max(wall, 1e-9), 2),
                device=str(est.device), dtype=str(est.dtype).removeprefix("torch."),
                gj_solve_launches=linsolve.gj_solve.launches,
                essential_ransac_launches=ransac.launches(),
                preintegrate_launches=imu.preintegrate_kernel.launches,
                imu_factor_launches=window.imu_factor_kernel.launches,
                graphs={k: graph.STATS[k] for k in ("keys", "replays", "reads",
                                                    "program_replays", "program_reads")},
                **extra)


def cmd_run(args):
    from . import metrics, runner, sim
    from .config import sim_config, sim_images_config
    from .device import resolve

    device, _ = resolve(args.device)
    image = args.dataset != "sim"
    dtype = DTYPES[args.dtype] if args.dtype else (torch.float64 if image else None)

    def run_frames(frames, data, cfg):
        # the tracker keeps its device's default (float32 on the card)
        trk = runner.make_tracker(cfg, device=device)
        return runner.run_images(frames, data.imu_t, data.acc, data.gyr, cfg,
                                 tracker=trk, progress=args.verbose,
                                 device=device, dtype=dtype)

    def sim_ape(data, traj):
        if len(traj["t"]) == 0:      # nothing initialized: no trajectory
            return None
        gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
        return metrics.ape_rmse(traj["p"], gt_p)

    t0 = time.time()
    if args.dataset == "sim":
        data = sim.generate(noise=args.noise, pixel_noise=args.pixel_noise)
        with _MaybeProfile(args.profile):
            est, traj = runner.run_sim(data, sim_config(), n_frames=args.frames,
                                       progress=args.verbose, device=device,
                                       dtype=dtype)
        wall = time.time() - t0
        result = _result("sim", est, traj, wall, noise=bool(args.noise),
                         ape=sim_ape(data, traj))
    elif args.dataset == "euroc":
        from .config import euroc_config
        cfg = euroc_config()
        with _MaybeProfile(args.profile):
            est, traj, data = runner.run_euroc(
                args.path, cfg, n_frames=args.frames, progress=args.verbose,
                tracker=runner.make_tracker(cfg, device=device),
                device=device, dtype=dtype)
        wall = time.time() - t0
        result = _result("euroc", est, traj, wall, path=args.path)
        if data.gt_t is not None and len(traj["t"]) > 0:
            result["ape"] = metrics.ape_rmse(traj["p"], data.gt_p[
                nearest_stamp(data.gt_t, traj["t"])])
    elif args.dataset == "sim-images":
        # the full image pipeline against rendered simulator frames
        data = sim.generate(noise=args.noise, pixel_noise=args.pixel_noise)
        with _MaybeProfile(args.profile):
            est, traj = run_frames(runner.sim_image_frames(data, n_frames=args.frames),
                                   data, sim_images_config())
        wall = time.time() - t0
        result = _result("sim-images", est, traj, wall, ape=sim_ape(data, traj))
    elif args.dataset == "hybrid":
        # hybrid real-sensor flagship: MH_05_imu0.txt / MH_05_cam0.txt in
        # --path, pixels rendered from the IMU-consistent trajectory
        from . import hybrid
        if not args.path:
            raise SystemExit("--dataset hybrid needs --path (the directory "
                             "holding MH_05_imu0.txt and MH_05_cam0.txt)")
        dist = dict(k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
        data = hybrid.generate_hybrid(
            os.path.join(args.path, "MH_05_imu0.txt"),
            os.path.join(args.path, "MH_05_cam0.txt"),
            duration=30.0 if args.frames is None else args.frames / 20.0,
            **dist)
        cfg = sim_images_config(equalize=True, freq=10,
                                outlier_reproj_px=3.0, **dist)

        def frames():
            for k in range(len(data.cam_t)):
                yield float(data.cam_t[k]), (
                    lambda kk=k: sim.render_image(data, kk))

        with _MaybeProfile(args.profile):
            est, traj = run_frames(frames(), data, cfg)
        wall = time.time() - t0
        result = _result("hybrid", est, traj, wall, ape=sim_ape(data, traj))
    else:
        raise SystemExit(f"unknown dataset {args.dataset}")
    _dump_telemetry(est, args.log_jsonl)
    if args.out:
        metrics.write_tum(args.out, traj["t"], traj["p"], traj["R"])
    print(json.dumps(result))


def nearest_stamp(gt_t, ts):
    """Index of the ground-truth stamp paired with each estimate: the
    first at or after it, clipped to the last (vio_tpu/cli.py's pairing)."""
    return np.clip(np.searchsorted(gt_t, ts), 0, len(gt_t) - 1)


def cmd_sim(args):
    from . import sim
    from . import io as vio_io
    data = sim.generate(noise=args.noise, pixel_noise=args.pixel_noise)
    if args.out:
        vio_io.write_sim_csvs(data, args.out)
        print(f"wrote reference-format CSVs to {args.out}")


def cmd_bench(args):
    from . import bench
    rc = bench.main(device=args.device, details_path=args.details or bench.DETAILS)
    if rc:
        raise SystemExit(rc)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vio_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run VIO on a dataset")
    p.add_argument("--dataset", default="sim",
                   choices=["sim", "sim-images", "euroc", "hybrid"])
    p.add_argument("--path", default=None,
                   help="EuRoC sequence dir, or the hybrid dataset's stream dir")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--noise", action="store_true")
    p.add_argument("--pixel-noise", type=float, default=0.0)
    p.add_argument("--out", default=None, help="TUM trajectory output path")
    p.add_argument("--log-jsonl", default=None,
                   help="per-solve telemetry JSONL output path: a line a solved frame "
                        "with chi2, iterations, lam, factor counts, solve_ms, marg_ms, "
                        "the host ms of each span opened in the frame (frame_ms, "
                        "features_ms, triangulate_ms, pack_ms, step_ms, unpack_ms, "
                        "outliers_ms, prior_ms, slide_ms; on the card upload_ms, "
                        "replay_ms, wait_ms, capture_ms) and reads (the LM loop's "
                        "host reads, 0 on the CPU)")
    p.add_argument("--profile", default=None,
                   help="torch.profiler Chrome-trace output directory; the trace "
                        "carries the spans as vio.est.* and vio.graph.* ranges")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device; raises without one)")
    p.add_argument("--dtype", default=None, choices=sorted(DTYPES),
                   help="estimator dtype (default: the device's for sim, "
                        "float64 for the image datasets)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sim", help="generate the analytic dataset")
    p.add_argument("--noise", action="store_true")
    p.add_argument("--pixel-noise", type=float, default=0.0)
    p.add_argument("--out", default=None, help="reference-format CSV dir")
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("bench", help="time the bench's stages (window LM, KLT, "
                                     "global BA, end to end)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA device, float32; raises "
                        "without one); cpu runs float64 with no device times")
    p.add_argument("--details", default=None,
                   help="details JSON, merged into (default: BENCH_TORCH_DETAILS.json)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
