"""What the estimator's precision does to the image path of the PyTorch
port: ``runner.run_images`` over rendered 640×640 simulator frames at
``sim_images_config()``, with the tracker in the device's dtype and the
estimator in float32, in float64, and switched between the two at
initialization.

Run from the repository root on a machine with a CUDA device and nvcc:

    python3 scripts/torch_image_path_precision.py [--frames 155] [--probe]

``sim_images_config`` weights the IMU factors for a noise-free IMU
(acc_n 0.05, gyr_n 0.01, the independent noise model): the position rows
of one 33 ms interval carry a standard deviation of a few micrometres.
Float32 resolves 1e-6 m at the simulator's |P| ~ 16 m, so in float32 the
IMU position residual is evaluated to about its own size and the window
solve drifts.  For each precision the script prints APE against ground
truth, failures, LM iterations, kernel launches and wall time.

``--probe`` adds, for three window solves of the float64 run, the window's
cost and its IMU position residuals evaluated at the same state in both
precisions: the residuals' size, their float32 error, and the square root
of their information (with ``--device cpu``: the card replays its frames
from captured graphs, which the probe cannot read).  ``--device cpu`` runs everything on the CPU (the
kernel's plain version).
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

from vio_tpu_torch import metrics, runner, sim  # noqa: E402
from vio_tpu_torch.config import sim_images_config  # noqa: E402
from vio_tpu_torch.ops import linsolve  # noqa: E402
from vio_tpu_torch.solver import lm  # noqa: E402
from vio_tpu_torch.solver import window as W  # noqa: E402

PROBED_SOLVES = (10, 30, 45)
# (estimator dtype until the first pose, estimator dtype after it)
RUNS = ((torch.float32, torch.float32), (torch.float64, torch.float64),
        (torch.float32, torch.float64), (torch.float64, torch.float32))


def _cast(x, dtype):
    """A (nested) NamedTuple of tensors with its floating tensors in dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple):
        return type(x)(*(_cast(v, dtype) for v in x))
    return x


class Probe:
    """Stands in for ``lm.start``, the window solve's first step in the
    frame's loop program: before the chosen solves it evaluates the cost
    and the IMU residuals at the incoming state in float64 and in float32.
    It reads only where the program runs eagerly (the CPU): a captured
    graph cannot read back to the host."""

    def __init__(self, tag):
        self.tag = tag
        self.calls = 0
        self.start = lm.start

    def __call__(self, states, f, *args, **kwargs):
        if states.Ps.is_cuda and torch.cuda.is_current_stream_capturing():
            return self.start(states, f, *args, **kwargs)
        self.calls += 1
        if self.calls in PROBED_SOLVES and states.Ps.dtype == torch.float64:
            s32, f32 = _cast(states, torch.float32), _cast(f, torch.float32)
            chi64 = float(W.robust_chi2(states, f))
            chi32 = float(W.robust_chi2(s32, f32))
            r64 = W._imu_residuals(states, f)[:, 0:3]
            r32 = W._imu_residuals(s32, f32)[:, 0:3].double()
            info = W._imu_infos(f)[0].diagonal()[0:3]
            print(f"  probe, window solve {self.calls}: cost at the incoming state "
                  f"float64 {chi64:.8f} float32 {chi32:.8f}; IMU position residuals "
                  f"max |r| {float(r64.abs().max()):.3e} m, float32 error "
                  f"{float((r64 - r32).abs().max()):.3e} m, sqrt information "
                  f"{float(info.max().sqrt()):.3e} /m, |P| {float(states.Ps.abs().max()):.1f} m "
                  f"{self.tag}")
        return self.start(states, f, *args, **kwargs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=155)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs without one")
    ap.add_argument("--probe", action="store_true",
                    help="print the cost and IMU residuals in both precisions")
    args = ap.parse_args()
    if args.device is None and not torch.cuda.is_available():
        print("torch_image_path_precision: no CUDA device (pass --device cpu)",
              file=sys.stderr)
        return 2
    tag = "[cpu]"
    if args.device is None or torch.device(args.device).type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        tag = f"[{smi.splitlines()[0]}]"

    data = sim.generate(noise=False)
    cfg = sim_images_config()
    for before, after in RUNS:
        trk = runner.make_tracker(cfg, device=args.device)

        def switch(est, t, feats, after=after):
            if est.initialized:
                est.dtype = after

        probing = args.probe and (before, after) == (torch.float64, torch.float64)
        if probing:
            lm.start = Probe(tag)
        linsolve.gj_solve.launches = 0
        t0 = time.perf_counter()
        try:
            est, traj = runner.run_images(
                runner.sim_image_frames(data, n_frames=args.frames),
                data.imu_t, data.acc, data.gyr, cfg, tracker=trk,
                device=args.device, dtype=before, on_frame=switch)
        finally:
            if probing:
                lm.start = lm.start.start
        wall = time.perf_counter() - t0
        gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
        ape = metrics.ape_rmse(traj["p"], gt_p)["rmse"] if len(traj["t"]) > 2 else float("nan")
        first = int(np.argmax(traj["initialized"])) if est.initialized else -1
        print(f"estimator {str(before)[6:]} until the first pose, {str(after)[6:]} after; "
              f"tracker {str(trk.dtype)[6:]} on {est.device}: "
              f"{args.frames} frames, {len(traj['t'])} poses, first pose at published frame "
              f"{first}, failures {est.failure_count}, APE rmse {ape:.6f} m, "
              f"{sum(t['iterations'] for t in est.telemetry)} LM iterations, "
              f"{linsolve.gj_solve.launches} kernel launches, wall {wall:.2f} s {tag}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
