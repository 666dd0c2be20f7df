"""The pose-graph judge's readings on the loop circuit, in one process.

    python3 benchmark/loop_readings.py --seeds <first> <n> \
        [--control-seeds <first> <n>] [--device cpu]

A seed is one run of the 600-frame closed circuit (the simulator's
stream with its IMU noise, from the seed; the priors' noise densities a
third of the truth's) through the estimator in float64, with a loop
closer fed each keyframe: one fixed random descriptor per landmark, drawn
from the seed, BoW retrieval, Hamming matches, PnP loop edges and, after
each accepted loop, a pose-graph solve.  Every solve is recorded
(``program.PoseGraphSolves``) and, once the circuit has run, judged on
the card by the pose graph's judge (``reference/judges/posegraph.py``).
A control seed runs the closer in float32, the estimator in float64.
Prints one JSON line a seed: the circuit's keyframes, loops and solves,
the judge's numbers and each solve's.  No cell runs this yet, and the
benchmark's own runs never do; the loop cell's driver will give these
readings through ``readings.py``.
"""
import argparse
import json
import os
import sys
import time

for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_v] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import core, program, stream  # noqa: E402
from benchmark.reference.judges import posegraph as judge  # noqa: E402

FRAMES = 600


def circuit(seed: int, closer_dtype, device: str) -> tuple[dict, list]:
    import numpy as np
    import torch
    from vio_tpu_torch import runner
    from vio_tpu_torch.config import sim_config
    from vio_tpu_torch.estimator import MARGIN_OLD
    from vio_tpu_torch.loop import closer as closer_mod

    data = stream.generate(noise=True, seed=seed, t_end=FRAMES / 30.0, pixel_noise=0.0)
    cfg = sim_config(acc_n=0.2687 / 3.0, gyr_n=0.2121 / 3.0)
    closer = closer_mod.LoopCloser(R_ic=cfg.R_ic, t_ic=cfg.t_ic, min_gap=80, train_after=25,
                                   loop_weight=5.0, focal=cfg.focal_length, device=device,
                                   dtype=closer_dtype)
    desc = np.random.default_rng([seed, 1]).integers(
        0, 2 ** 32, size=(len(data.landmarks), 8), dtype=np.uint32)

    def on_frame(est, t, feats):
        if not est.initialized or est.marg_flag != MARGIN_OLD:
            return
        ids, xy, pts_cam = est.current_landmarks()
        if len(ids) < 10:
            return
        tt, p, R = est.latest_pose()
        closer.add_keyframe(tt, p, R, desc[ids], xy, pts_cam=pts_cam, pts_xy=xy)

    rec = program.PoseGraphSolves(10 ** 6, seed)
    rec.install()
    rec.active = True
    t0 = time.perf_counter()
    try:
        est, _ = runner.run_sim(data, cfg, n_frames=FRAMES, on_frame=on_frame, device=device,
                                dtype=torch.float64)
    finally:
        rec.uninstall()
    info = dict(frames=FRAMES, keyframes=len(closer.kfs), loops=len(closer.loops),
                solves=len(rec.records), failures=est.failure_count,
                circuit_s=time.perf_counter() - t0)
    return info, rec.records


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 0))
    ap.add_argument("--control-seeds", type=int, nargs=2, default=(0, 0))
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    core.cache_env()
    import torch
    plan = [(s, False) for s in range(a.seeds[0], a.seeds[0] + a.seeds[1])]
    plan += [(s, True) for s in range(a.control_seeds[0], a.control_seeds[0] + a.control_seeds[1])]
    run = core.Run(None, 0, 0, False, a.device, time.perf_counter())  # a cell's: only its device
    for seed, control in plan:
        info, records = circuit(seed, torch.float32 if control else torch.float64, a.device)
        t0 = time.perf_counter()
        numbers, items = judge.judge(run, records, {})
        for r, j in zip(records, items):
            j["iterations"] = r["outputs"]["iterations"]
        print(json.dumps(dict(seed=seed, control=control, **info, numbers=numbers,
                              judge_s=time.perf_counter() - t0, solves_judged=items)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
