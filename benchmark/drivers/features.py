"""Entry driver: the estimator on the simulator's feature stream.

The tracker-bypass path of the reference's run_vio_simulation.cpp, as
``vio_tpu_torch.runner.run_sim`` packs it: for each camera frame, the IMU
samples since the last one through ``runner.feed_interval``, then the
frame's visible landmarks (ids, normalised bearings, pixels, zero
velocities) through ``Estimator.process_image``.  One camera stream in a
closed loop: a frame is handed in when the last one's pose is out.  A
frame's latency runs from its handoff to its pose on the host.
"""
from __future__ import annotations

import time

import numpy as np

from benchmark.harness import program, traffic
from benchmark.harness.trace import Tracer


def _features(data, k: int) -> dict:
    feats = {}
    for lid in np.flatnonzero(data.obs_valid[k]):
        xy = data.obs_xy[k, lid]
        feats[int(lid)] = (np.array([xy[0], xy[1], 1.0]), data.obs_uv[k, lid], np.zeros(2))
    return feats


def run(run, patch=None) -> None:
    import torch

    from vio_tpu_torch import runner
    from vio_tpu_torch.estimator import Estimator

    cell = run.cell
    cfg = traffic.vio_config(cell.config)
    data = traffic.generate(cell, run.seed, run.seconds)
    feats = [_features(data, k) for k in range(len(data.cam_t))]

    est_dtype = cell.config["estimator_dtype"]
    if run.control:
        est_dtype = cell.workload["control"].get("estimator_dtype", est_dtype)
    est = Estimator(cfg, device=run.device, dtype=getattr(torch, est_dtype))
    run._est = est
    if patch is not None:
        patch(run)
    steps = program.FrameSteps(cell.workload["check"]["sample_frames"], run.seed)
    steps.install()
    run._steps = steps
    tracer = Tracer(run, program.counters)

    n = len(data.cam_t)
    imu_i = 0
    t_prev = data.cam_t[0] + est.td
    k = 0
    warming = True
    c0 = t0 = None
    while True:
        if k >= n:
            if warming:
                raise SystemExit("the stream ran out during the warm-up")
            run.exhausted(k)
        if warming and k > 0 and run.warm(program.counters()["captures"]):
            warming = False
            if run.device != "cpu":
                torch.cuda.synchronize()
            c0, t0 = program.counters(), len(est.telemetry)
            steps.active = True
            run.open_window()
        if not warming and not run.is_open():
            break
        t_in = time.perf_counter()
        with tracer.span("frame"):
            t = data.cam_t[k] + est.td
            if k > 0:
                with tracer.span("feed_imu"):
                    imu_i = runner.feed_interval(est, data.imu_t, data.acc, data.gyr,
                                                 t_prev, t, imu_i)
            t_prev = t
            fails = est.failure_count
            with tracer.span("process_image"):
                est.process_image(feats[k], t)
            ok = est.initialized and est.failure_count == fails
            if ok:
                est.latest_pose()
        if not warming:
            run.frame(t_in, time.perf_counter(), ok, program.counters()["captures"])
            tracer.tick()
        k += 1
    tracer.stop()
    run.close_window()
    c1 = program.counters()
    run.counts = {key: c1[key] - c0[key] for key in c0}
    run.telemetry = est.telemetry[t0:]
    steps.active = False
    run.records = steps.records


def release(run) -> None:
    run._steps.uninstall()
    run._est = None
    program.release()
