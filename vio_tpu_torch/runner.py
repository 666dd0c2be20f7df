"""Simulator playback: feed a SimData stream into the estimator with the
reference's IMU-image time pairing.

Port of the simulation half of ``vio_tpu/runner.py`` (reference:
vins-mono/src/System.cpp:289-443 getMeasurements / ProcessBackEnd with
boundary interpolation, test/run_vio_simulation.cpp — the tracker-bypass
path, System.cpp:75-165).  The image-stream drivers wait for the image
frontend's port.
"""
from __future__ import annotations

import numpy as np

from .config import VioConfig
from .estimator import Estimator


def feed_interval(est: Estimator, imu_t, acc, gyr, t_prev, t_img, i0):
    """Feed IMU samples in (t_prev, t_img] with boundary interpolation at
    t_img (the reference's send_imu/ProcessBackEnd pairing,
    System.cpp:372-396).  Returns the next unconsumed index."""
    i = i0
    current = t_prev
    n = len(imu_t)
    while i < n and imu_t[i] <= t_img:
        dt = imu_t[i] - current
        est.process_imu(dt, acc[i], gyr[i])
        current = imu_t[i]
        i += 1
    if i < n and current < t_img:
        # interpolate the straddling sample to land exactly on t_img
        w = (t_img - current) / (imu_t[i] - current)
        acc_b = (1 - w) * acc[i - 1] + w * acc[i]
        gyr_b = (1 - w) * gyr[i - 1] + w * gyr[i]
        est.process_imu(t_img - current, acc_b, gyr_b)
    return i


def run_sim(data, cfg: VioConfig | None = None, n_frames: int | None = None,
            progress=False, on_frame=None, device=None, dtype=None):
    """Run the estimator over a SimData dataset via the tracker-bypass
    path (landmark ids are feature ids; velocities zero like
    System.cpp:144-146).  ``device``/``dtype`` place the estimator's
    device work: the CUDA device unless the caller passes ``device="cpu"``
    (``device.resolve``); dtype defaults to float32 on CUDA, float64 on
    the CPU.
    Returns (est, traj dict)."""
    if cfg is None:
        from .config import sim_config
        cfg = sim_config()
    est = Estimator(cfg, device=device, dtype=dtype)

    n = len(data.cam_t) if n_frames is None else min(n_frames, len(data.cam_t))
    ts, ps, Rs_out, status = [], [], [], []
    imu_i = 0
    # est.td: camera-IMU time offset — t_imu = t_cam + td (parameters.cpp
    # TD), read live so online refinement shifts subsequent pairing.
    t_prev = data.cam_t[0] + est.td
    for k in range(n):
        t = data.cam_t[k] + est.td
        if k > 0:
            imu_i = feed_interval(est, data.imu_t, data.acc, data.gyr,
                                  t_prev, t, imu_i)
        t_prev = t
        feats = {}
        for lid in np.where(data.obs_valid[k])[0]:
            xy = data.obs_xy[k, lid]
            feats[int(lid)] = (np.array([xy[0], xy[1], 1.0]),
                               data.obs_uv[k, lid], np.zeros(2))
        est.process_image(feats, t)
        if est.initialized:
            tt, p, R = est.latest_pose()
            ts.append(tt)
            ps.append(p)
            Rs_out.append(R)
        status.append(est.initialized)
        if on_frame is not None:
            on_frame(est, t, feats)
        if progress and k % 50 == 0:
            print(f"frame {k}/{n} init={est.initialized} "
                  f"feats={len(est.fm.features)}")
    traj = dict(t=np.asarray(ts), p=np.asarray(ps), R=np.asarray(Rs_out),
                initialized=np.asarray(status))
    return est, traj


def sim_ground_truth_at(data, ts):
    """GT body positions/rotations at the given camera timestamps."""
    idx = np.searchsorted(data.cam_t, np.asarray(ts))
    return data.imu_p[idx], data.imu_R[idx]
