"""Dataset playback: feed simulator streams and image streams into
the estimator with the reference's IMU-image time pairing.

Port of the synchronous playback loops of ``vio_tpu/runner.py`` (reference:
vins-mono/src/System.cpp:289-443 getMeasurements / ProcessBackEnd with
boundary interpolation, test/run_vio_simulation.cpp — the tracker-bypass
path, System.cpp:75-165; test/run_euroc.cpp:150-184 — the image path).
No threads: playback is deterministic and the estimator consumes
measurements in order.
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


# ---------------------------------------------------------------------------
# Image-stream playback: the run_euroc analog
# (reference: test/run_euroc.cpp:150-184 + System::PubImageData(cv::Mat)
#  System.cpp:167-266 — CLAHE→KLT tracking every frame, frequency-gated
#  publishing into the estimator, camera-stream discontinuity reset)
# ---------------------------------------------------------------------------

def camera_from_config(cfg: VioConfig):
    from .camera import PinholeCamera
    return PinholeCamera(fx=cfg.fx, fy=cfg.fy, cx=cfg.cx, cy=cfg.cy,
                         k1=cfg.k1, k2=cfg.k2, p1=cfg.p1, p2=cfg.p2,
                         width=cfg.image_width, height=cfg.image_height)


def make_tracker(cfg: VioConfig, camera=None, seed: int = 0,
                 device=None, dtype=None):
    """The configuration's FeatureTracker, on the CUDA device unless the
    caller passes ``device="cpu"`` (``device.resolve``)."""
    from .features.tracker import FeatureTracker
    if camera is None:
        camera = camera_from_config(cfg)
    return FeatureTracker(camera, max_cnt=cfg.max_cnt, min_dist=cfg.min_dist,
                          f_thresh_px=cfg.f_threshold,
                          focal=cfg.focal_length, equalize=cfg.equalize,
                          seed=seed, device=device, dtype=dtype)


def run_images(frames, imu_t, acc, gyr, cfg: VioConfig,
               camera=None, tracker=None, progress=False, on_frame=None,
               device=None, dtype=None):
    """Drive an image stream through the KLT tracker into the estimator.

    frames: iterable of (t_seconds, image) where image is an (H, W) array
    or a zero-arg callable returning one (lazy decode).  imu_t/acc/gyr:
    full-rate IMU arrays.  ``device``/``dtype`` place the estimator's and
    the tracker's device work: the CUDA device unless the caller passes
    ``device="cpu"`` (``device.resolve``); a ``tracker`` given by the
    caller keeps its own.  ``sim_images_config()`` weights the IMU for a
    noise-free sensor and needs the estimator in float64 to meet its
    accuracy (``dtype=torch.float64``, with a float32 tracker of the
    caller's if wanted; scripts/torch_image_path_precision.py measures
    both).  Mirrors the reference playback stack
    (run_euroc.cpp:150-184, System.cpp:167-266):

    - the first two frames prime the stream (init_feature / first_image_flag
      — the reference returns before tracking on both);
    - a >1 s gap or backwards timestamp resets the frequency control
      (System.cpp:93-100);
    - every surviving frame is CLAHE'd + tracked; features are published
      into the estimator only when the running publish rate is ≤ cfg.freq,
      and only features with track_cnt > 1 (System.cpp:228-266).

    Returns (est, traj dict) like run_sim.
    """
    est = Estimator(cfg, device=device, dtype=dtype)
    trk = tracker if tracker is not None else make_tracker(
        cfg, camera, device=device, dtype=dtype)

    imu_t = np.asarray(imu_t)
    acc = np.asarray(acc)
    gyr = np.asarray(gyr)

    init_feature = False
    first_image_flag = True
    first_image_time = 0.0
    last_image_time = 0.0
    pub_count = 1
    init_pub = False          # skip the first publish (System.cpp:252-257 —
                              # it carries no optical-flow velocities)
    imu_i = 0
    pub_t_prev = None

    ts, ps, Rs_out, status = [], [], [], []
    n_frames = 0
    for t, img in frames:
        t = t + est.td            # camera-IMU offset
        n_frames += 1
        if not init_feature:
            init_feature = True          # System.cpp:169-174
            continue
        if first_image_flag:
            first_image_flag = False     # System.cpp:176-182
            first_image_time = t
            last_image_time = t
            continue
        if t - last_image_time > 1.0 or t < last_image_time:
            # unstable camera stream → reset frequency control
            # (System.cpp:93-100 / :185-192)
            first_image_flag = True
            last_image_time = 0.0
            pub_count = 1
            continue
        last_image_time = t

        elapsed = max(t - first_image_time, 1e-9)
        pub_this_frame = round(pub_count / elapsed) <= cfg.freq
        if pub_this_frame and abs(pub_count / elapsed - cfg.freq) < 0.01 * cfg.freq:
            first_image_time = t
            pub_count = 0

        if callable(img):
            img = img()
        feats = trk.read_image(np.asarray(img), t)

        if pub_this_frame:
            pub_count += 1
            if not init_pub:
                init_pub = True
                continue
            if pub_t_prev is not None:
                imu_i = feed_interval(est, imu_t, acc, gyr, pub_t_prev, t, imu_i)
            else:
                imu_i = int(np.searchsorted(imu_t, t))
            pub_t_prev = t
            est.process_image(feats, t)
            if est.initialized:
                tt, p, R = est.latest_pose()
                ts.append(tt)
                ps.append(p)
                Rs_out.append(R)
            status.append(est.initialized)
            if on_frame is not None:
                on_frame(est, t, feats)
        if progress and n_frames % 50 == 0:
            print(f"frame {n_frames} t={t:.2f} tracked={len(feats)} "
                  f"init={est.initialized}")

    traj = dict(t=np.asarray(ts), p=np.asarray(ps), R=np.asarray(Rs_out),
                initialized=np.asarray(status))
    return est, traj


def sim_image_frames(data, n_frames: int | None = None, **render_kw):
    """Lazy (t, loader) frame stream rendered from a SimData sequence
    (sim.render_image) — the harness that exercises the REAL tracker path
    against exact geometry."""
    from . import sim as sim_mod
    n = len(data.cam_t) if n_frames is None else min(n_frames, len(data.cam_t))
    for k in range(n):
        yield float(data.cam_t[k]), (
            lambda kk=k: sim_mod.render_image(data, kk, **render_kw))
