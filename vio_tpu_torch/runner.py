"""Dataset playback: feed simulator streams and image streams into
the estimator with the reference's IMU-image time pairing.

Port of the playback loops of ``vio_tpu/runner.py`` (reference:
vins-mono/src/System.cpp:289-443 getMeasurements / ProcessBackEnd with
boundary interpolation, test/run_vio_simulation.cpp — the tracker-bypass
path, System.cpp:75-165; test/run_euroc.cpp:150-184 — the image path).
``run_sim`` and ``run_images`` use no threads; ``run_images_async`` runs
the frontend in a producer thread.  All are deterministic: the estimator
consumes measurements in order.
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
    the CPU.  Where the stream carries descriptors (``data.descriptors``),
    each frame's go with its features, for the estimator's loop closer.
    Returns (est, traj dict)."""
    if cfg is None:
        from .config import sim_config
        cfg = sim_config()
    est = Estimator(cfg, device=device, dtype=dtype)

    n = len(data.cam_t) if n_frames is None else min(n_frames, len(data.cam_t))
    out = _Trajectory(est, on_frame)
    descriptors = getattr(data, "descriptors", None)
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
        desc = None if descriptors is None else {lid: descriptors[lid] for lid in feats}
        est.process_image(feats, t, desc)
        out.after_frame(t, feats)
        if progress and k % 50 == 0:
            print(f"frame {k}/{n} init={est.initialized} "
                  f"feats={len(est.fm.features)}")
    return est, out.as_dict()


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


def _published(frames, trk, cfg: VioConfig, td, progress=None):
    """The frontend half of image playback: every surviving frame goes
    through ``trk.read_image``; yields (t, feats) for the frames to publish
    into the estimator.  ``td()`` is the live camera-IMU offset;
    ``progress(n_frames, t, feats)`` is called every 50th frame.  Mirrors
    System::PubImageData (System.cpp:167-266):

    - the first two frames prime the stream (init_feature / first_image_flag
      — the reference returns before tracking on both);
    - a >1 s gap or backwards timestamp resets the frequency control
      (System.cpp:93-100);
    - every surviving frame is CLAHE'd + tracked; features are published
      only when the running publish rate is ≤ cfg.freq, and only features
      with track_cnt > 1 (System.cpp:228-266);
    - the first publish is skipped (System.cpp:252-257 — it carries no
      optical-flow velocities).
    """
    init_feature = False
    first_image_flag = True
    first_image_time = 0.0
    last_image_time = 0.0
    pub_count = 1
    init_pub = False
    n_frames = 0
    for t, img in frames:
        t = t + td()              # camera-IMU offset
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
            if init_pub:
                yield t, feats
            init_pub = True
        if progress is not None and n_frames % 50 == 0:
            progress(n_frames, t, feats)


class _Trajectory:
    """Collects what the playback loops return after each published frame."""

    def __init__(self, est: Estimator, on_frame=None):
        self.est = est
        self.on_frame = on_frame
        self.ts, self.ps, self.Rs, self.status = [], [], [], []

    def after_frame(self, t, feats):
        est = self.est
        if est.initialized:
            tt, p, R = est.latest_pose()
            self.ts.append(tt)
            self.ps.append(p)
            self.Rs.append(R)
        self.status.append(est.initialized)
        if self.on_frame is not None:
            self.on_frame(est, t, feats)

    def as_dict(self):
        return dict(t=np.asarray(self.ts), p=np.asarray(self.ps),
                    R=np.asarray(self.Rs), initialized=np.asarray(self.status))


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
    both).  Mirrors the reference playback stack (run_euroc.cpp:150-184,
    System.cpp:167-266); ``_published`` holds the stream's rules.

    Returns (est, traj dict) like run_sim.
    """
    est = Estimator(cfg, device=device, dtype=dtype)
    trk = tracker if tracker is not None else make_tracker(
        cfg, camera, device=device, dtype=dtype)

    imu_t = np.asarray(imu_t)
    acc = np.asarray(acc)
    gyr = np.asarray(gyr)

    def report(n_frames, t, feats):
        print(f"frame {n_frames} t={t:.2f} tracked={len(feats)} "
              f"init={est.initialized}")

    imu_i = 0
    pub_t_prev = None
    out = _Trajectory(est, on_frame)
    for t, feats in _published(frames, trk, cfg, lambda: est.td,
                               report if progress else None):
        if pub_t_prev is not None:
            imu_i = feed_interval(est, imu_t, acc, gyr, pub_t_prev, t, imu_i)
        else:
            imu_i = int(np.searchsorted(imu_t, t))
        pub_t_prev = t
        est.process_image(feats, t)
        out.after_frame(t, feats)
    return est, out.as_dict()


def run_images_async(frames, imu_t, acc, gyr, cfg: VioConfig,
                     camera=None, tracker=None, progress=False,
                     on_frame=None, device=None, dtype=None):
    """Pipeline-parallel image playback: the frontend (CLAHE + KLT
    tracking of frame t+1) runs in a producer thread, overlapped with the
    estimator's solve of frame t in the calling thread, connected by the
    C++ measurement pairer (csrc/pairer.cpp — the reference's System
    queue/thread architecture, run_euroc.cpp:163-171 producer threads +
    System.cpp:339-443 ProcessBackEnd consumer, as a GIL-released pairing
    queue).

    Same stream rules and arguments as ``run_images``; the IMU feed is the
    pairer's boundary-interpolated rows instead of ``feed_interval``.  The
    pairer is built with g++ at first use, before the producer starts, and
    a pairer that cannot be built raises: this function never runs on one
    thread.  Both threads enqueue on the device's current stream.  Returns
    (est, traj dict); the dict also holds the pairer's final ``stats()``
    under ``"pairer"``.
    """
    import threading

    from . import runtime

    est = Estimator(cfg, device=device, dtype=dtype)
    trk = tracker if tracker is not None else make_tracker(
        cfg, camera, device=device, dtype=dtype)
    pairer = runtime.make_pairer()
    if est.device.type == "cuda":
        # the kernel's library too: nothing is built from two threads
        from .ops import _build
        _build.load()

    imu_t = np.asarray(imu_t)
    acc = np.asarray(acc)
    gyr = np.asarray(gyr)

    packets: dict[int, dict] = {}
    producer_error: list[BaseException] = []

    def report(n_frames, t, feats):
        print(f"[frontend] frame {n_frames} t={t:.2f} tracked={len(feats)}")

    def produce():
        imu_i = 0
        for handle, (t, feats) in enumerate(_published(
                frames, trk, cfg, lambda: est.td, report if progress else None)):
            # stream IMU ahead of the frame so the pairer can close
            # the packet (System.cpp: imu thread runs ahead)
            while imu_i < len(imu_t) and imu_t[imu_i] <= t:
                pairer.push_imu(float(imu_t[imu_i]), *acc[imu_i], *gyr[imu_i])
                imu_i += 1
            if imu_i < len(imu_t):
                pairer.push_imu(float(imu_t[imu_i]), *acc[imu_i], *gyr[imu_i])
                imu_i += 1
            packets[handle] = feats
            pairer.push_frame(float(t), handle)

    def producer():
        try:
            produce()
        except BaseException as e:  # surface in the consumer
            producer_error.append(e)
        finally:
            pairer.close()

    th = threading.Thread(target=producer, name="vio-frontend", daemon=True)
    th.start()

    out = _Trajectory(est, on_frame)
    current = None
    n_solved = 0
    while True:
        pkt = pairer.next(wait=True)
        if pkt is None:
            break
        ft, handle, rows = pkt
        feats = packets.pop(handle)
        if current is None:
            current = ft          # first publish: no IMU integration yet
        else:
            for row in rows:
                rt = row[0]
                if rt <= current:
                    continue
                est.process_imu(rt - current, np.asarray(row[1:4]),
                                np.asarray(row[4:7]))
                current = rt
            if current < ft:
                current = ft
        est.process_image(feats, ft)
        out.after_frame(ft, feats)
        n_solved += 1
        if progress and n_solved % 50 == 0:
            print(f"[backend] solved {n_solved} t={ft:.2f} "
                  f"init={est.initialized}")
    th.join()
    if producer_error:
        raise producer_error[0]
    return est, dict(out.as_dict(), pairer=pairer.stats())


def sim_image_frames(data, n_frames: int | None = None, **render_kw):
    """Lazy (t, loader) frame stream rendered from a SimData sequence
    (sim.render_image) — the harness that exercises the REAL tracker path
    against exact geometry."""
    from . import sim as sim_mod
    n = len(data.cam_t) if n_frames is None else min(n_frames, len(data.cam_t))
    for k in range(n):
        yield float(data.cam_t[k]), (
            lambda kk=k: sim_mod.render_image(data, kk, **render_kw))


def run_euroc(seq_dir: str, cfg: VioConfig | None = None,
              n_frames: int | None = None, progress=False, tracker=None,
              device=None, dtype=None):
    """Play a EuRoC ASL sequence end to end through ``run_images``
    (run_euroc.cpp analog); ``cfg`` defaults to ``euroc_config()``.
    ``tracker``, ``device`` and ``dtype`` as ``run_images``.  Returns
    (est, traj, data)."""
    from . import io as vio_io
    if cfg is None:
        from .config import euroc_config
        cfg = euroc_config()
    data = vio_io.load_euroc(seq_dir)

    def frames():
        n = len(data.cam_t) if n_frames is None else min(n_frames, len(data.cam_t))
        for k in range(n):
            yield float(data.cam_t[k]), (
                lambda kk=k: vio_io.load_image(data.cam_files[kk]))

    est, traj = run_images(frames(), data.imu_t, data.acc, data.gyr, cfg,
                           tracker=tracker, progress=progress, device=device,
                           dtype=dtype)
    return est, traj, data
