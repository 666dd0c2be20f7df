"""Hybrid real-sensor flagship dataset: REAL MH-05 IMU + camera stamps,
synthetic pixels rendered from the IMU-consistent trajectory.

Numpy copy of ``vio_tpu/hybrid.py`` on the port's ``sim``, ``io``,
``calib.allan`` and ``utils/lie_np``.

The reference's flagship entry replays EuRoC MH-05 images + IMU
(reference: vins-mono/test/run_euroc.cpp:150-184).  This environment has
the full REAL sensor streams the reference ships
(vins-mono/config/MH_05_imu0.txt — 22 721 ADIS16448 samples — and
MH_05_cam0.txt — 2 273 camera stamps) but no image files, so the pixels
are synthesized CONSISTENTLY with the real IMU:

- The ground-truth trajectory is DEFINED as the midpoint dead-reckoning
  of the real IMU stream with the static-prefix bias estimate removed.
  By construction the real samples are then exactly the ideal IMU of
  this trajectory plus the constant static-prefix bias — so the full
  real bias wake-up is a REAL signal the estimator must solve, and the
  trajectory carries the sensor's true dynamics (vibration, aggressive
  MAV motion, the pre-flight wiggle).
- Landmarks are cast through the camera frustum along the trajectory and
  rendered at the REAL camera stamps (real 20 Hz cadence, real jitter,
  real camera/IMU stamp interleaving) with EuRoC-magnitude radial
  distortion, through the full CLAHE→KLT pixel pipeline.

What stays synthetic: the scene texture and the white-noise floor
relative to GT (absorbed into the trajectory definition).  What is real:
every IMU sample, every timestamp, the bias wake-up, the motion itself.
"""
from __future__ import annotations

import numpy as np

from . import sim
from .utils import lie_np

GRAVITY = 9.81


def _so3_exp_np(w):
    th2 = float(w @ w)
    K = np.array([[0.0, -w[2], w[1]],
                  [w[2], 0.0, -w[0]],
                  [-w[1], w[0], 0.0]])
    if th2 < 1e-16:
        return np.eye(3) + K
    th = np.sqrt(th2)
    return (np.eye(3) + np.sin(th) / th * K +
            (1.0 - np.cos(th)) / th2 * (K @ K))


def _gravity_align_R0(a_static):
    """World-from-body R with measured specific force mapped to +z and
    zero yaw (utility.cpp g2R semantics, host numpy)."""
    a = a_static / np.linalg.norm(a_static)
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(a, z)
    c = float(a @ z)
    if c < -1.0 + 1e-8:
        R = np.diag([1.0, -1.0, -1.0])
    else:
        K = np.array([[0.0, -v[2], v[1]],
                      [v[2], 0.0, -v[0]],
                      [-v[1], v[0], 0.0]])
        R = np.eye(3) + K + K @ K / (1.0 + c)
    ypr = lie_np.mat_to_ypr_np(R)
    return lie_np.ypr_to_mat_np(np.array([-ypr[0], 0.0, 0.0])) @ R


def static_init(t, acc, gyr):
    """(bg, ba, R0) from the stream's static prefix: gyro bias, the
    along-gravity accel-bias split (the gravity-parallel component is
    unobservable at rest — it aliases with |g|), and the gravity-aligned
    zero-yaw initial orientation."""
    from .calib import allan
    dt_med = float(np.median(np.diff(t)))
    n_static = max(int(allan.detect_static_prefix(gyr, dt=dt_med)), 200)
    bg = gyr[:n_static].mean(axis=0)
    a0 = acc[:n_static].mean(axis=0)
    ba = a0 * (1.0 - GRAVITY / np.linalg.norm(a0))
    R0 = _gravity_align_R0(a0 - ba)
    return bg, ba, R0


def dead_reckon(t, acc, gyr, bg, ba, R0):
    """Midpoint integration of the (bias-corrected) real IMU — the same
    propagation rule the estimator uses (estimator.py process_imu), so
    the samples are exactly consistent with the returned trajectory.
    Returns (Rs (N,3,3), ps (N,3), vs (N,3)) world-frame at each stamp."""
    n = len(t)
    Rs = np.empty((n, 3, 3))
    ps = np.zeros((n, 3))
    vs = np.zeros((n, 3))
    Rs[0] = R0
    g = np.array([0.0, 0.0, GRAVITY])
    for k in range(1, n):
        dt = t[k] - t[k - 1]
        w = 0.5 * (gyr[k - 1] + gyr[k]) - bg
        R_new = Rs[k - 1] @ _so3_exp_np(w * dt)
        a0 = Rs[k - 1] @ (acc[k - 1] - ba) - g
        a1 = R_new @ (acc[k] - ba) - g
        a = 0.5 * (a0 + a1)
        ps[k] = ps[k - 1] + vs[k - 1] * dt + 0.5 * a * dt * dt
        vs[k] = vs[k - 1] + a * dt
        Rs[k] = R_new
    return Rs, ps, vs


def _slerp_R(Ra, Rb, w):
    """Geodesic interpolation between rotation matrices."""
    dR = Ra.T @ Rb
    q = lie_np.mat_to_quat_np(dR)      # axis-angle of dR via quaternion
    th = 2.0 * np.arccos(np.clip(q[3], -1.0, 1.0))
    if th < 1e-12:
        return Ra
    axis = q[:3] / np.sin(th / 2.0)
    return Ra @ _so3_exp_np(axis * th * w)


def generate_hybrid(imu_txt: str, cam_txt: str,
                    t_start: float = 0.0, duration: float = 30.0,
                    n_rays_per_kf: int = 5, kf_every: int = 8,
                    depth_lo: float = 3.0, depth_hi: float = 12.0,
                    seed: int = 0,
                    fx: float = 460.0, fy: float = 460.0,
                    cx: float = 255.0, cy: float = 255.0,
                    image_w: float = 640.0, image_h: float = 640.0,
                    k1: float = 0.0, k2: float = 0.0,
                    p1: float = 0.0, p2: float = 0.0,
                    R_bc=None, t_bc=None) -> sim.SimData:
    """Build a SimData whose IMU stream is the REAL file content and whose
    camera observations are rendered from the IMU-consistent trajectory at
    the REAL camera stamps in [t_start, t_start+duration] (seconds from
    stream start)."""
    from . import io as vio_io

    t, acc, gyr = vio_io.load_imu_txt(imu_txt)
    cam_t, _ = vio_io.load_cam_stamps_txt(cam_txt)
    t0 = t[0]
    t = np.asarray(t) - t0
    cam_t = np.asarray(cam_t) - t0

    bg, ba, R0 = static_init(t, acc, gyr)

    t_end = t_start + duration
    n_imu = int(np.searchsorted(t, t_end + 0.2))          # pad for pairing
    t = t[:n_imu]
    acc = np.asarray(acc[:n_imu])
    gyr = np.asarray(gyr[:n_imu])
    Rs, ps, vs = dead_reckon(t, acc, gyr, bg, ba, R0)

    sel = (cam_t >= max(t_start, t[1])) & (cam_t <= min(t_end, t[-1] - 0.05))
    cam_sel = cam_t[sel]
    M = len(cam_sel)

    # GT at the real camera stamps: linear p/v + geodesic R interpolation
    idx = np.searchsorted(t, cam_sel, side="right") - 1
    idx = np.clip(idx, 0, n_imu - 2)
    w = (cam_sel - t[idx]) / np.maximum(t[idx + 1] - t[idx], 1e-9)
    cam_body_p = ps[idx] * (1 - w[:, None]) + ps[idx + 1] * w[:, None]
    cam_body_v = vs[idx] * (1 - w[:, None]) + vs[idx + 1] * w[:, None]
    cam_body_R = np.stack([_slerp_R(Rs[i], Rs[i + 1], wi)
                           for i, wi in zip(idx, w)])

    if R_bc is None:
        R_bc = np.array([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0],
                         [0.0, 1.0, 0.0]])
    if t_bc is None:
        t_bc = np.array([0.05, 0.04, 0.03])
    cam_R_wc = cam_body_R @ R_bc
    cam_p_wc = cam_body_p + np.einsum("mij,j->mi", cam_body_R, t_bc)

    # landmarks: rays cast through random pixels of every kf_every-th
    # real frame at random depth — guarantees scene coverage wherever the
    # real trajectory goes (incl. integration drift)
    rng = np.random.default_rng(seed)
    pts = []
    for m in range(0, M, kf_every):
        u = rng.uniform(0.12 * image_w, 0.88 * image_w, n_rays_per_kf)
        v = rng.uniform(0.12 * image_h, 0.88 * image_h, n_rays_per_kf)
        d = rng.uniform(depth_lo, depth_hi, n_rays_per_kf)
        bearing = np.stack([(u - cx) / fx, (v - cy) / fy,
                            np.ones(n_rays_per_kf)], axis=1)
        pts.append(cam_p_wc[m] + (bearing * d[:, None]) @ cam_R_wc[m].T)
    pts = np.concatenate(pts, axis=0)

    # projections (same math as sim.generate, radtan on the normal plane)
    pc = np.einsum("mji,mlj->mli", cam_R_wc, pts[None, :, :] -
                   cam_p_wc[:, None, :])
    z = pc[..., 2]
    xy = pc[..., :2] / np.where(np.abs(z[..., None]) < 1e-12, 1e-12,
                                z[..., None])
    if k1 or k2 or p1 or p2:
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        uv = np.stack([fx * xd + cx, fy * yd + cy], axis=-1)
    else:
        uv = np.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], axis=-1)
    valid = (z > 0.5) & (uv[..., 0] > 0) & (uv[..., 0] < image_w) & \
            (uv[..., 1] > 0) & (uv[..., 1] < image_h)

    return sim.SimData(
        imu_t=t, acc=acc, gyr=gyr,
        acc_bias=np.tile(ba, (n_imu, 1)), gyr_bias=np.tile(bg, (n_imu, 1)),
        cam_t=cam_sel, cam_p=cam_p_wc, cam_R=cam_R_wc,
        imu_p=cam_body_p, imu_R=cam_body_R, imu_v=cam_body_v,
        landmarks=pts, obs_xy=xy, obs_uv=uv, obs_valid=valid,
    )
