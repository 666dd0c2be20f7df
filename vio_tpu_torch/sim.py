"""Analytic VIO simulator: closed-form trajectory + exact IMU + landmarks.

Port of ``vio_tpu/sim.py`` (host numpy) — the reference simulator
(reference: 17-vins-initialization/simulator/src/imu.cpp:76-117 MotionModel,
imu.cpp:50-74 addIMUnoise, simulator/src/main.cpp CreatePointsLines).
Same constants, so accuracy numbers are directly comparable with the
reference's published APE (BASELINE.md row 1-4).

Everything is computed in one vectorized numpy shot over the full time
grid, in float64.  ``render_blobs``/``render_image`` draw the frames the
image frontend is exercised on.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# trajectory constants (reference: simulator/src/imu.cpp:80-97)
ELLIPSE_X = 15.0
ELLIPSE_Y = 20.0
Z_AMP = 1.0
K1 = 10.0
K = np.pi / 10.0
K_ROLL = 0.1
K_PITCH = 0.2
GRAVITY_W = np.array([0.0, 0.0, -9.81])  # ENU, reference imu.cpp:104


def euler_to_mat(euler):
    """XYZ euler (roll, pitch, yaw) → R_wb (reference imu.cpp:10-25)."""
    r, p, y = euler[..., 0], euler[..., 1], euler[..., 2]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    m = np.stack([
        cy * cp, cy * sp * sr - sy * cr, sy * sr + cy * cr * sp,
        sy * cp, cy * cr + sy * sr * sp, sp * sy * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], axis=-1)
    return m.reshape(euler.shape[:-1] + (3, 3))


def euler_rates_to_body_rates(euler):
    """Mapping euler-angle rates → body angular velocity
    (reference imu.cpp:27-41)."""
    r, p = euler[..., 0], euler[..., 1]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    z = np.zeros_like(r)
    one = np.ones_like(r)
    m = np.stack([
        one, z, -sp,
        z, cr, sr * cp,
        z, -sr, cr * cp,
    ], axis=-1)
    return m.reshape(euler.shape[:-1] + (3, 3))


def motion_model(t):
    """Exact state + IMU measurements at times t (...,).

    Returns dict of: p_wb, v_wb, R_wb (..., 3, 3), acc_b, gyr_b.
    (reference imu.cpp:76-117 MotionModel)."""
    t = np.asarray(t, np.float64)
    kt = K * t
    pos = np.stack([ELLIPSE_X * np.cos(kt) + 5.0,
                    ELLIPSE_Y * np.sin(kt) + 5.0,
                    Z_AMP * np.sin(K1 * kt) + 5.0], axis=-1)
    dp = np.stack([-K * ELLIPSE_X * np.sin(kt),
                   K * ELLIPSE_Y * np.cos(kt),
                   Z_AMP * K1 * K * np.cos(K1 * kt)], axis=-1)
    K2 = K * K
    ddp = np.stack([-K2 * ELLIPSE_X * np.cos(kt),
                    -K2 * ELLIPSE_Y * np.sin(kt),
                    -Z_AMP * K1 * K1 * K2 * np.sin(K1 * kt)], axis=-1)
    euler = np.stack([K_ROLL * np.cos(t), K_PITCH * np.sin(t), kt], axis=-1)
    euler_rates = np.stack([-K_ROLL * np.sin(t), K_PITCH * np.cos(t),
                            np.full_like(t, K)], axis=-1)
    R_wb = euler_to_mat(euler)
    gyr_b = np.einsum("...ij,...j->...i", euler_rates_to_body_rates(euler), euler_rates)
    gn = np.asarray(GRAVITY_W, pos.dtype)
    acc_b = np.einsum("...ji,...j->...i", R_wb, ddp - gn)
    return dict(p_wb=pos, v_wb=dp, R_wb=R_wb, acc_b=acc_b, gyr_b=gyr_b, t=t)


@dataclasses.dataclass
class SimData:
    """Full simulated dataset (numpy, host-side)."""
    imu_t: np.ndarray          # (N,)
    acc: np.ndarray            # (N, 3) measured
    gyr: np.ndarray            # (N, 3) measured
    acc_bias: np.ndarray       # (N, 3) ground-truth bias trajectory
    gyr_bias: np.ndarray       # (N, 3)
    cam_t: np.ndarray          # (M,)
    cam_p: np.ndarray          # (M, 3)   ground-truth camera position
    cam_R: np.ndarray          # (M, 3, 3) ground-truth camera rotation
    imu_p: np.ndarray          # (M, 3)   GT body position at camera times
    imu_R: np.ndarray          # (M, 3, 3)
    imu_v: np.ndarray          # (M, 3)
    landmarks: np.ndarray      # (L, 3) world points
    obs_xy: np.ndarray         # (M, L, 2) normalized coords
    obs_uv: np.ndarray         # (M, L, 2) pixel coords
    obs_valid: np.ndarray      # (M, L) bool
    # (L, 8) uint32: one packed 256-bit descriptor per landmark, where the
    # stream carries them (generate's descriptor_seed), else None
    descriptors: np.ndarray | None = None


def house_landmarks() -> np.ndarray:
    """The reference's house model points: endpoints of the line segments,
    deduplicated, plus a +(0.5,0.5,-0.5) shifted copy
    (reference: simulator/src/main.cpp:17-84 CreatePointsLines).
    The geometry is re-specified here as a simple house wireframe with the
    same point count scale (the exact coordinates only shift the scene)."""
    base = []
    # house footprint: a 10x10 box from x,y in [-5,5], z in [0,4], ridge at z=6
    for x in (-5.0, 5.0):
        for y in (-5.0, 5.0):
            base.append((x, y, 0.0))
            base.append((x, y, 4.0))
    for y in (-5.0, 5.0):
        base.append((0.0, y, 6.0))  # roof ridge endpoints
    # door + window corners on the front wall for extra texture
    base += [(-1.0, -5.0, 0.0), (1.0, -5.0, 0.0), (-1.0, -5.0, 2.5), (1.0, -5.0, 2.5),
             (2.5, -5.0, 1.5), (4.0, -5.0, 1.5), (2.5, -5.0, 3.0), (4.0, -5.0, 3.0),
             (-4.0, -5.0, 1.5), (-2.5, -5.0, 1.5), (-4.0, -5.0, 3.0), (-2.5, -5.0, 3.0)]
    pts = np.array(sorted(set(base)), dtype=np.float64)
    shifted = pts + np.array([0.5, 0.5, -0.5])
    # surrounding structure so every camera pose on the ellipse keeps ≥20
    # landmarks in view (house.txt itself is absent from the checkout; the
    # scene only needs comparable density, not identical coordinates)
    rng = np.random.default_rng(42)
    cloud = rng.uniform(low=[-9.0, -9.0, 0.0], high=[9.0, 9.0, 9.0], size=(40, 3))
    return np.concatenate([pts, shifted, cloud], axis=0)


def generate(noise: bool = False,
             seed: int = 0,
             t_end: float = 20.0,
             imu_hz: int = 200,
             cam_hz: int = 30,
             fx: float = 460.0, fy: float = 460.0,
             cx: float = 255.0, cy: float = 255.0,
             image_w: float = 640.0, image_h: float = 640.0,
             gyro_noise_sigma: float = 0.015,
             acc_noise_sigma: float = 0.019,
             gyro_bias_sigma: float = 1.0e-5,
             acc_bias_sigma: float = 1.0e-4,
             pixel_noise: float = 0.0,
             k1: float = 0.0, k2: float = 0.0,
             p1: float = 0.0, p2: float = 0.0,
             R_bc=None, t_bc=None, descriptor_seed: int | None = None) -> SimData:
    """Generate the full dataset (constants = reference simulator defaults,
    simulator/include/param.h:14-36).

    k1/k2/p1/p2: radial-tangential distortion applied to the PIXEL
    observations obs_uv (so rendered frames carry real lens distortion the
    frontend must undo via camera.lift, like EuRoC's camera —
    reference config/euroc_config.yaml distortion_parameters).  obs_xy
    stays the IDEAL normalized coordinate (the tracker-bypass path feeds
    undistorted measurements by definition).

    descriptor_seed: when given, the stream carries one fixed random 256-bit
    descriptor per landmark drawn from it (``SimData.descriptors``), what a
    distinctive texture patch would give a loop closer
    (tests/test_loop_integration.py's oracle)."""
    if R_bc is None:
        R_bc = np.array([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    if t_bc is None:
        t_bc = np.array([0.05, 0.04, 0.03])

    imu_dt = 1.0 / imu_hz
    # reference accumulates float t += 1/200; use the exact same grid length
    n_imu = int(round(t_end * imu_hz))
    imu_t = np.arange(n_imu) * imu_dt
    n_cam = int(round(t_end * cam_hz))
    cam_t = np.arange(n_cam) * (1.0 / cam_hz)

    imu = motion_model(imu_t)
    cam = motion_model(cam_t)

    acc = np.array(imu["acc_b"], copy=True)
    gyr = np.array(imu["gyr_b"], copy=True)
    gyr_bias = np.zeros_like(gyr)
    acc_bias = np.zeros_like(acc)
    if noise:
        rng = np.random.default_rng(seed)
        # white noise / sqrt(dt) + random-walk bias * sqrt(dt), vectorized
        # (reference imu.cpp:50-74 addIMUnoise; bias at step i is the walk
        #  BEFORE the i-th increment, i.e. starts at 0)
        sq = np.sqrt(imu_dt)
        gyr_bias[1:] = np.cumsum(gyro_bias_sigma * sq * rng.standard_normal((n_imu - 1, 3)), axis=0)
        acc_bias[1:] = np.cumsum(acc_bias_sigma * sq * rng.standard_normal((n_imu - 1, 3)), axis=0)
        gyr += gyro_noise_sigma * rng.standard_normal((n_imu, 3)) / sq + gyr_bias
        acc += acc_noise_sigma * rng.standard_normal((n_imu, 3)) / sq + acc_bias

    # camera poses: T_wc = T_wb * T_bc (reference main.cpp:151-153)
    cam_R_wc = cam["R_wb"] @ R_bc
    cam_p_wc = cam["p_wb"] + np.einsum("mij,j->mi", cam["R_wb"], t_bc)

    # landmark projections (reference main.cpp:160-210)
    pts = house_landmarks()
    pc = np.einsum("mji,mlj->mli", cam_R_wc, pts[None, :, :] - cam_p_wc[:, None, :])
    z = pc[..., 2]
    xy = pc[..., :2] / np.where(np.abs(z[..., None]) < 1e-12, 1e-12, z[..., None])
    if k1 or k2 or p1 or p2:
        # radtan distortion on the normalized plane (camera.py:43 distort;
        # reference camodocal PinholeCamera::distortion)
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        rad = 1.0 + k1 * r2 + k2 * r2 * r2
        xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        uv = np.stack([fx * xd + cx, fy * yd + cy], axis=-1)
    else:
        uv = np.stack([fx * xy[..., 0] + cx, fy * xy[..., 1] + cy], axis=-1)
    valid = (z > 0) & (uv[..., 0] > 0) & (uv[..., 0] < image_w) & \
            (uv[..., 1] > 0) & (uv[..., 1] < image_h)
    if noise and pixel_noise > 0:
        rng2 = np.random.default_rng(seed + 1)
        duv = pixel_noise * rng2.standard_normal(uv.shape)
        uv = uv + duv
        if k1 or k2 or p1 or p2:
            # first-order: a pixel perturbation maps to duv/f on the
            # normalized plane (exact inverse would need iterative undistort)
            xy = xy + duv / np.array([fx, fy])
        else:
            xy = np.stack([(uv[..., 0] - cx) / fx,
                           (uv[..., 1] - cy) / fy], axis=-1)

    return SimData(
        imu_t=imu_t, acc=acc, gyr=gyr, acc_bias=acc_bias, gyr_bias=gyr_bias,
        cam_t=cam_t, cam_p=cam_p_wc, cam_R=cam_R_wc,
        imu_p=np.asarray(cam["p_wb"]), imu_R=np.asarray(cam["R_wb"]),
        imu_v=np.asarray(cam["v_wb"]),
        landmarks=pts, obs_xy=xy, obs_uv=uv, obs_valid=valid,
        descriptors=None if descriptor_seed is None else np.random.default_rng(
            descriptor_seed).integers(0, 2 ** 32, size=(len(pts), 8), dtype=np.uint32),
    )


def render_blobs(uvs, height: int = 640, width: int = 640,
                 sigma: float = 1.8, amplitude: float = 200.0,
                 background: float = 12.0, ring_ids=None) -> np.ndarray:
    """Render a grayscale image with a sub-pixel-accurate Gaussian blob at
    each (u, v) in ``uvs`` — the synthetic-image primitive behind
    render_image, also used directly by stereo/flow tests.

    ring_ids (optional, len(uvs)): per-blob landmark ids.  When given,
    each blob additionally carries a WEAK, WIDE radial-sinusoid
    fingerprint whose frequency/phase are seeded by the id — distinctive
    appearance for descriptor matching (real loop closing needs
    tell-apart-able texture; identical Gaussians defeat any descriptor).
    The fingerprint is a function of |pixel − center| only (invariant to
    in-plane viewpoint rotation), its rings are edge-like (low Shi-Tomasi
    response, so the detector still locks onto the sharp center peak),
    and it translates rigidly with the center, keeping the tracked corner
    a geometrically consistent projection."""
    img = np.full((height, width), background, np.float32)
    ring_sigma = 5.0
    r = int(np.ceil(3 * (max(sigma, ring_sigma) if ring_ids is not None
                         else sigma)))
    uvs = np.asarray(uvs, np.float64)
    for n, (u, v) in enumerate(uvs):
        x0 = int(np.floor(u)) - r
        y0 = int(np.floor(v)) - r
        xs = np.arange(x0, x0 + 2 * r + 1)
        ys = np.arange(y0, y0 + 2 * r + 1)
        gx = np.exp(-((xs - u) ** 2) / (2 * sigma * sigma))
        gy = np.exp(-((ys - v) ** 2) / (2 * sigma * sigma))
        patch = amplitude * gy[:, None] * gx[None, :]
        if ring_ids is not None:
            rng = np.random.default_rng(99000 + int(ring_ids[n]))
            om = rng.uniform(0.7, 2.3)
            ph = rng.uniform(0.0, 2.0 * np.pi)
            rr = np.hypot((xs - u)[None, :], (ys - v)[:, None])
            env = np.exp(-rr * rr / (2.0 * ring_sigma * ring_sigma))
            # inner cutoff: the fingerprint vanishes within ~3 px so the
            # sharp center peak stays the unique Shi-Tomasi maximum (a
            # ring crest at r≈1-2 px would pull the detected corner off
            # the true projection)
            inner = 1.0 - np.exp(-rr * rr / (2.0 * 4.0 * 4.0))
            patch = patch + 0.15 * amplitude * env * inner * np.sin(om * rr + ph)
        xa, xb = max(x0, 0), min(x0 + 2 * r + 1, width)
        ya, yb = max(y0, 0), min(y0 + 2 * r + 1, height)
        if xa < xb and ya < yb:
            img[ya:yb, xa:xb] += patch[ya - y0:yb - y0, xa - x0:xb - x0]
    return np.clip(img, 0.0, 255.0)


def render_image(data: SimData, k: int, height: int = 640, width: int = 640,
                 sigma: float = 1.8, amplitude: float = 200.0,
                 background: float = 12.0, rings: bool = False) -> np.ndarray:
    """Render frame k of a SimData sequence: one blob per visible landmark
    (the simulator writes feature files, not images — this renderer closes
    the loop so the KLT frontend can be exercised against exact geometry;
    blob centers ARE the projections).  ``rings=True`` adds the
    per-landmark ring fingerprints (render_blobs ring_ids) that give each
    blob distinctive appearance for descriptor-based loop closing."""
    vis = np.where(data.obs_valid[k])[0]
    uvs = data.obs_uv[k][vis]
    return render_blobs(uvs, height, width, sigma, amplitude, background,
                        ring_ids=vis if rings else None)
