"""Self-contained problem builders for the scale-out solvers, compile
checks and the sharding tests.

Port of ``vio_tpu/testing.py``.  The geometry is drawn on the host with
numpy from the same ``default_rng`` streams as the JAX package, so that,
given the same arguments, both packages build the same problem to
round-off; the rotations go through the port's ``utils/lie``.  The
builders are entry points: without ``device`` the problem lands on the
card (``device.resolve``).  ``write_hybrid_streams`` writes the raw IMU
and camera-stamp files the hybrid dataset reads, from a simulator run.
"""
from __future__ import annotations

import numpy as np
import torch

from . import factors, imu, sim
from .device import resolve
from .parallel import global_ba
from .solver import window as W
from .utils import lie

R_BC = np.array([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
T_BC = np.array([0.05, 0.04, 0.03])

_HOST = dict(dtype=torch.float64, device="cpu")


def make_window_problem(window_size: int = 10, max_features: int = 128,
                        imu_per_interval: int = 8, dtype=None,
                        perturb: float = 0.01, seed: int = 0,
                        cam_dt: float = 1.0 / 30.0, device=None):
    """Returns (states, window_factors, gt_states) for a W-keyframe
    window on the simulator trajectory."""
    device, dtype = resolve(device, dtype)
    kw = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    W1 = window_size + 1
    cam_t = np.arange(W1) * cam_dt
    imu_hz = imu_per_interval / cam_dt
    imu_dt = 1.0 / imu_hz

    m = sim.motion_model(cam_t)
    p_wb, R_wb, v_wb = m["p_wb"], m["R_wb"], m["v_wb"]

    # landmarks: simulator house scene, keep those visible in all frames
    pts = sim.house_landmarks()
    R_wc = R_wb @ R_BC
    p_wc = p_wb + np.einsum("kij,j->ki", R_wb, T_BC)
    pc = np.einsum("kji,klj->kli", R_wc, pts[None] - p_wc[:, None])
    z = pc[..., 2]
    vis = (z > 0.3).all(axis=0)
    pts = pts[vis][:max_features]
    pc = pc[:, vis][:, :max_features]
    F_act = pts.shape[0]
    xy = pc[..., :2] / pc[..., 2:3]

    # preintegrate every interval from the true IMU closed form, all W
    # intervals in one batched call (the JAX package loops over them)
    t_grid = cam_t[:window_size, None] + np.arange(imu_per_interval + 1) * imu_dt
    mk = sim.motion_model(t_grid.reshape(-1))
    acc = mk["acc_b"].reshape(window_size, imu_per_interval + 1, 3)
    gyr = mk["gyr_b"].reshape(window_size, imu_per_interval + 1, 3)
    nd = imu.noise_diag(0.019, 0.015, 1e-4, 1e-5, **kw)
    zeros3 = torch.zeros((window_size, 3), **kw)
    st = imu.preintegrate(
        torch.full((window_size, imu_per_interval), imu_dt, **kw),
        torch.as_tensor(acc[:, 1:], **kw), torch.as_tensor(gyr[:, 1:], **kw),
        torch.ones((window_size, imu_per_interval), dtype=torch.bool, device=device),
        torch.as_tensor(acc[:, 0], **kw), torch.as_tensor(gyr[:, 0], **kw),
        zeros3, zeros3, nd)
    terms = factors.ImuFactorTerms.from_state(st)

    # pack the reprojection grid: all features hosted by frame 0
    F = max_features
    pts_i = np.zeros((F, 3))
    pts_i[:, 2] = 1.0
    pts_j = np.zeros((F, W1, 3))
    pts_j[:, :, 2] = 1.0
    obs_mask = np.zeros((F, W1), dtype=bool)
    feat_valid = np.zeros(F, dtype=bool)
    inv_dep_gt = np.ones(F)   # padded slots: 1.0, never 0 (1/0 → NaN Hessian)
    pts_i[:F_act, :2] = xy[0]
    inv_dep_gt[:F_act] = 1.0 / pc[0, :, 2]
    feat_valid[:F_act] = True
    pts_j[:F_act, 1:, :2] = xy[1:].transpose(1, 0, 2)
    obs_mask[:F_act, 1:] = True

    P = W.num_pose_params(window_size)
    Qs_gt = lie.mat_to_quat(torch.as_tensor(R_wb, **_HOST)).numpy()

    def mk_states(Ps, Qs, Vs, Bas, Bgs, inv_dep):
        t = lambda a: torch.as_tensor(np.asarray(a), **kw)  # noqa: E731
        return W.WindowStates(
            ext_t=t(T_BC), ext_q=lie.mat_to_quat(t(R_BC)),
            Ps=t(Ps), Qs=t(Qs), Vs=t(Vs), Bas=t(Bas), Bgs=t(Bgs),
            inv_dep=t(inv_dep))

    gt_states = mk_states(p_wb, Qs_gt, v_wb, np.zeros((W1, 3)),
                          np.zeros((W1, 3)), inv_dep_gt)

    # perturbed initial guess (first pose fixed = gauge anchor by prior-free LM)
    dP = perturb * rng.standard_normal((W1, 3))
    dth = perturb * rng.standard_normal((W1, 3))
    dP[0] = 0
    dth[0] = 0
    Qs0 = lie.quat_mul(torch.as_tensor(Qs_gt, **_HOST),
                       lie.so3_exp_quat(torch.as_tensor(dth, **_HOST))).numpy()
    states = mk_states(
        p_wb + dP, Qs0, v_wb + perturb * rng.standard_normal((W1, 3)),
        np.zeros((W1, 3)), np.zeros((W1, 3)),
        inv_dep_gt * (1.0 + perturb * rng.standard_normal(F)))

    wf = W.WindowFactors(
        imu_terms=terms,
        imu_valid=torch.ones(window_size, dtype=torch.bool, device=device),
        pts_i=torch.as_tensor(pts_i, **kw), pts_j=torch.as_tensor(pts_j, **kw),
        start=torch.zeros(F, dtype=torch.int64, device=device),
        obs_mask=torch.as_tensor(obs_mask, device=device),
        feat_valid=torch.as_tensor(feat_valid, device=device),
        H_prior=torch.zeros((P, P), **kw), b_prior=torch.zeros(P, **kw),
        err_prior=torch.zeros(P, **kw), Jt_prior_inv=torch.zeros((P, P), **kw),
        g=torch.tensor([0.0, 0.0, 9.81], **kw),
        proj_sqrt_info=torch.tensor(460.0 / 1.5, **kw))
    return states, wf, gt_states


# ---------------------------------------------------------------------------
# Global (large-window) BA problems — shared by the global-BA tests, the
# distributed tests and chip_smoke.py
# ---------------------------------------------------------------------------

def make_global_problem(N: int = 12, M: int = 120, obs_per_lm: int = 6,
                        seed: int = 0, dtype=None, pad_obs_to: int = 8,
                        device=None):
    """Keyframes on an arc around a landmark cloud; every landmark observed
    in its host frame + obs_per_lm later frames.  Returns (GlobalBA, pts)
    with pts the (M, 3) ground-truth landmarks as host numpy."""
    device, dtype = resolve(device, dtype)
    rng = np.random.default_rng(seed)
    k = np.arange(N)
    ang = 1.4 * k / N          # ~1.4 rad total arc regardless of N
    Ps = np.stack([4.0 * np.sin(ang), 4.0 - 4.0 * np.cos(ang),
                   0.3 * np.sin(0.5 * k)], axis=1)
    phi = np.stack([0.02 * np.sin(k), 0.02 * np.cos(k), ang], axis=1)
    Qs_t = lie.so3_exp_quat(torch.as_tensor(phi, **_HOST))
    Qs = Qs_t.numpy()

    # cameras look along +z; the landmark cloud sits in front at z ∈ [6, 14]
    pts = np.stack([rng.uniform(-3, 9, M), rng.uniform(-2, 6, M),
                    rng.uniform(6, 14, M)], axis=1)

    host = (np.arange(M) % (N - obs_per_lm)).astype(np.int64)
    Rs = lie.quat_to_mat(Qs_t).numpy()
    Xc_all = np.einsum("kji,kmj->kmi", Rs,
                       pts[None, :, :] - Ps[:, None, :])      # (N, M, 3)
    good = ((Xc_all[..., 2] > 1.0) &
            (np.abs(Xc_all[..., 0] / Xc_all[..., 2]) <= 2) &
            (np.abs(Xc_all[..., 1] / Xc_all[..., 2]) <= 2))    # (N, M)

    lm_valid = good[host, np.arange(M)]
    Xh = Xc_all[host, np.arange(M)]                            # (M, 3)
    inv_dep = np.where(lm_valid, 1.0 / np.maximum(Xh[:, 2], 1e-6), 1.0)
    bearing0 = np.where(lm_valid[:, None],
                        Xh / np.maximum(Xh[:, 2:3], 1e-6),
                        np.array([0.0, 0.0, 1.0]))

    offs = np.arange(1, obs_per_lm + 1)
    fr = host[None, :] + offs[:, None]                         # (K, M)
    ok = (fr < N) & lm_valid[None, :] & good[np.minimum(fr, N - 1),
                                             np.arange(M)[None, :]]
    ks, ms = np.nonzero(ok)
    frame = fr[ks, ms]
    lm_idx = ms
    Xj = Xc_all[frame, ms]
    bearing = Xj / Xj[:, 2:3]

    O = len(lm_idx)
    pad = (-O) % pad_obs_to
    lm_idx = np.concatenate([lm_idx, np.zeros(pad, np.int64)])
    frame = np.concatenate([frame, np.full(pad, host[0])])   # host == frame → masked out
    bearing = np.concatenate([bearing, np.repeat(bearing[:1], pad, axis=0)])
    valid = np.arange(O + pad) < O

    kw = dict(dtype=dtype, device=device)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
    p = global_ba.GlobalBA(
        Ps=torch.as_tensor(Ps, **kw), Qs=torch.as_tensor(Qs, **kw),
        inv_dep=torch.as_tensor(inv_dep, **kw), host=idx(host),
        bearing0=torch.as_tensor(bearing0, **kw),
        lm_valid=torch.as_tensor(lm_valid, device=device),
        lm_idx=idx(lm_idx), frame=idx(frame),
        bearing=torch.as_tensor(bearing, **kw),
        valid=torch.as_tensor(valid, device=device),
        sqrt_info=torch.tensor(460.0 / 1.5, **kw))
    return p, pts


def perturb_global(p, seed=1, pose_sigma=0.03, rot_sigma=0.01,
                   dep_sigma=0.05, fix_frames=2):
    """Perturb a GlobalBA problem away from its ground truth, on its own
    device and in its own dtype."""
    rng = np.random.default_rng(seed)
    N = p.Ps.shape[0]
    kw = dict(dtype=p.Ps.dtype, device=p.Ps.device)
    mask = (np.arange(N) >= fix_frames)[:, None]
    dP = pose_sigma * rng.standard_normal((N, 3)) * mask
    dth = rot_sigma * rng.standard_normal((N, 3)) * mask
    Qs = lie.quat_normalize(lie.quat_mul(
        p.Qs, lie.so3_exp_quat(torch.as_tensor(dth, **kw))))
    rel = 1.0 + dep_sigma * rng.standard_normal(p.inv_dep.shape[0])
    return p._replace(Ps=p.Ps + torch.as_tensor(dP, **kw), Qs=Qs,
                      inv_dep=p.inv_dep * torch.as_tensor(rel, **kw))


def write_hybrid_streams(data, out_dir: str, static_s: float = 2.0,
                         cam_hz: float = 20.0):
    """MH_05_imu0.txt / MH_05_cam0.txt (``io.load_imu_txt``'s and
    ``io.load_cam_stamps_txt``'s formats) in ``out_dir``: ``static_s``
    seconds at rest (gravity's specific force in the body frame, zero
    rates) at the simulator's IMU rate, then the simulator's stream
    ``data`` shifted after it; camera stamps at ``cam_hz`` over both.
    The streams the reference's flagship reads are not in the repository;
    these stand in for them.  Returns the written (t, acc, gyr), t from 0."""
    m0 = sim.motion_model(data.imu_t[:1])
    dt = data.imu_t[1] - data.imu_t[0]
    n0 = int(round(static_s / dt))
    acc0 = -m0["R_wb"][0].T @ sim.GRAVITY_W
    t = np.concatenate([np.arange(n0) * dt, data.imu_t - data.imu_t[0] + n0 * dt])
    acc = np.concatenate([np.tile(acc0, (n0, 1)), data.acc])
    gyr = np.concatenate([np.zeros((n0, 3)), data.gyr])
    ns = np.round((t + 1.0) * 1e9).astype(np.int64)
    with open(f"{out_dir}/MH_05_imu0.txt", "w") as fh:
        for k in range(len(t)):
            fh.write(" ".join([str(ns[k])] + [repr(float(v)) for v in
                                              (*gyr[k], *acc[k])]) + "\n")
    with open(f"{out_dir}/MH_05_cam0.txt", "w") as fh:
        for s in np.round((np.arange(0.0, t[-1], 1.0 / cam_hz) + 1.0) * 1e9).astype(np.int64):
            fh.write(f"{s} {s}.png\n")
    return t, acc, gyr
