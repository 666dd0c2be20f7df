"""Structure-from-motion bootstrap: DLT triangulation, GN PnP, RANSAC
relative pose, and incremental global SfM over the init window.

Port of ``vio_tpu/init/sfm.py`` (reference: vins-mono/src/initial/
initial_sfm.cpp:5-313 GlobalSFM, initial/solve_5pts.cpp:5-230
MotionEstimator, 05-frontend-feature-matching/03-pnp/GN-BA.cpp:64-157).
The geometry functions are batched over leading dimensions in place of
``vmap``; RANSAC is one batched hypothesis sweep (``ops/ransac.py``: a
CUDA kernel on the card) whose samples come from a seeded
``torch.Generator`` on the host (so its bits differ from ``jax.random``'s;
the consensus refit makes E independent of the draw on clean data).

Camera-pose convention throughout: (R, t) = world→camera, x_cam = R X + t.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import ransac
from ..utils import lie
from ..solver import generic


# ---------------------------------------------------------------------------
# Multi-view DLT triangulation (initial_sfm.cpp:5-19, feature_manager.cpp:243)
# ---------------------------------------------------------------------------

def triangulate_dlt(Rs, ts, obs, mask):
    """Triangulate points from K masked views, batched over obs's leading
    dims.

    Rs (K,3,3), ts (K,3): world→camera.  obs (..., K, 2) normalized
    coords; mask (..., K) which views observe the point.  Returns
    (X (..., 3), sv_ratio (...)) where sv_ratio = sigma3/sigma4 — the
    triangulation quality measure of the reference
    (16-visual-frontend/src/triangulate.cpp:111-178)."""
    P = torch.cat([Rs, ts[..., None]], dim=-1)                 # (K, 3, 4)
    m = mask[..., None].to(Rs.dtype)
    rows = torch.cat([
        (obs[..., 0:1] * P[:, 2] - P[:, 0]) * m,                # (..., K, 4)
        (obs[..., 1:2] * P[:, 2] - P[:, 1]) * m,
    ], dim=-2)                                                  # (..., 2K, 4)
    _, s, Vt = torch.linalg.svd(rows, full_matrices=False)
    X_h = Vt[..., -1, :]
    X = X_h[..., :3] / X_h[..., 3:4]
    sv_ratio = s[..., 2] / torch.clamp(s[..., 3], min=1e-30)
    return X, sv_ratio


def triangulate_two_frames(R0, t0, R1, t1, xy0, xy1):
    """Two-view DLT (initial_sfm.cpp:74-110), batched over points:
    xy0/xy1 (..., 2) → X (..., 3)."""
    Rs = torch.stack([R0, R1])
    ts = torch.stack([t0, t1])
    obs = torch.stack([xy0, xy1], dim=-2)
    mask = torch.ones(obs.shape[:-1], dtype=torch.bool, device=obs.device)
    X, _ = triangulate_dlt(Rs, ts, obs, mask)
    return X


# ---------------------------------------------------------------------------
# PnP (solveFrameByPnP, initial_sfm.cpp:22-72; GN math per the 05-pnp
# reference)
# ---------------------------------------------------------------------------

def pnp_dlt(X, obs, mask):
    """Linear PnP (direct linear transform): world→camera (R, t) from ≥6
    correspondences, no initial guess needed — the initializer for pnp_gn
    when no trustworthy pose guess exists.  X (N,3) world points, obs
    (N,2) normalized coords, mask (N,)."""
    n = X.shape[0]
    w = mask.to(X.dtype)[:, None]
    Xh = torch.cat([X, torch.ones((n, 1), dtype=X.dtype, device=X.device)], dim=1)
    z4 = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z4, -obs[:, 0:1] * Xh], dim=1)         # (N,12)
    r2 = torch.cat([z4, Xh, -obs[:, 1:2] * Xh], dim=1)
    A = torch.cat([r1 * w, r2 * w], dim=0)                     # (2N,12)
    _, _, Vt = torch.linalg.svd(A, full_matrices=False)
    P = Vt[-1].reshape(3, 4)
    # cheirality: majority of masked depths positive
    depth = X @ P[:, :3].T + P[:, 3]
    votes = torch.sum(torch.where(mask, torch.sign(depth[:, 2]),
                                  torch.zeros_like(depth[:, 2])))
    P = torch.where(votes < 0, -P, P)
    U, S, Vt2 = torch.linalg.svd(P[:, :3])
    R = U @ Vt2
    R = torch.where(torch.linalg.det(R) < 0, -R, R)
    t = P[:, 3] / torch.clamp(torch.mean(S), min=1e-12)
    return R, t


def pnp_gn(X, obs, mask, R0, t0, iters: int = 10):
    """Minimize sum ||proj(R X + t) - obs||² over (R, t) world→camera.

    X (N,3) world points, obs (N,2) normalized coords, mask (N,) validity.
    (R0, t0) initial guess.  Left-multiplicative update R ← exp(dθ)·R.
    Returns (R, t, mean_sq_err)."""
    w = mask.to(X.dtype)
    n = X.shape[0]
    kw = dict(dtype=X.dtype, device=X.device)
    eye3 = torch.eye(3, **kw).expand(n, 3, 3)
    R, t = R0, t0
    for _ in range(iters):
        pc = X @ R.T + t                                        # (N, 3)
        z = torch.clamp(pc[:, 2], min=1e-6)
        r = (pc[:, :2] / z[:, None] - obs) * w[:, None]         # (N, 2)
        # d(proj)/d(pc) (2x3) chain with d(pc)/d[dt,dθ] = [I, -hat(pc)]
        inv_z = 1.0 / z
        J_proj = torch.zeros((n, 2, 3), **kw)
        J_proj[:, 0, 0] = inv_z
        J_proj[:, 1, 1] = inv_z
        J_proj[:, 0, 2] = -pc[:, 0] * inv_z * inv_z
        J_proj[:, 1, 2] = -pc[:, 1] * inv_z * inv_z
        J_pt = torch.cat([eye3, -lie.so3_hat(pc)], dim=-1)      # (N, 3, 6)
        J = (J_proj @ J_pt) * w[:, None, None]
        H = torch.einsum("nip,niq->pq", J, J) + 1e-9 * torch.eye(6, **kw)
        b = -torch.einsum("nip,ni->p", J, r)
        dx = torch.linalg.solve_ex(H, b)[0]   # non-finite, not raising, if singular
        R = lie.so3_exp_mat(dx[3:6]) @ R
        t = t + dx[0:3]
    pc = X @ R.T + t
    r = pc[:, :2] / torch.clamp(pc[:, 2:3], min=1e-6) - obs
    msq = torch.sum(torch.sum(r * r, -1) * w) / torch.clamp(torch.sum(w), min=1.0)
    return R, t, msq


# ---------------------------------------------------------------------------
# Essential matrix: batched 8-point RANSAC + cheirality decomposition
# (solve_5pts.cpp:5-230)
# ---------------------------------------------------------------------------

def ransac_samples(valid, n_hyp: int, generator: torch.Generator) -> torch.Tensor:
    """The minimal samples of a RANSAC round: (n_hyp, 8) int64 row indices
    on the CPU, each drawn without replacement from the rows that the host
    mask ``valid`` (N,) marks (the others weigh 1e-9), by ``generator`` (a
    CPU generator).

    The draw runs on one intra-op thread (the setting is the calling
    thread's).  Its bits do not depend on the thread count, and its
    parallel exponential draw contends with the BLAS threads that the
    estimator's host work leaves spinning: on an 8-core host it took tens
    of milliseconds inside the image path, against ~2 ms on one thread
    (scripts/torch_frontend_profile.py measures both)."""
    p = torch.as_tensor(np.asarray(valid), dtype=torch.float64) + 1e-9
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return torch.multinomial(p.expand(n_hyp, p.shape[0]), 8, replacement=False,
                                 generator=generator)
    finally:
        torch.set_num_threads(threads)


def essential_ransac_from_samples(x0, x1, valid, idx, thresh=0.3 / 460.0):
    """RANSAC E over masked correspondences from the samples idx (n_hyp,
    8) on x0's device; returns (E, inlier_mask, count), all on the device,
    with no host read (so it can be captured into a CUDA graph).

    Two calls of ``ops.ransac`` (kernels on the card, their plain versions
    on the CPU): the hypothesis sweep, then the refit on the consensus set
    of the first hypothesis with the most inliers (``refit_best``, the
    choice included)."""
    Es, scores = ransac.sweep(x0, x1, valid, idx, thresh)
    return ransac.refit_best(x0, x1, valid, Es, scores, thresh)


def essential_ransac(x0, x1, valid, generator: torch.Generator,
                     thresh=0.3 / 460.0, n_hyp: int = 256, host_valid=None):
    """RANSAC E over masked correspondences; returns (E, inlier_mask, count).

    x0/x1 (N,2) normalized coords in the two frames (x1 in the second),
    valid (N,) which rows are real.  Minimal 8-point samples are drawn
    without replacement from the valid rows by ``generator`` (a CPU
    generator), weighted by the caller's host copy of the mask,
    ``host_valid``, where it has one (else ``valid`` is read back).
    thresh follows the reference's cv::findFundamentalMat(..., 0.3 / 460,
    0.99) (solve_5pts.cpp:199).  Rows outside ``valid`` are zeroed first:
    the tracker passes the lifts of failed tracks, which can be NaN, and
    NaN·0 would reach every hypothesis's SVD, which torch refuses (in
    vio_tpu it turns every hypothesis to NaN, so that frame keeps its
    outliers)."""
    if host_valid is None:
        host_valid = valid.cpu().numpy()
    idx = ransac_samples(host_valid, n_hyp, generator).to(x0.device)
    return essential_ransac_from_samples(x0, x1, valid, idx, thresh)


def recover_pose(E, x0, x1, mask):
    """Decompose E into (R, t) with x1 = R x0 + t via the 4-way cheirality
    vote (solve_5pts.cpp:5-80): triangulate under each candidate, count
    points with positive depth in both views."""
    U, _, Vt = torch.linalg.svd(E)
    # keep proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    kw = dict(dtype=E.dtype, device=E.device)
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], **kw)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    t = U[:, 2]
    I3 = torch.eye(3, **kw)
    z3 = torch.zeros(3, **kw)

    cands_R = torch.stack([R1, R1, R2, R2])
    cands_t = torch.stack([t, -t, t, -t])
    votes = []
    for R, tt in zip(cands_R, cands_t):
        X = triangulate_two_frames(I3, z3, R, tt, x0, x1)
        z0 = X[:, 2]
        z1 = (X @ R.T + tt)[:, 2]
        votes.append(torch.sum((z0 > 0) & (z1 > 0) & mask))
    votes = torch.stack(votes)
    k = torch.argmax(votes)
    return cands_R[k], cands_t[k], votes[k]


def relative_rotation(x0, x1, seed=0, thresh=0.3 / 460.0,
                      *, device, dtype):
    """Relative camera rotation R with x_0 ≈ R x_1 from ≥9 normalized
    correspondences — the extrinsic calibrator's per-pair input
    (solveRelativeR, initial_ex_rotation.cpp:68-110).  No inlier/parallax
    gate.  Returns None only when the solve is degenerate."""
    x0 = np.asarray(x0)
    x1 = np.asarray(x1)
    if len(x0) < 9:
        return None
    gen = torch.Generator().manual_seed(seed)
    x0t = torch.as_tensor(x0, dtype=dtype, device=device)
    x1t = torch.as_tensor(x1, dtype=dtype, device=device)
    valid = torch.ones(len(x0), dtype=torch.bool, device=device)
    E, inl, _ = essential_ransac(x0t, x1t, valid, gen, thresh,
                                 host_valid=np.ones(len(x0), bool))
    if not bool(torch.all(torch.isfinite(E))):
        return None
    R, _, _ = recover_pose(E, x0t, x1t, inl)
    R = R.cpu().numpy().astype(np.float64)
    if not np.all(np.isfinite(R)):
        return None
    # recover_pose returns R with x1 = R x0 + t; the calibrator wants the
    # rotation of frame 1 expressed in frame 0 (x_0 = R_rel x_1)
    return R.T


def solve_relative_rt(x0, x1, valid, seed=0, thresh=0.3 / 460.0,
                      *, device, dtype):
    """Full relative-pose solve (solveRelativeRT, solve_5pts.cpp:193-230).

    Returns (ok, R_01, t_01) where (R_01, t_01) is the pose of camera 1
    expressed in camera 0's frame (x_0 = R_01 x_1 + t_01), matching the
    reference's `Rotation = R.transpose(); Translation = -R.T @ t`."""
    valid = np.asarray(valid)
    if int(np.sum(valid)) < 15:
        return False, None, None
    gen = torch.Generator().manual_seed(seed)
    x0t = torch.as_tensor(np.asarray(x0), dtype=dtype, device=device)
    x1t = torch.as_tensor(np.asarray(x1), dtype=dtype, device=device)
    E, inl, _ = essential_ransac(x0t, x1t, torch.as_tensor(valid, device=device),
                                 gen, thresh, host_valid=valid)
    R, t, votes = recover_pose(E, x0t, x1t, inl)
    if int(votes) > 12:
        R = R.cpu().numpy().astype(np.float64)
        t = t.cpu().numpy().astype(np.float64)
        return True, R.T, -R.T @ t
    return False, None, None


# ---------------------------------------------------------------------------
# Global SfM over the window (GlobalSFM::construct, initial_sfm.cpp:117-313)
# ---------------------------------------------------------------------------

def construct(obs, valid, l, R_init, t_init, seed=0,
              *, device, dtype):
    """Incremental SfM over K frames.

    obs (K, F, 2) normalized observations, valid (K, F) mask, l = anchor
    frame (world = camera l), (R_init, t_init) = pose of frame K-1 in frame
    l's coordinates (x_l = R_init x_{K-1} + t_init).  The geometry runs on
    ``device`` in ``dtype``; the orchestration on the host.

    Returns (ok, Rs (K,3,3) world→camera, ts (K,3), X (F,3), tri_mask (F,)).
    """
    obs = np.asarray(obs)
    valid = np.asarray(valid)
    K, F, _ = obs.shape
    dev = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    host = lambda t: t.cpu().numpy().astype(np.float64)                         # noqa: E731
    Rs = np.zeros((K, 3, 3))
    ts = np.zeros((K, 3))
    have_pose = np.zeros(K, bool)
    Rs[l] = np.eye(3)
    have_pose[l] = True
    # world→camera of the newest frame
    Rs[K - 1] = R_init.T
    ts[K - 1] = -R_init.T @ t_init
    have_pose[K - 1] = True

    X = np.zeros((F, 3))
    tri = np.zeros(F, bool)

    def tri_pair(i, j):
        """Triangulate all shared, untriangulated features of frames i, j."""
        sel = valid[i] & valid[j] & ~tri
        if not sel.any():
            return
        X[sel] = host(triangulate_two_frames(
            dev(Rs[i]), dev(ts[i]), dev(Rs[j]), dev(ts[j]),
            dev(obs[i][sel]), dev(obs[j][sel])))
        tri[sel] = True

    def pnp(i, R0, t0):
        sel = valid[i] & tri
        if sel.sum() < 6:
            return False
        R, t, msq = pnp_gn(dev(X[sel]), dev(obs[i][sel]),
                           torch.ones(int(sel.sum()), dtype=torch.bool, device=device),
                           dev(R0), dev(t0))
        if not np.isfinite(float(msq)):
            return False
        Rs[i] = host(R)
        ts[i] = host(t)
        have_pose[i] = True
        return True

    # 1) l ↔ newest bootstrap, then march l+1..K-2 with PnP + triangulation
    tri_pair(l, K - 1)
    for i in range(l + 1, K - 1):
        if not pnp(i, Rs[i - 1], ts[i - 1]):
            return False, None, None, None, None
        tri_pair(i, K - 1)
    # 2) fill in triangulations against the anchor
    for i in range(l + 1, K - 1):
        tri_pair(l, i)
    # 3) march l-1..0 backwards
    for i in range(l - 1, -1, -1):
        if not pnp(i, Rs[i + 1], ts[i + 1]):
            return False, None, None, None, None
        tri_pair(i, l)
    # 4) whatever is left: first/last observing frame pair
    for f_id in np.where(~tri & (valid.sum(0) >= 2))[0]:
        frames = np.where(valid[:, f_id] & have_pose)[0]
        if len(frames) < 2:
            continue
        i, j = frames[0], frames[-1]
        X[f_id] = host(triangulate_two_frames(
            dev(Rs[i]), dev(ts[i]), dev(Rs[j]), dev(ts[j]),
            dev(obs[i, f_id]), dev(obs[j, f_id])))
        tri[f_id] = True

    if tri.sum() < 10:
        return False, None, None, None, None

    # 5) full-window BA on the generic LM solver (replaces the reference's
    #    only in-path Ceres solve, initial_sfm.cpp:254-302). Gauge: pose l
    #    fixed, translation of frame K-1 fixed (scale).
    Rs, ts, X = _sfm_ba(obs, valid & tri[None, :], l, Rs, ts, X, tri,
                        device=device, dtype=dtype)
    return True, Rs, ts, X, tri


def _sfm_ba(obs, use, l, Rs, ts, X, tri, *, device, dtype):
    """Windowed BA: quaternion poses + XYZ points, dense LM.  The Jacobian
    is forward-mode autodiff (``torch.func.jacfwd``), as the JAX package
    uses ``jax.jacfwd``."""
    K, F, _ = obs.shape
    fidx = np.where(tri)[0]
    nf = len(fidx)
    kw = dict(dtype=dtype, device=device)
    q0 = lie.mat_to_quat(torch.as_tensor(Rs, **kw))            # (K, 4)
    obs_j = torch.as_tensor(obs[:, fidx], **kw)                # (K, nf, 2)
    use_j = torch.as_tensor(use[:, fidx], **kw)                # (K, nf)
    last = K - 1

    # params: [dθ,dt per frame (6K), X (3nf)]; pose l and t_last fixed by
    # zeroing their update columns inside residual evaluation
    x0 = torch.cat([torch.zeros(6 * K, **kw),
                    torch.as_tensor(X[fidx], **kw).reshape(-1)])
    ts0 = torch.as_tensor(ts, **kw)
    free_rot = torch.as_tensor([float(k != l) for k in range(K)], **kw)
    free_t = torch.as_tensor([float(k != l and k != last) for k in range(K)], **kw)

    def residuals(x):
        dpose = x[:6 * K].reshape(K, 6)
        pts = x[6 * K:].reshape(nf, 3)
        dth = dpose[:, 0:3] * free_rot[:, None]
        dt = dpose[:, 3:6] * free_t[:, None]
        q = lie.quat_mul(q0, lie.so3_exp_quat(dth))
        t = ts0 + dt
        pc = lie.quat_rotate(q[:, None, :], pts[None]) + t[:, None, :]  # (K,nf,3)
        z = torch.clamp(pc[..., 2], min=1e-6)
        r = (pc[..., :2] / z[..., None] - obs_j) * use_j[..., None]
        return r.reshape(-1)

    def normal_fn(x):
        r = residuals(x)
        J = torch.func.jacfwd(residuals)(x)
        return J.T @ J, -J.T @ r, 0.5 * torch.sum(r * r)

    def chi2_fn(x):
        r = residuals(x)
        return 0.5 * torch.sum(r * r)

    x, _ = generic.lm_solve_dense(normal_fn, chi2_fn,
                                  lambda a, d: a + d.to(a), x0, max_iter=25)
    x = x.cpu().numpy().astype(np.float64)
    dpose = x[:6 * K].reshape(K, 6)
    pts = x[6 * K:].reshape(nf, 3)
    Rs_out = Rs.copy()
    ts_out = ts.copy()
    fr = free_rot.cpu().numpy()
    ft = free_t.cpu().numpy()
    for k in range(K):
        dth = torch.as_tensor(dpose[k, 0:3] * fr[k], **kw)
        Rs_out[k] = Rs[k] @ lie.so3_exp_mat(dth).cpu().numpy().astype(np.float64)
        ts_out[k] = ts[k] + dpose[k, 3:6] * ft[k]
    X_out = X.copy()
    X_out[fidx] = pts
    return Rs_out, ts_out, X_out
