"""Chessboard intrinsic calibration: Zhang's method + batched LM refinement.

Port of ``vio_tpu/calib/intrinsics.py``: the corner refinement runs on
the device, the closed-form steps are host numpy copies, and the bundle
refinement's residuals and forward-mode Jacobian run on the device with
the LM loop in the port's ``solver/generic.py``.  From the reference's
camodocal calibration tooling
(reference: src/camera_models/ Chessboard.cc corner pipeline +
CameraCalibration.cc / CostFunctionFactory.cc Ceres refinement — the one
camodocal capability SURVEY §2.1 had scoped out; closed here).  The
capability split is TPU-idiomatic:

  * saddle-point SUB-PIXEL corner refinement runs on device against the
    actual image (the precision-critical image-processing step —
    cv::cornerSubPix analog as one batched quadratic fit);
  * the board's corner LAYOUT is supplied by the caller (a synthetic rig
    or an upstream coarse detector), replacing Chessboard.cc's 2k lines
    of OpenCV-era combinatorial corner ordering;
  * Zhang closed-form initialization (homographies → image of the
    absolute conic → K) and a full bundle refinement of
    [fx fy cx cy k1 k2 p1 p2 + per-view 6-dof pose] run as one jitted
    residual with jacfwd normal equations through the generic LM solver
    (solver/generic.py) — no Ceres.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from ..features.pyramid import bilinear_sample
from ..solver import generic
from ..utils import lie
from ..utils.lie_np import so3_log_np


# ---------------------------------------------------------------------------
# Sub-pixel saddle refinement (cv::cornerSubPix analog)
# ---------------------------------------------------------------------------

def refine_corners_subpix(img, corners, half: int = 4, n_iter: int = 3,
                          device=None):
    """Refine chessboard corner positions to sub-pixel accuracy.

    A chessboard corner is a saddle of intensity: within a window around
    the corner, the gradient at every pixel is orthogonal to the vector
    from the true corner to that pixel (the cornerSubPix normal
    equations).  One batched 2x2 solve per corner per iteration, all
    corners at once.  corners (N, 2) float pixel coords -> refined (N, 2)
    float32 tensor, as the reference (images are float32 everywhere).
    ``device`` is the CUDA device unless the caller passes "cpu"
    (``device.resolve``).
    """
    device, _ = resolve(device)
    img = torch.as_tensor(img, dtype=torch.float32, device=device)
    gx = 0.5 * (torch.roll(img, -1, 1) - torch.roll(img, 1, 1))
    gy = 0.5 * (torch.roll(img, -1, 0) - torch.roll(img, 1, 0))
    d = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(d, d, indexing="ij")
    ox = ox.reshape(-1)
    oy = oy.reshape(-1)
    # Gaussian weighting like OpenCV
    w = torch.exp(-(ox ** 2 + oy ** 2) / (2.0 * (half / 1.5) ** 2))

    def gather(a, x, y):
        return bilinear_sample(a, torch.stack([x, y], dim=-1))

    p = torch.as_tensor(corners, dtype=torch.float32, device=device)
    for _ in range(n_iter):
        px = p[:, 0:1] + ox[None, :]
        py = p[:, 1:2] + oy[None, :]
        Gx = gather(gx, px, py) * w[None, :]
        Gy = gather(gy, px, py) * w[None, :]
        # sum over window of g g^T and g g^T q  (q = sample position)
        a = torch.sum(Gx * Gx, dim=1)
        b = torch.sum(Gx * Gy, dim=1)
        c = torch.sum(Gy * Gy, dim=1)
        bx = torch.sum(Gx * Gx * px + Gx * Gy * py, dim=1)
        by = torch.sum(Gx * Gy * px + Gy * Gy * py, dim=1)
        det = a * c - b * b
        det = torch.where(torch.abs(det) > 1e-9, det, torch.ones_like(det))
        nx = (c * bx - b * by) / det
        ny = (a * by - b * bx) / det
        p = torch.stack([nx, ny], dim=-1)
    return p


# ---------------------------------------------------------------------------
# Zhang closed-form initialization
# ---------------------------------------------------------------------------

def homography_dlt(board_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """Normalized DLT homography board plane -> image (both (N, 2))."""
    def normalize(p):
        c = p.mean(axis=0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        ph = np.concatenate([p, np.ones((len(p), 1))], axis=1)
        return (T @ ph.T).T, T

    src, Ts = normalize(board_xy)
    dst, Td = normalize(img_xy)
    A = []
    for (x, y, _), (u, v, _) in zip(src, dst):
        A.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        A.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    Hn = Vt[-1].reshape(3, 3)
    Hm = np.linalg.inv(Td) @ Hn @ Ts
    return Hm / Hm[2, 2]


def _v_ij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j]])


def zhang_init(Hs: list) -> np.ndarray:
    """Closed-form K = [fx, fy, cx, cy] from >= 3 view homographies via
    the image of the absolute conic (Zhang TPAMI'00 §3.1; the reference's
    CameraCalibration initial-intrinsics step)."""
    V = []
    for H in Hs:
        V.append(_v_ij(H, 0, 1))
        V.append(_v_ij(H, 0, 0) - _v_ij(H, 1, 1))
    _, _, Vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return np.array([fx, fy, cx, cy])


def extrinsics_from_homography(H: np.ndarray, K4: np.ndarray):
    """Per-view board pose (R, t) from H and intrinsics (Zhang §3.1)."""
    fx, fy, cx, cy = K4
    Kinv = np.array([[1 / fx, 0, -cx / fx],
                     [0, 1 / fy, -cy / fy],
                     [0, 0, 1.0]])
    h1, h2, h3 = (Kinv @ H).T
    s = 1.0 / max(np.linalg.norm(h1), 1e-12)
    r1 = s * h1
    r2 = s * h2
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(R)            # project onto SO(3)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1]) @ Vt
    t = s * h3
    if t[2] < 0:                           # board must be in front
        R = R @ np.diag([-1, -1, 1])
        t = -t
    return R, t


# ---------------------------------------------------------------------------
# Full bundle refinement
# ---------------------------------------------------------------------------

def _project(params, poses, board_pts):
    """params (8,) = [fx fy cx cy k1 k2 p1 p2]; poses (V, 6) axis-angle +
    translation; board_pts (N, 3) -> (V, N, 2) pixel projections."""
    fx, fy, cx, cy, k1, k2, p1, p2 = params[:, None, None]
    R = lie.so3_exp_mat(poses[:, :3])                        # (V, 3, 3)
    pc = torch.einsum("vij,nj->vni", R, board_pts) + poses[:, None, 3:6]
    xn = pc[..., 0] / pc[..., 2]
    yn = pc[..., 1] / pc[..., 2]
    r2 = xn * xn + yn * yn
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = xn * rad + 2 * p1 * xn * yn + p2 * (r2 + 2 * xn * xn)
    yd = yn * rad + p1 * (r2 + 2 * yn * yn) + 2 * p2 * xn * yn
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def calibrate_chessboard(board_xy: np.ndarray, img_pts: np.ndarray,
                         max_iter: int = 60, device=None, dtype=None):
    """Full intrinsic calibration from V views of a planar board.

    board_xy (N, 2): board-plane corner coordinates [m];
    img_pts (V, N, 2): detected pixel corners per view.
    The residuals and their forward-mode Jacobian run on ``device`` in
    ``dtype`` (``device.resolve``: the CUDA device and float32 unless the
    caller passes others); the LM loop is host float64.
    Returns dict with fx, fy, cx, cy, k1, k2, p1, p2, reproj_rms_px,
    poses (V, 6).
    """
    device, dtype = resolve(device, dtype)
    board_xy = np.asarray(board_xy, np.float64)
    img_pts = np.asarray(img_pts, np.float64)
    V = img_pts.shape[0]
    Hs = [homography_dlt(board_xy, img_pts[v]) for v in range(V)]
    K4 = zhang_init(Hs)
    poses0 = []
    for v in range(V):
        R, t = extrinsics_from_homography(Hs[v], K4)
        poses0.append(np.concatenate([so3_log_np(R), t]))
    x0 = torch.as_tensor(np.concatenate(
        [K4, np.zeros(4), np.concatenate(poses0)]), dtype=dtype, device=device)

    board3 = torch.as_tensor(np.concatenate(
        [board_xy, np.zeros((len(board_xy), 1))], axis=1), dtype=dtype,
        device=device)
    obs = torch.as_tensor(img_pts, dtype=dtype, device=device)

    def residuals(x):
        params = x[:8]
        poses = x[8:].reshape(V, 6)
        return (_project(params, poses, board3) - obs).reshape(-1)

    def normal_fn(x):
        r = residuals(x)
        J = torch.func.jacfwd(residuals)(x)
        return J.T @ J, -J.T @ r, 0.5 * torch.sum(r * r)

    def chi2_fn(x):
        r = residuals(x)
        return 0.5 * torch.sum(r * r)

    x, stats = generic.lm_solve_dense(normal_fn, chi2_fn,
                                      lambda x, d: x + d.to(x), x0,
                                      max_iter=max_iter)
    rms = float(torch.sqrt(torch.mean(residuals(x) ** 2)))
    x = x.cpu().numpy().astype(np.float64)
    return dict(fx=x[0], fy=x[1], cx=x[2], cy=x[3],
                k1=x[4], k2=x[5], p1=x[6], p2=x[7],
                reproj_rms_px=rms, poses=x[8:].reshape(V, 6),
                chi2=stats["chi2"], init_K=K4)
