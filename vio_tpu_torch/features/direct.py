"""Sparse direct (photometric) pose estimation on an image pyramid, and
photometric bundle adjustment.

Port of ``vio_tpu/features/direct.py`` (reference: 06-frontend-direct-
method/02-direct-method/direct_method.cpp:184-340 DirectPoseEstimation
Single/MultiLayer — photometric Gauss-Newton over 4 pyramid levels with
scale 0.5, 4x4 patches around sparse points with known depth; and
07-backend-optimization/02-direct-ba/direct_ba.cpp:44,124-319).  All
points form one batch; each Gauss-Newton iteration is a bilinear gather
and one 6x6 solve (``torch.linalg.solve``, as ``jnp.linalg.solve`` in the
JAX package); the JAX ``fori_loop`` is a Python loop.

Direct BA solves poses + XYZ landmarks on ``solver/blockba.py``.  Each
observation samples its own camera's image, so the residual is written
batched over observations with one gather from the stacked images, and
its 9 Jacobian columns come from forward mode (``torch.func.jvp``) along
the 9 unit tangents at once: the JAX package's ``vmap(jacfwd)`` of one
observation, without indexing the image stack by a batched camera index.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import move, resolve
from ..solver import blockba
from ..utils import lie
from . import pyramid

HALF_PATCH = 2     # 4x4 patch, as in the reference


def _patch_offsets(dtype, device):
    """(16, 2) patch offsets (dx, dy), dx fastest — jnp.meshgrid's "xy"
    order."""
    d = torch.arange(-HALF_PATCH, HALF_PATCH, dtype=dtype, device=device)
    dx, dy = torch.meshgrid(d, d, indexing="xy")
    return torch.stack([dx, dy], dim=-1).reshape(-1, 2)


def _estimate_level(img1, img2, pts_ref, depth_ref, K, R0, t0, iters: int):
    """One pyramid level of photometric GN.

    pts_ref (N,2) pixel positions in img1, depth_ref (N,) depths,
    K = (fx, fy, cx, cy).  Estimates (R, t): X_2 = R X_1 + t."""
    fx, fy, cx, cy = K
    offs = _patch_offsets(img1.dtype, img1.device)
    X = torch.stack([(pts_ref[:, 0] - cx) / fx * depth_ref,
                     (pts_ref[:, 1] - cy) / fy * depth_ref,
                     depth_ref], dim=-1)                     # (N, 3)
    I_ref = pyramid.bilinear_sample(img1, pts_ref[:, None, :] + offs[None])  # (N, 16)
    gx2, gy2 = pyramid.central_gradients(img2)
    eye6 = torch.eye(6, dtype=img1.dtype, device=img1.device)

    R, t = R0, t0
    for _ in range(iters):
        Xc = X @ R.T + t                                    # (N, 3)
        z = torch.clamp(Xc[:, 2], min=1e-3)
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
        pos = torch.stack([u, v], dim=-1)[:, None, :] + offs[None]
        valid = ((u > 4) & (u < img2.shape[1] - 4) &
                 (v > 4) & (v < img2.shape[0] - 4) & (Xc[:, 2] > 0.1))
        w = valid.to(img1.dtype)

        I_cur = pyramid.bilinear_sample(img2, pos)
        r = (I_cur - I_ref) * w[:, None]                    # (N, 16)
        gx = pyramid.bilinear_sample(gx2, pos)
        gy = pyramid.bilinear_sample(gy2, pos)

        inv_z = 1.0 / z
        inv_z2 = inv_z * inv_z
        zero = torch.zeros_like(inv_z)
        # d(u,v)/d(dxi) with dxi = [dt(3), dθ(3)], left-perturbation
        Xc0, Xc1 = Xc[:, 0], Xc[:, 1]
        Ju = torch.stack([
            fx * inv_z, zero, -fx * Xc0 * inv_z2,
            -fx * Xc0 * Xc1 * inv_z2, fx + fx * Xc0 * Xc0 * inv_z2,
            -fx * Xc1 * inv_z,
        ], dim=-1)                                          # (N, 6)
        Jv = torch.stack([
            zero, fy * inv_z, -fy * Xc1 * inv_z2,
            -fy - fy * Xc1 * Xc1 * inv_z2, fy * Xc0 * Xc1 * inv_z2,
            fy * Xc0 * inv_z,
        ], dim=-1)
        # J_photometric (N, 16, 6) = grad · J_proj
        J = (gx[..., None] * Ju[:, None, :] +
             gy[..., None] * Jv[:, None, :]) * w[:, None, None]
        H = torch.einsum("npi,npj->ij", J, J) + 1e-6 * eye6
        b = -torch.einsum("npi,np->i", J, r)
        dx = torch.linalg.solve(H, b)
        R, t = lie.so3_exp_mat(dx[3:6]) @ R, t + dx[0:3]
    return R, t


def direct_pose_estimation(img1, img2, pts_ref, depth_ref, K,
                           R0=None, t0=None, levels: int = 4,
                           iters: int = 10, device=None, dtype=None):
    """Multi-layer direct pose estimation (direct_method.cpp:184-214).
    K = (fx, fy, cx, cy).  Images, points and depths (numpy or tensors)
    are taken to ``device`` in ``dtype``: without them, the card in
    float32.  Returns (R, t) with X_2 = R X_1 + t."""
    device, dtype = resolve(device, dtype)
    kw = dict(dtype=dtype, device=device)
    img1, img2, pts_ref, depth_ref = (torch.as_tensor(a, **kw)
                                      for a in (img1, img2, pts_ref, depth_ref))
    R = torch.eye(3, **kw) if R0 is None else torch.as_tensor(R0, **kw)
    t = torch.zeros(3, **kw) if t0 is None else torch.as_tensor(t0, **kw)
    pyr1 = pyramid.build_pyramid(img1, levels)
    pyr2 = pyramid.build_pyramid(img2, levels)
    fx, fy, cx, cy = K
    for lv in range(levels - 1, -1, -1):
        s = 0.5 ** lv
        Ks = (fx * s, fy * s, cx * s, cy * s)
        R, t = _estimate_level(pyr1[lv], pyr2[lv], pts_ref * s, depth_ref,
                               Ks, R, t, iters)
    return R, t


# ---------------------------------------------------------------------------
# Direct (photometric) bundle adjustment: poses + XYZ landmarks
# ---------------------------------------------------------------------------

class DirectBAProblem(NamedTuple):
    images: torch.Tensor     # (C, H, W)
    K: tuple                 # (fx, fy, cx, cy) — static
    cam_q: torch.Tensor      # (C, 4) world->cam quaternion
    cam_t: torch.Tensor      # (C, 3)
    points: torch.Tensor     # (M, 3) world XYZ
    ref_patch: torch.Tensor  # (M, 16) target intensities (from host frame)
    cam_idx: torch.Tensor    # (O,)
    pt_idx: torch.Tensor     # (O,)
    valid: torch.Tensor      # (O,) bool


def _photo_residual(images, ci, K, q, t, X, ref_patch):
    """16-vector photometric residuals of the (camera ci, point X)
    observations, batched: (O, 16) and the in-bounds mask (O,)."""
    fx, fy, cx, cy = K
    H, W = images.shape[-2:]
    offs = _patch_offsets(X.dtype, X.device)
    Xc = lie.quat_rotate(q, X) + t
    z = torch.clamp(Xc[:, 2], min=1e-3)
    u = fx * Xc[:, 0] / z + cx
    v = fy * Xc[:, 1] / z + cy
    pos = torch.stack([u, v], dim=-1)[:, None, :] + offs       # (O, 16, 2)
    I = pyramid.bilinear_sample(images, pos, ci[:, None])       # (O, 16)
    inb = ((u > HALF_PATCH + 1) & (u < W - HALF_PATCH - 2) &
           (v > HALF_PATCH + 1) & (v < H - HALF_PATCH - 2) &
           (Xc[:, 2] > 0.1))
    return torch.where(inb[:, None], I - ref_patch, torch.zeros_like(I)), inb


def _photo_residual_jac(images, ci, K, q, t, X, ref_patch):
    """Residuals (O, 16), their Jacobians (O, 16, 9) wrt [dθ, dt, dX] and
    the in-bounds mask."""
    def h(z):
        dq = lie.so3_exp_quat(z[:, 0:3])
        r, _ = _photo_residual(images, ci, K, lie.quat_mul(q, dq), t + z[:, 3:6],
                               X + z[:, 6:9], ref_patch)
        return r
    O = X.shape[0]
    z0 = torch.zeros((O, 9), dtype=X.dtype, device=X.device)
    tangents = torch.eye(9, dtype=X.dtype, device=X.device)[:, None, :].expand(9, O, 9)
    cols = torch.func.vmap(lambda v: torch.func.jvp(h, (z0,), (v,))[1])(tangents)
    r, inb = _photo_residual(images, ci, K, q, t, X, ref_patch)
    return r, cols.permute(1, 2, 0), inb                        # (O,16,9)


def _direct_assemble(p: DirectBAProblem, C: int, M: int, gauge_fix: int,
                     huber: float):
    dtype = p.points.dtype
    r, J, inb = _photo_residual_jac(p.images, p.cam_idx, p.K, p.cam_q[p.cam_idx],
                                    p.cam_t[p.cam_idx], p.points[p.pt_idx],
                                    p.ref_patch[p.pt_idx])

    free_obs = (p.cam_idx >= gauge_fix).to(dtype)
    J[:, :, 0:6] *= free_obs[:, None, None]

    m = (p.valid & inb).to(dtype)
    e2 = torch.sum(r * r, dim=-1)
    e = torch.sqrt(torch.clamp(e2, min=1e-30))
    w = torch.where(e <= huber, torch.ones_like(e), huber / e) * m
    rho = torch.where(e <= huber, e2, huber * (2.0 * e - huber)) * m

    free_param = (torch.arange(C, device=r.device) >= gauge_fix).to(dtype)
    fixed_diag = (1.0 - free_param)[:, None].repeat(1, 6).reshape(6 * C)
    return blockba.assemble_blocks(r, J[:, :, 0:6], J[:, :, 6:9],
                                   p.cam_idx, p.pt_idx, w, rho, C, M,
                                   fixed_diag=fixed_diag)


def _direct_apply(p: DirectBAProblem, dxc, dxp, gauge_fix: int):
    mask = (torch.arange(p.cam_q.shape[0], device=dxc.device) >= gauge_fix).to(dxc.dtype)
    dxc = dxc * mask[:, None]
    q = lie.quat_normalize(lie.quat_mul(p.cam_q, lie.so3_exp_quat(dxc[:, 0:3])))
    return p._replace(cam_q=q, cam_t=p.cam_t + dxc[:, 3:6],
                      points=p.points + dxp)


def direct_ba(p: DirectBAProblem, max_iter: int = 30, gauge_fix: int = 1,
              huber: float = 40.0, verbose: bool = False, device=None,
              dtype=None):
    """Photometric BA over poses + XYZ points (the reference's direct-BA
    assignment).  The problem is moved to ``device`` and ``dtype`` first
    (without them, the card in float32).  Returns (optimized problem, chi²
    history)."""
    device, dtype = resolve(device, dtype)
    p = move(p, device, dtype)
    C = p.cam_q.shape[0]
    M = p.points.shape[0]
    return blockba.lm_loop(
        p,
        lambda p_: _direct_assemble(p_, C, M, gauge_fix, huber),
        lambda p_, dxc, dxp: _direct_apply(p_, dxc, dxp, gauge_fix),
        C, M, max_iter=max_iter, verbose=verbose)
