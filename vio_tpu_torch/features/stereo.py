"""Stereo disparity and back-projection to point clouds.

Port of ``vio_tpu/features/stereo.py`` (reference: 04-camera-model/
02-stereo-vision/disparity.cpp — per-pixel back-projection Z = fx*b/d;
06-frontend-direct-method/03-disparity-map/disparity_map.cpp:176-236 —
LK disparity validated against GT by Pearson correlation).  The scan over
disparity candidates is one gather of all N·D patch centres; every
function takes its device and dtype from its input tensors.
"""
from __future__ import annotations

import torch

from . import klt, pyramid


def disparity_from_flow(left, right, pts, valid, max_disp: int = 64,
                        n_iters: int = 10, max_residual: float = 25.0):
    """Disparity at sparse points: epipolar scan + LK subpixel refinement.

    pts (N, 2) are (u, v) pixels in the rectified left image.  An
    exhaustive 1-px SAD scan along the scanline over ``max_disp``
    candidates picks the integer disparity (gated by a uniqueness ratio),
    then full-resolution inverse-compositional LK refines it to subpixel
    with the row re-pinned (the epipolar constraint).

    Returns (disp (N,), ok (N,)) with disp = u_left - u_right >= 0.
    """
    N = pts.shape[0]
    dtype = pts.dtype
    T = pyramid.patch_sample(left, pts, klt.HALF)                # (N, P²)
    ds = torch.arange(max_disp, dtype=dtype, device=pts.device)  # (D,)
    cand = pts[:, None, :] - torch.stack(
        [ds, torch.zeros_like(ds)], dim=-1)[None, :, :]          # (N, D, 2)
    patches = pyramid.patch_sample(right, cand.reshape(-1, 2), klt.HALF)
    patches = patches.reshape(N, max_disp, -1)                   # (N, D, P²)
    sad = torch.mean(torch.abs(patches - T[:, None, :]), dim=-1)  # (N, D)
    # penalize candidates whose window leaves the image
    inf = torch.tensor(float("inf"), dtype=sad.dtype, device=sad.device)
    sad = torch.where(cand[..., 0] < 1.0, inf, sad)
    # the first minimum, as jnp.argmin takes it (torch.argmin's choice
    # among ties is unspecified; flat black scanlines tie at 0)
    sad1 = torch.amin(sad, dim=1)
    ramp = torch.arange(max_disp, device=pts.device).expand(N, max_disp)
    best = torch.where(sad == sad1[:, None], ramp, max_disp).amin(dim=1)
    d0 = best.to(dtype)
    # uniqueness-ratio gate (classic stereo BM): the best match must beat
    # the best match outside its ±2 px neighborhood by a clear margin,
    # else the scanline is ambiguous (repeated texture / flat region)
    near = torch.abs(ds[None, :] - d0[:, None]) <= 2.0
    sad2 = torch.amin(torch.where(near, inf, sad), dim=1)
    unique = sad2 > 1.3 * sad1 + 1e-3

    p1_init = pts - torch.stack([d0, torch.zeros_like(d0)], dim=-1)
    p1, good_H, res = klt._track_level(left, right, pts, p1_init, n_iters)
    p1 = torch.stack([p1[:, 0], pts[:, 1]], dim=-1)              # epipolar re-pin
    W = left.shape[1]
    inb = (p1[:, 0] >= 1.0) & (p1[:, 0] < W - 1)
    disp = pts[:, 0] - p1[:, 0]
    ok = valid & good_H & unique & inb & (res < max_residual) & (disp >= 0.0)
    return disp, ok


def disparity_to_pointcloud(disp, K, baseline, min_disp: float = 0.5):
    """Back-project a dense disparity image (H, W) to camera-frame points.

    Returns (points (H, W, 3), valid (H, W)).  fx/fy/cx/cy from K (3, 3);
    Z = fx * baseline / disparity."""
    H, W = disp.shape
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    u = torch.arange(W, dtype=disp.dtype, device=disp.device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=disp.dtype, device=disp.device)[:, None].expand(H, W)
    valid = disp > min_disp
    d = torch.where(valid, disp, torch.ones_like(disp))
    Z = fx * baseline / d
    X = (u - cx) * Z / fx
    Y = (v - cy) * Z / fy
    pts = torch.stack([X, Y, Z], dim=-1)
    return torch.where(valid[..., None], pts, torch.zeros_like(pts)), valid


def points_to_pointcloud(pts_uv, disp, K, baseline, min_disp: float = 0.5):
    """Sparse variant: back-project (N, 2) pixels with disparities (N,)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    valid = disp > min_disp
    d = torch.where(valid, disp, torch.ones_like(disp))
    Z = fx * baseline / d
    X = (pts_uv[:, 0] - cx) * Z / fx
    Y = (pts_uv[:, 1] - cy) * Z / fy
    P = torch.stack([X, Y, Z], dim=-1)
    return torch.where(valid[:, None], P, torch.zeros_like(P)), valid


def pearson(a, b):
    """Pearson correlation — the disparity-vs-GT quality metric of
    disparity_map.cpp:220-236."""
    a = a - torch.mean(a)
    b = b - torch.mean(b)
    den = torch.sqrt(torch.sum(a * a) * torch.sum(b * b))
    return torch.sum(a * b) / torch.clamp(den, min=1e-30)
