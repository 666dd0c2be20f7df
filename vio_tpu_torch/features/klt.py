"""Batched pyramidal inverse-compositional Lucas-Kanade optical flow.

Port of ``vio_tpu/features/klt.py``'s gather path.  Replaces
cv::calcOpticalFlowPyrLK (reference: vins-mono/src/feature_tracker.cpp:113)
with the inverse-compositional formulation the reference derives in its
optical-flow assignment (reference: 06-frontend-direct-method/
01-optical-flow/optical_flow.cpp:144-466 — multi-level, scale 0.5,
Gauss-Newton per patch; 21×21 patches / 3 levels / fixed iteration counts
like the capstone tracker).

All features are tracked as ONE batch: patch extraction is a batched
bilinear gather, the 2×2 normal systems are solved in closed form, and
the per-level iteration is a fixed-count loop — fixed shapes, no
data-dependent control flow, no host round trip inside a call.  The
template Hessian is precomputed once per level (inverse-compositional),
so each iteration costs one gather + two reductions per feature.

Two tracking modes compose per frame:
  1. frame-to-frame pyramidal tracking (``track`` / ``track_fb``) finds
     each feature to within ~1 px — large motion basin, but its template
     re-anchors every frame so alignment noise RANDOM-WALKS along a track;
  2. birth-template refinement (``sample_templates`` +
     ``refine_on_templates``) then registers the feature against its
     appearance at FIRST observation with a small Gaussian-weighted window
     at full resolution — drift-free sub-pixel measurements, the property
     the BA accuracy actually depends on (SVO-style feature alignment).

Images are float32; positions carry the caller's dtype, and every
function takes its device from its inputs.
"""
from __future__ import annotations

import torch

from . import pyramid

PATCH = 21          # cv::calcOpticalFlowPyrLK default window
HALF = PATCH // 2
REFINE_HALF = 5     # 11×11 refinement window: small footprint so nearby
                    # features with different parallax cannot drag the fit


def _patch_grid(dtype, device, half: int = HALF):
    d = torch.arange(-half, half + 1, dtype=dtype, device=device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    return torch.stack([dx, dy], dim=-1).reshape(-1, 2)    # (P², 2)


def _gauss_weights(dtype, device, half: int):
    """Isotropic Gaussian window (P²,) with σ = half/1.5 — downweights the
    patch rim where neighboring-feature contamination lives."""
    g = _patch_grid(dtype, device, half)
    s2 = (half / 1.5) ** 2
    return torch.exp(-0.5 * torch.sum(g * g, dim=-1) / s2)


def _zero_mean(P):
    return P - torch.mean(P, dim=1, keepdim=True)


def _ic_iterate(img1, T, Gx, Gy, p1_init, n_iters: int, scale: float = 1.0,
                half: int = HALF, weighted: bool = False):
    """Run n_iters of zero-mean inverse-compositional LK against the given
    template patches (N, P²) with gradients, starting from full-resolution
    positions p1_init.  `scale` converts full-res coords to this pyramid
    level (positions at the level are p / scale).  Returns (p1, good_H,
    residual) — residual is the mean |zero-mean diff| at the solution."""
    P2 = (2 * half + 1) ** 2
    w = _gauss_weights(img1.dtype, img1.device, half) if weighted else \
        torch.ones(P2, dtype=img1.dtype, device=img1.device)
    T0 = _zero_mean(T)
    H00 = torch.sum(w * Gx * Gx, dim=1)
    H01 = torch.sum(w * Gx * Gy, dim=1)
    H11 = torch.sum(w * Gy * Gy, dim=1)
    det = H00 * H11 - H01 * H01
    good_H = det > 1e-6
    inv_det = torch.where(good_H, 1.0 / torch.where(good_H, det, torch.ones_like(det)),
                          torch.zeros_like(det))

    def sample(p1):
        return pyramid.patch_sample(img1, p1 / scale, half)

    p1 = p1_init
    for _ in range(n_iters):
        I = sample(p1)
        r = _zero_mean(I) - T0                             # (N, P²)
        b0 = torch.sum(w * Gx * r, dim=1)
        b1 = torch.sum(w * Gy * r, dim=1)
        du = inv_det * (H11 * b0 - H01 * b1)
        dv = inv_det * (-H01 * b0 + H00 * b1)
        # inverse-compositional: template warp inverts onto the target
        p1 = p1 - scale * torch.stack([du, dv], dim=-1)

    I = sample(p1)
    res = torch.mean(torch.abs(_zero_mean(I) - T0), dim=1)
    return p1, good_H, res


def _track_level(img0, img1, p0, p1_init, n_iters: int):
    """One pyramid level of inverse-compositional LK for all features.

    p0 (N,2): template positions in img0; p1_init: current guesses in img1.
    All positions in THIS level's coordinates.  Returns (p1, good_H,
    residual)."""
    T, Gx, Gy = _templates_at(img0, p0, HALF)
    return _ic_iterate(img1, T, Gx, Gy, p1_init, n_iters)


def _templates_at(img, p0, half):
    """Template patch + gradients at fixed positions p0: (T, Gx, Gy), each
    (N, P²)."""
    gx, gy = pyramid.central_gradients(img)
    return pyramid.patch_sample_multi(torch.stack([img, gx, gy]), p0, half)


def _track_pyr(pyr0, pyr1, p0, valid, levels: int, n_iters: int,
               max_residual: float):
    """Core pyramidal track against prebuilt pyramids (see ``track``)."""
    img0 = pyr0[0]
    scale = 2.0 ** (levels - 1)
    p1 = p0 / scale
    ok = valid
    res = torch.zeros(p0.shape[0], dtype=img0.dtype, device=img0.device)
    for lv in range(levels - 1, -1, -1):
        s = 2.0 ** lv
        p1, good_H, res = _track_level(pyr0[lv], pyr1[lv], p0 / s, p1, n_iters)
        ok = ok & good_H
        if lv > 0:
            p1 = p1 * 2.0
    H, W = img0.shape
    inb = (p1[:, 0] >= 1.0) & (p1[:, 0] < W - 1) & \
          (p1[:, 1] >= 1.0) & (p1[:, 1] < H - 1)
    ok = ok & inb & (res < max_residual)
    return p1, ok, res


def track(img0, img1, p0, valid, levels: int = 3, n_iters: int = 10,
          max_residual: float = 25.0):
    """Track features p0 (N,2) from img0 to img1 through a `levels`-deep
    pyramid.  Returns (p1 (N,2), ok (N,), residual (N,))."""
    pyr0 = pyramid.build_pyramid(img0, levels)
    pyr1 = pyramid.build_pyramid(img1, levels)
    return _track_pyr(pyr0, pyr1, p0, valid, levels, n_iters, max_residual)


def sample_templates(img, p0):
    """Refinement template patches + gradients for every feature, anchored
    at full-resolution positions p0 (N, 2).

    Returns (T, Gx, Gy) each (N, P²) over the small REFINE window at full
    resolution.  Captured ONCE at feature birth, these anchor drift-free
    tracking: every subsequent frame is registered against the BIRTH
    appearance, so per-frame alignment noise does not accumulate along the
    track (unlike frame-to-frame KLT, whose template re-anchors on the
    previous estimate each frame — a random walk of ~0.1 px/frame that
    wrecks long-track BA accuracy)."""
    return _templates_at(img, p0, REFINE_HALF)


def refine_on_templates(img1, T, Gx, Gy, p_init, valid, n_iters: int = 8,
                        max_shift: float = 2.0, max_residual: float = 25.0):
    """Refine positions against stored birth templates (see
    sample_templates).  p_init comes from frame-to-frame tracking and is
    expected within ~1 px, so a single full-resolution pass with the small
    Gaussian-weighted window suffices.  Returns (p1, ok, residual); ok
    requires convergence near p_init."""
    p1, good_H, res = _ic_iterate(img1, T, Gx, Gy, p_init, n_iters,
                                  scale=1.0, half=REFINE_HALF, weighted=True)
    d = torch.linalg.norm(p1 - p_init, dim=-1)
    H, W = img1.shape
    inb = (p1[:, 0] >= 1.0) & (p1[:, 0] < W - 1) & \
          (p1[:, 1] >= 1.0) & (p1[:, 1] < H - 1)
    ok = valid & good_H & inb & (d < max_shift) & (res < max_residual)
    return p1, ok, res


def track_fb(img0, img1, p0, valid, levels: int = 3, n_iters: int = 10,
             max_residual: float = 25.0, fb_thresh: float = 0.5):
    """Forward-backward tracking: track 0→1, then 1→0, and require the
    round trip to land within fb_thresh px (a stronger outlier gate than
    the reference's status flags).  Pyramids are built once and shared by
    both passes."""
    pyr0 = pyramid.build_pyramid(img0, levels)
    pyr1 = pyramid.build_pyramid(img1, levels)
    p1, ok, res = _track_pyr(pyr0, pyr1, p0, valid, levels, n_iters,
                             max_residual)
    p0_back, ok_b, _ = _track_pyr(pyr1, pyr0, p1, ok, levels, n_iters,
                                  max_residual)
    d = torch.linalg.norm(p0_back - p0, dim=-1)
    return p1, ok & ok_b & (d < fb_thresh), res
