"""Shi-Tomasi corner detection with min-distance grid NMS, on the
tensor's device.

Port of ``vio_tpu/features/detect.py``.  Replaces cv::goodFeaturesToTrack
+ the mask-based min-distance selection loop (reference:
vins-mono/src/feature_tracker.cpp:36-79 setMask/addPoints, :149
goodFeaturesToTrack).  The reference's sequential mask loop becomes a
static max-pool NMS: a corner survives if it is the maximum of its
(2r+1)² neighborhood and above quality_level · global max — then the top-K
responses are taken with a fixed K, so shapes never depend on the image.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import pyramid


def shi_tomasi_response(img, window: int = 3):
    """Min-eigenvalue corner response of the structure tensor, box-filtered
    over `window` (the goodFeaturesToTrack score)."""
    gx, gy = pyramid.scharr_gradients(img)
    box = (1.0 / window,) * window          # separable box filter
    sxx = pyramid._sepcorr(gx * gx, box, box)
    syy = pyramid._sepcorr(gy * gy, box, box)
    sxy = pyramid._sepcorr(gx * gy, box, box)
    tr = sxx + syy
    det_disc = torch.sqrt(torch.clamp((sxx - syy) ** 2 + 4.0 * sxy * sxy, min=0.0))
    return 0.5 * (tr - det_disc)      # λ_min


def _maxpool_same(x, r: int):
    """(2r+1)² max-pool of x (H, W) with SAME semantics, as two 1-D passes
    (max is separable).  Outside the image counts as −inf, which is
    max_pool2d's implicit padding."""
    x = F.max_pool2d(x[None, None], (2 * r + 1, 1), stride=1, padding=(r, 0))
    return F.max_pool2d(x, (1, 2 * r + 1), stride=1, padding=(0, r))[0, 0]


def detect(img, occupancy_mask=None, max_corners: int = 150,
           min_dist: int = 30, quality: float = 0.01, border: int = 8):
    """Top-K Shi-Tomasi corners with min-distance NMS.

    occupancy_mask (H, W) bool: True where detection is FORBIDDEN (the
    reference's circle mask around tracked features, feature_tracker.cpp:36).
    Returns (xy (K, 2) float, score (K,), valid (K,)).  The order among
    equal scores is unspecified; only entries with ``valid`` carry meaning."""
    H, W = img.shape
    resp = shi_tomasi_response(img)

    row = torch.arange(H, device=img.device)[:, None]
    col = torch.arange(W, device=img.device)[None, :]
    ok = (row >= border) & (row < H - border) & \
         (col >= border) & (col < W - border)
    neg_inf = torch.full_like(resp, -torch.inf)
    resp_src = torch.where(ok, resp, torch.zeros_like(resp))
    resp = torch.where(ok, resp, neg_inf)

    # NMS at the min-dist radius (replaces the sequential mask loop);
    # a surviving peak is the max of its (2·min_dist+1)² neighborhood,
    # giving ≥ min_dist spacing like cv::goodFeaturesToTrack(minDistance).
    # The occupancy mask is applied AFTER the peak test (as OpenCV masks
    # candidates, not the response): masking the response first manufactures
    # false peaks at mask boundaries — blob/corner skirts ~1 px off any
    # real feature, which then poison the track with constant offsets.
    is_peak = resp >= _maxpool_same(resp, min_dist)
    if occupancy_mask is not None:
        is_peak = is_peak & ~occupancy_mask
    resp = torch.where(is_peak, resp, neg_inf)
    # quality gate relative to the GLOBAL response max (OpenCV semantics:
    # qualityLevel · maxVal over the whole image, not over survivors)
    thresh = quality * torch.max(resp_src)

    score, idx = torch.topk(resp.reshape(-1), max_corners)
    yi = idx // W
    xi = idx % W
    valid = score > torch.clamp(thresh, min=0.0)

    # sub-pixel localization: 1-D quadratic fit through the response peak
    # in x and y (cv::cornerSubPix analog, cheap gather form).  Detections
    # at integer pixels otherwise carry a ~0.5 px constant offset per
    # feature for the whole track.  Uses the PRE-NMS response (peak
    # neighbors are -inf in the NMS'd map).
    def sub(c0, c1, c2):
        denom = c0 - 2.0 * c1 + c2
        fit = torch.abs(denom) > 1e-12
        off = torch.where(fit, 0.5 * (c0 - c2) / torch.where(fit, denom, torch.ones_like(denom)),
                          torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    dx = sub(resp_src[yi, torch.clamp(xi - 1, min=0)], resp_src[yi, xi],
             resp_src[yi, torch.clamp(xi + 1, max=W - 1)])
    dy = sub(resp_src[torch.clamp(yi - 1, min=0), xi], resp_src[yi, xi],
             resp_src[torch.clamp(yi + 1, max=H - 1), xi])
    xx = xi.to(img.dtype) + dx
    yy = yi.to(img.dtype) + dy
    return torch.stack([xx, yy], dim=-1), score, valid


def occupancy_from_points(shape, xy, valid, min_dist: int):
    """Build the forbidden-region mask from existing track positions —
    a square of half-side min_dist around each (the reference's cv::circle
    mask).  Implemented as a scatter-max of points + max-pool dilation;
    positions truncate toward zero, and invalid slots write 0."""
    H, W = shape
    xi = torch.clamp(xy[:, 0].to(torch.int64), 0, W - 1)
    yi = torch.clamp(xy[:, 1].to(torch.int64), 0, H - 1)
    grid = torch.zeros(H * W, dtype=torch.float32, device=xy.device)
    grid.scatter_reduce_(0, yi * W + xi, valid.to(torch.float32), reduce="amax")
    dil = _maxpool_same(grid.reshape(H, W), min_dist)
    return dil > 0.5
