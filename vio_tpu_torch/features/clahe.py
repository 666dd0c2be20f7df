"""Contrast-limited adaptive histogram equalization (CLAHE), on the
tensor's device.

Port of ``vio_tpu/features/clahe.py``.  Replaces
cv::createCLAHE(3.0, cv::Size(8, 8)) (reference:
vins-mono/src/feature_tracker.cpp:89-91 — applied to every frame when
EQUALIZE, which the EuRoC config enables because the sequences are dark).

Per-tile 256-bin histograms via one scatter-add of ones (the counts are
exact integers, so the order in which a device adds them cannot change
the result), clip + uniform excess redistribution, per-tile LUT from the
cumulative histogram, then one gather with bilinear interpolation between
the four neighboring tile LUTs per pixel.  Fixed shapes, no per-tile host
loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

N_BINS = 256


def clahe(img, clip_limit: float = 3.0, grid_h: int = 8, grid_w: int = 8):
    """Equalize a grayscale image tensor (H, W) with values in [0, 255].

    Returns float32 in [0, 255] on the image's device.  The image is
    padded (edge mode) up to a multiple of the tile grid, exactly like
    OpenCV's border replication.
    """
    img = img.to(torch.float32)
    dev = img.device
    H, W = img.shape
    th = -(-H // grid_h)      # ceil division
    tw = -(-W // grid_w)
    Hp, Wp = th * grid_h, tw * grid_w
    padded = F.pad(img[None, None], (0, Wp - W, 0, Hp - H), mode="replicate")[0, 0]

    # --- per-tile histograms (one scatter-add over all pixels) ---
    v = torch.clamp(padded, 0.0, 255.0)
    bins = torch.clamp(v.to(torch.int64), 0, N_BINS - 1)
    ty = torch.arange(Hp, device=dev) // th                # (Hp,)
    tx = torch.arange(Wp, device=dev) // tw                # (Wp,)
    tile_id = ty[:, None] * grid_w + tx[None, :]           # (Hp, Wp)
    flat_idx = (tile_id * N_BINS + bins).reshape(-1)
    hist = torch.zeros(grid_h * grid_w * N_BINS, dtype=torch.float32, device=dev)
    hist.scatter_add_(0, flat_idx, torch.ones_like(flat_idx, dtype=torch.float32))
    hist = hist.reshape(grid_h * grid_w, N_BINS)

    # --- clip + redistribute excess uniformly (OpenCV CLAHE semantics:
    # clip value is clip_limit * tile_area / n_bins, min 1) ---
    tile_area = float(th * tw)
    clip = max(clip_limit * tile_area / N_BINS, 1.0)
    excess = torch.sum(torch.clamp(hist - clip, min=0.0), dim=1, keepdim=True)
    hist = torch.clamp(hist, max=clip) + excess / N_BINS

    # --- per-tile LUT: scaled CDF ---
    cdf = torch.cumsum(hist, dim=1)
    lut = cdf * ((N_BINS - 1.0) / tile_area)               # (T, 256)
    lut = lut.reshape(grid_h, grid_w, N_BINS)

    # --- bilinear interpolation between the 4 surrounding tile LUTs;
    # tile centres sit at pixel (i + 0.5)·th − 0.5 ---
    fy = (torch.arange(Hp, dtype=torch.float32, device=dev) + 0.5) / th - 0.5
    fx = (torch.arange(Wp, dtype=torch.float32, device=dev) + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, grid_h - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, grid_w - 1)
    y1 = torch.clamp(y0 + 1, max=grid_h - 1)
    x1 = torch.clamp(x0 + 1, max=grid_w - 1)
    wy = torch.clamp(fy - y0.to(torch.float32), 0.0, 1.0)[:, None]
    wx = torch.clamp(fx - x0.to(torch.float32), 0.0, 1.0)[None, :]

    def at(yi, xi):
        return lut[yi[:, None], xi[None, :], bins]

    out = ((1 - wy) * (1 - wx) * at(y0, x0) + (1 - wy) * wx * at(y0, x1)
           + wy * (1 - wx) * at(y1, x0) + wy * wx * at(y1, x1))
    return out[:H, :W]
