"""Image pyramid, gradients and bilinear sampling, on the tensor's device.

Port of the gather path of ``vio_tpu/features/pyramid.py``.  Replaces the
OpenCV pyramid build inside cv::calcOpticalFlowPyrLK and the
bilinear/Scharr ImageWithGradient of the reference
(reference: 06-frontend-direct-method/01-optical-flow/optical_flow.cpp:10-84,
vins-mono/src/feature_tracker.cpp:113).  Stencils are static shifted adds
in the order the JAX package adds them; sampling is four explicit gathers,
because the edge clamp below is part of what the KLT in-bounds gates see.
Every function takes its device and dtype from its input tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _corr1d(img, taps, axis: int):
    """1-D correlation along `axis` with zero-padded SAME semantics,
    written as static shifted adds."""
    r = len(taps) // 2
    p = F.pad(img, (0, 0, r, r) if axis == 0 else (r, r, 0, 0))
    H, W = img.shape
    out = None
    for i, w in enumerate(taps):
        if w == 0.0:
            continue
        sl = p[i:i + H, :] if axis == 0 else p[:, i:i + W]
        out = w * sl if out is None else out + w * sl
    return out


def _sepcorr(img, ky, kx):
    """Separable 2-D correlation (zero-padded SAME): ky along rows then
    kx along columns — the dense outer-product kernel up to float
    association."""
    return _corr1d(_corr1d(img, ky, 0), kx, 1)


def _conv2(img, kernel):
    """Single-channel 2-D correlation with SAME padding; img (H, W).
    Small non-separable stencils only — static shifted adds."""
    kh, kw = kernel.shape
    rh, rw = kh // 2, kw // 2
    p = F.pad(img, (rw, rw, rh, rh))
    H, W = img.shape
    out = torch.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            out = out + kernel[i, j] * p[i:i + H, j:j + W]
    return out


_PYR_TAPS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def downsample2(img):
    """5-tap Gaussian blur + 2× decimation (the classic pyrDown)."""
    return _sepcorr(img, _PYR_TAPS, _PYR_TAPS)[::2, ::2]


def build_pyramid(img, levels: int = 3):
    """[level0 (full res), level1 (half), ...]"""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(downsample2(pyr[-1]))
    return pyr


_SCHARR_D = (-1.0, 0.0, 1.0)
_SCHARR_S = (3.0 / 16, 10.0 / 16, 3.0 / 16)


def scharr_gradients(img):
    """(gx, gy) with the Scharr 3×3 stencil (the reference's gradient
    operator, optical_flow.cpp ImageWithGradient)."""
    gx = _sepcorr(img, _SCHARR_S, _SCHARR_D)
    gy = _sepcorr(img, _SCHARR_D, _SCHARR_S)
    return gx, gy


def central_gradients(img):
    """Simple central differences (matches cv::calcOpticalFlowPyrLK's
    internal derivative scale more closely than Scharr).  The difference
    wraps around at the image border."""
    gx = 0.5 * (torch.roll(img, -1, dims=1) - torch.roll(img, 1, dims=1))
    gy = 0.5 * (torch.roll(img, -1, dims=0) - torch.roll(img, 1, dims=0))
    return gx, gy


def bilinear_sample(img, xy, index=None):
    """Sample img (..., H, W) at float positions xy (..., 2) (x=col,
    y=row), with edge clamping: positions are clamped to
    [0, W − 1.001] × [0, H − 1.001] before the four taps are gathered.
    Leading dimensions of img are channels sampled at the same positions.
    With ``index`` (integers that broadcast against xy[..., 0]), img is a
    stack (C, H, W) and each position samples image ``index`` of it."""
    H, W = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    base = y0 * W + x0
    if index is None:
        flat = img.reshape(img.shape[:-2] + (H * W,))
    else:
        flat = img.reshape(-1)
        base = base + index * (H * W)
    i00 = flat[..., base]
    i01 = flat[..., base + 1]
    i10 = flat[..., base + W]
    i11 = flat[..., base + W + 1]
    return ((1 - fy) * ((1 - fx) * i00 + fx * i01) +
            fy * ((1 - fx) * i10 + fx * i11))


def patch_sample_multi(imgs, centers, half):
    """Bilinear patches of every channel of imgs (C, H, W) around centers
    (N, 2) on the integer offset grid [-half, half]².  Returns (C, N, P²)
    with P = 2·half+1 in row-major (dy, dx) order."""
    d = torch.arange(-half, half + 1, dtype=imgs.dtype, device=imgs.device)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    grid = torch.stack([dx, dy], dim=-1).reshape(-1, 2)
    pts = centers[:, None, :] + grid[None, :, :]               # (N, P², 2)
    return bilinear_sample(imgs, pts)


def patch_sample(img, centers, half):
    """Single-image variant of patch_sample_multi: (N, P²)."""
    return patch_sample_multi(img[None], centers, half)[0]
