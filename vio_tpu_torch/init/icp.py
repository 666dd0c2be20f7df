"""Point-cloud alignment: SVD-Umeyama ICP and GN-on-SE3 refinement.

Port of ``vio_tpu/init/icp.py`` (reference: 05-frontend-feature-matching/
04-icp/SVD.cpp:183 Umeyama closed form, G-N.cpp:222 Gauss-Newton on SE3,
incl. trajectory alignment).  Known correspondences; the closed form is
one 3×3 SVD and the Gauss-Newton loop a fixed number of iterations.  Both
take their device and dtype from their input tensors.
"""
from __future__ import annotations

import torch

from ..utils import lie


def umeyama(src, dst, weights=None):
    """Closed-form rigid alignment: returns (R, t) with dst ≈ R·src + t.
    src/dst (N, 3); optional weights (N,).  The SVD's factors carry
    arbitrary signs, but R = U·S·Vh with S[2,2] = sign(det(U·Vh)) is
    unique."""
    w = torch.ones(src.shape[0], dtype=src.dtype, device=src.device) \
        if weights is None else weights
    wsum = torch.sum(w)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_d = torch.sum(dst * w[:, None], dim=0) / wsum
    xs = src - mu_s
    xd = dst - mu_d
    cov = (xd * w[:, None]).T @ xs / wsum
    U, _, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U @ Vt))
    S = torch.cat([torch.ones(2, dtype=src.dtype, device=src.device), d[None]])
    R = (U * S) @ Vt
    t = mu_d - R @ mu_s
    return R, t


def icp_gn(src, dst, R0, t0, weights=None, iters: int = 10):
    """Gauss-Newton refinement of (R, t) minimizing Σ‖dst − (R src + t)‖²
    with left-multiplicative SE3 updates (G-N.cpp:222).  Returns (R, t,
    RMS residual)."""
    w = torch.ones(src.shape[0], dtype=src.dtype, device=src.device) \
        if weights is None else weights
    eye3 = torch.eye(3, dtype=src.dtype, device=src.device)
    R, t = R0, t0
    for _ in range(iters):
        p = src @ R.T + t                        # (N, 3)
        r = p - dst
        # d r / d [dt, dθ] = [I, -hat(p)]
        J = torch.cat([eye3.expand(p.shape[0], 3, 3), -lie.so3_hat(p)],
                      dim=-1)                    # (N, 3, 6)
        Jw = J * w[:, None, None]
        H = torch.einsum("nip,niq->pq", Jw, J) + 1e-9 * torch.eye(
            6, dtype=src.dtype, device=src.device)
        b = -torch.einsum("nip,ni->p", Jw, r)
        dx = torch.linalg.solve(H, b)
        R, t = lie.so3_exp_mat(dx[3:6]) @ R, t + dx[0:3]
    res = torch.sqrt(torch.mean(torch.sum((src @ R.T + t - dst) ** 2, dim=-1)))
    return R, t, res
