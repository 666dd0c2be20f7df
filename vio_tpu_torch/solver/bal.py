"""Large-scale bundle adjustment in BAL form (cameras + XYZ points).

Port of ``vio_tpu/solver/bal.py`` (reference: 07-backend-optimization/
01-bal-g2o/src/bal_g2o.cpp:67-216 — 9-param BAL cameras [angle-axis R, t,
f, k1, k2], XYZ landmarks, Schur over points):

- states are stacked tensors: camera quaternions/translations/intrinsics
  ``(C, ·)``, points ``(M, 3)``;
- observations are a flat ``(O,)`` batch with (cam, point) indices and a
  validity mask; the residual and its Jacobian over [dθ, dt, df, dX] (12
  columns) come from ``torch.func.vmap`` of ``torch.func.jacfwd`` of one
  observation's residual, as ``jax.vmap(jax.jacfwd)`` in the JAX package;
- the block normal equations, the point-block Schur step and the damped
  reduced camera solve (9C unknowns: the Gauss-Jordan kernel's blocked
  regime above C = 19 in float32) are ``solver/blockba.py``'s, driven by
  its host Nielsen-LM.

BAL convention: P = R X + t, p = -P_xy / P_z, r(p) = 1 + k1|p|^2 + k2|p|^4,
predicted = f * r(p) * p  (bal_g2o.cpp projection / BAL docs).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import move, resolve
from ..utils import lie
from . import blockba


class BalProblem(NamedTuple):
    cam_q: torch.Tensor    # (C, 4) world->cam rotation quaternion
    cam_t: torch.Tensor    # (C, 3)
    cam_fkk: torch.Tensor  # (C, 3) [f, k1, k2]
    points: torch.Tensor   # (M, 3)
    cam_idx: torch.Tensor  # (O,) int64
    pt_idx: torch.Tensor   # (O,) int64
    uv: torch.Tensor       # (O, 2)
    valid: torch.Tensor    # (O,) bool


def load_bal(path: str, device=None, dtype=None) -> BalProblem:
    """Read the BAL text format (num_cams num_points num_obs; obs lines;
    then 9 params per camera [Rodrigues(3), t(3), f, k1, k2]; 3 per point).
    The rotations are converted in float64 on the host; the problem lands
    on ``device`` (the card unless told otherwise)."""
    device, dtype = resolve(device, dtype)
    with open(path) as fh:
        tokens = fh.read().split()
    C, M, O = int(tokens[0]), int(tokens[1]), int(tokens[2])
    obs = np.asarray(tokens[3:3 + 4 * O], dtype=np.float64).reshape(O, 4)
    rest = np.asarray(tokens[3 + 4 * O:3 + 4 * O + 9 * C + 3 * M], dtype=np.float64)
    cams = rest[:9 * C].reshape(C, 9)
    pts = rest[9 * C:].reshape(M, 3)
    qs = lie.so3_exp_quat(torch.as_tensor(cams[:, :3], dtype=torch.float64))
    kw = dict(dtype=dtype, device=device)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)  # noqa: E731
    return BalProblem(
        cam_q=qs.to(**kw), cam_t=torch.as_tensor(cams[:, 3:6], **kw),
        cam_fkk=torch.as_tensor(cams[:, 6:9], **kw),
        points=torch.as_tensor(pts, **kw),
        cam_idx=idx(obs[:, 0].astype(np.int64)), pt_idx=idx(obs[:, 1].astype(np.int64)),
        uv=torch.as_tensor(obs[:, 2:4], **kw),
        valid=torch.ones(O, dtype=torch.bool, device=device))


def bal_residual(q, t, fkk, X, uv):
    """2-vector reprojection residual, batched over leading dimensions."""
    P = lie.quat_rotate(q, X) + t
    p = -P[..., :2] / P[..., 2:3]
    # kept (..., 1), never 0-d: under torch.func.jacfwd a 0-d float32
    # tensor added to a Python float gets a float64 tangent
    r2 = torch.sum(p * p, dim=-1, keepdim=True)
    d = 1.0 + fkk[..., 1:2] * r2 + fkk[..., 2:3] * r2 * r2
    return fkk[..., 0:1] * d * p - uv


def _obs_residual_jac(q, t, fkk, X, uv):
    """One observation's residual and its Jacobian wrt [dθ(3), dt(3),
    dfkk(3), dX(3)] by forward mode."""
    def h(z):
        dq = lie.so3_exp_quat(z[0:3])
        return bal_residual(lie.quat_mul(q, dq), t + z[3:6],
                            fkk + z[6:9], X + z[9:12], uv)
    z0 = torch.zeros(12, dtype=q.dtype, device=q.device)
    return h(z0), torch.func.jacfwd(h)(z0)          # (2,), (2, 12)


_batch_residual_jac = torch.func.vmap(_obs_residual_jac)


def _assemble(p: BalProblem, C: int, M: int, optimize_intrinsics: bool,
              huber: float, gauge_fix: int) -> blockba.BlockNormal:
    dtype, device = p.points.dtype, p.points.device
    r, J = _batch_residual_jac(p.cam_q[p.cam_idx], p.cam_t[p.cam_idx],
                               p.cam_fkk[p.cam_idx], p.points[p.pt_idx],
                               p.uv)                  # (O,2), (O,2,12)
    if not optimize_intrinsics:
        J[:, :, 6:9] = 0.0

    # fixed-vertex zeroing (the gauge: first gauge_fix cameras), like the
    # reference's MakeHessian fixed-block handling (problem.cc:365-384)
    free_obs = (p.cam_idx >= gauge_fix).to(dtype)
    J[:, :, 0:9] *= free_obs[:, None, None]

    m = p.valid.to(dtype)
    e2 = torch.sum(r * r, dim=-1)
    # Huber: w = min(1, delta/|r|); chi uses rho
    e = torch.sqrt(torch.clamp(e2, min=1e-30))
    one = torch.ones_like(e)
    w = torch.where(e <= huber, one, huber / e) * m
    rho = torch.where(e <= huber, e2, huber * (2.0 * e - huber)) * m

    # unit diagonal on fixed parameters so the reduced system stays SPD
    fp9 = (torch.arange(C, device=device) >= gauge_fix).to(dtype)[:, None].repeat(1, 9)
    if not optimize_intrinsics:
        fp9[:, 6:9] = 0.0
    fixed_diag = 1.0 - fp9.reshape(9 * C)

    return blockba.assemble_blocks(r, J[:, :, 0:9], J[:, :, 9:12],
                                   p.cam_idx, p.pt_idx, w, rho, C, M,
                                   fixed_diag=fixed_diag)


def _apply(p: BalProblem, dxc, dxp, gauge_fix: int):
    """Right-multiplicative SO3 update on cameras; first ``gauge_fix``
    cameras held fixed (the BAL gauge: fix cam0, cf. TestMonoBA's pose
    fixation alternative)."""
    mask = (torch.arange(p.cam_q.shape[0], device=dxc.device) >= gauge_fix).to(dxc.dtype)
    dxc = dxc * mask[:, None]
    q = lie.quat_normalize(lie.quat_mul(p.cam_q, lie.so3_exp_quat(dxc[:, 0:3])))
    return p._replace(cam_q=q, cam_t=p.cam_t + dxc[:, 3:6],
                      cam_fkk=p.cam_fkk + dxc[:, 6:9],
                      points=p.points + dxp)


def solve(p: BalProblem, max_iter: int = 30, optimize_intrinsics: bool = True,
          huber: float = 2.0, gauge_fix: int = 1, verbose: bool = False,
          device=None, dtype=None):
    """Nielsen-LM over the Schur-reduced camera system (host loop: BA runs
    once, not per frame).  The problem is moved to ``device`` and
    ``dtype`` first: without them, the card in float32.  Returns
    (problem, chi² history)."""
    device, dtype = resolve(device, dtype)
    p = move(p, device, dtype)
    C = p.cam_q.shape[0]
    M = p.points.shape[0]
    return blockba.lm_loop(
        p,
        lambda p_: _assemble(p_, C, M, optimize_intrinsics, huber, gauge_fix),
        lambda p_, dxc, dxp: _apply(p_, dxc, dxp, gauge_fix),
        C, M, max_iter=max_iter, verbose=verbose)
