"""Lie-group / quaternion substrate (SO3) on torch tensors.

Port of ``vio_tpu/utils/lie.py``.  Quaternions are ``(x, y, z, w)`` tensors
of shape ``(..., 4)``; every function is batched over leading dimensions
(the JAX version relies on ``vmap`` for that).
"""
from __future__ import annotations

import math

import torch

__all__ = [
    "quat_identity", "quat_mul", "quat_conj", "quat_normalize", "quat_rotate",
    "quat_to_mat", "mat_to_quat", "delta_q", "so3_exp_quat", "quat_log",
    "so3_hat", "so3_exp_mat", "so3_log_mat", "so3_jacobian_r_inv",
    "q_left_corner", "q_right_corner", "ypr_to_mat", "mat_to_ypr", "g_to_R",
    "from_two_vectors",
]


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_identity(dtype=torch.float64, device=None):
    """(0, 0, 0, 1), made on ``device`` with no host-to-device copy (so it
    can be captured into a CUDA graph)."""
    q = torch.zeros(4, dtype=dtype, device=device)
    q[3:] = 1.0
    return q


def quat_mul(q, p):
    """Hamilton product q ⊗ p, both (..., 4) in (x,y,z,w) layout."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return torch.stack([
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw,
        qw * pw - qx * px - qy * py - qz * pz,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_mat(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """Rotation matrix (..., 3, 3) → quaternion (x,y,z,w). Branch-free
    (Shepperd's method evaluated on all four candidates, pick the best)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-30))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)

    cand = torch.stack([q0, q1, q2, q3], dim=-2)           # (..., 4cand, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def delta_q(theta):
    """Small-angle quaternion [theta/2, 1] (UN-normalized), the reference's
    Utility::deltaQ (utility.h:12-24)."""
    one = torch.ones(theta.shape[:-1] + (1,), dtype=theta.dtype, device=theta.device)
    return torch.cat([0.5 * theta, one], dim=-1)


def so3_exp_quat(phi):
    """Exact SO3 exponential as a quaternion (x,y,z,w)."""
    angle2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(angle2, min=1e-32))
    half = 0.5 * angle
    small = angle2 < 1e-16
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(half))
    return torch.cat([k * phi, w], dim=-1)


def quat_log(q):
    """SO3 log of a unit quaternion → rotation vector (..., 3)."""
    sgn = torch.where(q[..., 3:4] < 0, -1.0, 1.0).to(q.dtype)
    qv = q[..., :3] * sgn
    qw = q[..., 3:4] * sgn
    n = torch.linalg.norm(qv, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(n, qw)
    small = n < 1e-9
    k = torch.where(small, 2.0 / torch.clamp(qw, min=1e-12),
                    angle / torch.clamp(n, min=1e-30))
    return k * qv


def so3_hat(v):
    """Skew-symmetric matrix (..., 3, 3) of v (..., 3)
    (reference: utility.h:27-34 skewSymmetric)."""
    z = torch.zeros_like(v[..., 0])
    m = torch.stack([
        z, -v[..., 2], v[..., 1],
        v[..., 2], z, -v[..., 0],
        -v[..., 1], v[..., 0], z,
    ], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def so3_exp_mat(phi):
    return quat_to_mat(so3_exp_quat(phi))


def so3_log_mat(R):
    return quat_log(mat_to_quat(R))


def so3_jacobian_r_inv(phi):
    """Inverse right Jacobian of SO3 (Forster RSS15 eq. A.32)."""
    angle2 = torch.sum(phi * phi, dim=-1)
    angle = torch.sqrt(torch.clamp(angle2, min=1e-32))
    hat = so3_hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(hat.shape)
    half_angle = 0.5 * angle
    cot = half_angle / torch.tan(torch.clamp(half_angle, min=1e-12))
    k = torch.where(angle2 < 1e-16, 1.0 / 12.0,
                    (1.0 - cot) / torch.clamp(angle2, min=1e-32))
    return eye + 0.5 * hat + k[..., None, None] * (hat @ hat)


def _eye3_like(q):
    return torch.eye(3, dtype=q.dtype, device=q.device)


def q_left_corner(q):
    """Bottom-right 3x3 of Utility::Qleft (utility.h:47-54): w·I + [v]x."""
    return q[..., 3, None, None] * _eye3_like(q) + so3_hat(q[..., :3])


def q_right_corner(q):
    """Bottom-right 3x3 of Utility::Qright (utility.h:57-64): w·I − [v]x."""
    return q[..., 3, None, None] * _eye3_like(q) - so3_hat(q[..., :3])


def ypr_to_mat(ypr_deg):
    """Yaw-pitch-roll (degrees) → rotation matrix, Rz·Ry·Rx
    (reference: utility.h:84-108)."""
    r = ypr_deg * (math.pi / 180.0)
    y, p, ro = r[..., 0], r[..., 1], r[..., 2]
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(ro), torch.sin(ro)
    m = torch.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], dim=-1)
    return m.reshape(ypr_deg.shape[:-1] + (3, 3))


def mat_to_ypr(R):
    """Rotation matrix → yaw-pitch-roll in DEGREES
    (reference: utility.h:66-81 R2ypr)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = torch.atan2(n[..., 1], n[..., 0])
    p = torch.atan2(-n[..., 2], n[..., 0] * torch.cos(y) + n[..., 1] * torch.sin(y))
    r = torch.atan2(a[..., 0] * torch.sin(y) - a[..., 1] * torch.cos(y),
                    -o[..., 0] * torch.sin(y) + o[..., 1] * torch.cos(y))
    return torch.stack([y, p, r], dim=-1) * (180.0 / math.pi)


def from_two_vectors(a, b):
    """Quaternion rotating unit-ish vector a onto b (Eigen FromTwoVectors)."""
    a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    c = _cross(a, b)
    d = torch.sum(a * b, dim=-1, keepdim=True)
    w = 1.0 + d
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device)
    ortho = torch.where(torch.abs(a[..., 0:1]) < 0.9, _cross(a, ex), _cross(a, ey))
    anti = w[..., 0] < 1e-8
    xyz = torch.where(anti[..., None], ortho, c)
    w = torch.where(anti[..., None], torch.zeros_like(w), w)
    return quat_normalize(torch.cat([xyz, w], dim=-1))


def g_to_R(g):
    """Rotation aligning gravity vector g with +z then zeroing its own yaw
    (reference: src/utility/utility.cpp g2R)."""
    ng1 = g / torch.linalg.norm(g)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    R0 = quat_to_mat(from_two_vectors(ng1, ng2))
    yaw = mat_to_ypr(R0)[0]
    zero = torch.zeros_like(yaw)
    return ypr_to_mat(torch.stack([-yaw, zero, zero])) @ R0
