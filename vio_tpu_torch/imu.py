"""IMU preintegration: midpoint integrator with bias Jacobian & covariance.

Port of ``vio_tpu/imu.py`` (reference: vins-mono/include/factor/
integration_base.h:54-128 midPointIntegration, :160-186 evaluate).  Every
function is batched over leading dimensions.  The JAX ``lax.scan`` over the
M samples of a buffer is, on a CUDA tensor, one hand-written kernel
(``preintegrate_kernel``, ``csrc/preintegrate.cu``: a thread block per
interval, the steps a loop inside it) and, on a CPU tensor, its plain
version ``preintegrate_reference``, a Python loop over M, each step batched
over all intervals at once.  ``preintegrate`` routes by device and never
falls back from one to the other.

State ordering (15): [p(0:3), theta(3:6), v(6:9), ba(9:12), bg(12:15)].
Noise ordering (18): [an0, gn0, an1, gn1, baw, bgw].
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .ops import _build
from .utils import lie


class PreintState(NamedTuple):
    delta_p: torch.Tensor       # (..., 3)
    delta_q: torch.Tensor       # (..., 4) x,y,z,w
    delta_v: torch.Tensor       # (..., 3)
    jacobian: torch.Tensor      # (..., 15, 15)  d(preint)/d(bias at start)
    covariance: torch.Tensor    # (..., 15, 15)
    sum_dt: torch.Tensor        # (...)
    linearized_ba: torch.Tensor # (..., 3)
    linearized_bg: torch.Tensor # (..., 3)
    acc_last: torch.Tensor      # (..., 3) previous accel sample (acc_0)
    gyr_last: torch.Tensor      # (..., 3)


def init_state(acc0, gyr0, ba, bg) -> PreintState:
    """Fresh preintegration anchored at measurement (acc0, gyr0) with
    linearization biases (ba, bg), batched over acc0's leading dims
    (reference ctor integration_base.h:13-28)."""
    batch = acc0.shape[:-1]
    kw = dict(dtype=acc0.dtype, device=acc0.device)
    z3 = torch.zeros(batch + (3,), **kw)
    return PreintState(
        delta_p=z3,
        delta_q=lie.quat_identity(**kw).expand(batch + (4,)),
        delta_v=z3,
        jacobian=torch.eye(15, **kw).expand(batch + (15, 15)),
        covariance=torch.zeros(batch + (15, 15), **kw),
        sum_dt=torch.zeros(batch, **kw),
        linearized_ba=ba, linearized_bg=bg,
        acc_last=acc0, gyr_last=gyr0,
    )


def noise_diag(acc_n, gyr_n, acc_w, gyr_w, dtype=torch.float64, device=None):
    """Diagonal of the 18x18 continuous noise covariance
    (reference integration_base.h:21-27)."""
    an = acc_n * acc_n
    gn = gyr_n * gyr_n
    aw = acc_w * acc_w
    gw = gyr_w * gyr_w
    return torch.tensor([an] * 3 + [gn] * 3 + [an] * 3 + [gn] * 3 + [aw] * 3 + [gw] * 3,
                        dtype=dtype, device=device)


def midpoint_step(state: PreintState, dt, acc1, gyr1, noise_d, X=None):
    """One midpoint integration step (integration_base.h:54-128), batched
    over the leading dims of ``state``; dt has shape (...).  Returns
    (new_state, X_next); pass X (..., 15, 18) to propagate the exact
    shared-boundary-sample noise correlation, or None for the reference's
    independent-noise approximation."""
    acc0, gyr0 = state.acc_last, state.gyr_last
    ba, bg = state.linearized_ba, state.linearized_bg
    kw = dict(dtype=acc0.dtype, device=acc0.device)
    batch = acc0.shape[:-1]
    dt1 = dt[..., None]
    dt3 = dt[..., None, None]

    un_acc_0 = lie.quat_rotate(state.delta_q, acc0 - ba)
    un_gyr = 0.5 * (gyr0 + gyr1) - bg
    dq = torch.cat([un_gyr * (dt1 / 2.0), torch.ones(batch + (1,), **kw)], dim=-1)
    result_q = lie.quat_normalize(lie.quat_mul(state.delta_q, dq))
    un_acc_1 = lie.quat_rotate(result_q, acc1 - ba)
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    result_p = state.delta_p + state.delta_v * dt1 + 0.5 * un_acc * dt1 * dt1
    result_v = state.delta_v + un_acc * dt1

    # --- discrete transition F (15x15) and noise map V (15x18) ---
    R0 = lie.quat_to_mat(state.delta_q)
    R1 = lie.quat_to_mat(result_q)
    w_x = lie.so3_hat(un_gyr)
    a0_x = lie.so3_hat(acc0 - ba)
    a1_x = lie.so3_hat(acc1 - ba)
    I3 = torch.eye(3, **kw)
    dt2 = dt3 * dt3
    R0a0 = R0 @ a0_x
    R1a1 = R1 @ a1_x
    ImWdt = I3 - w_x * dt3
    R1a1_ImWdt = R1a1 @ ImWdt

    F = torch.zeros(batch + (15, 15), **kw)
    F[..., 0:3, 0:3] = I3
    F[..., 0:3, 3:6] = -0.25 * R0a0 * dt2 - 0.25 * R1a1_ImWdt * dt2
    F[..., 0:3, 6:9] = I3 * dt3
    F[..., 0:3, 9:12] = -0.25 * (R0 + R1) * dt2
    F[..., 0:3, 12:15] = 0.25 * R1a1 * dt2 * dt3
    F[..., 3:6, 3:6] = ImWdt
    F[..., 3:6, 12:15] = -I3 * dt3
    F[..., 6:9, 3:6] = -0.5 * R0a0 * dt3 - 0.5 * R1a1_ImWdt * dt3
    F[..., 6:9, 6:9] = I3
    F[..., 6:9, 9:12] = -0.5 * (R0 + R1) * dt3
    F[..., 6:9, 12:15] = 0.5 * R1a1 * dt2
    F[..., 9:12, 9:12] = I3
    F[..., 12:15, 12:15] = I3

    V = torch.zeros(batch + (15, 18), **kw)
    V[..., 0:3, 0:3] = 0.25 * R0 * dt2
    v03 = -0.125 * R1a1 * dt2 * dt3  # 0.25 * (-R1 a1x) * dt² * 0.5dt
    V[..., 0:3, 3:6] = v03
    V[..., 0:3, 6:9] = 0.25 * R1 * dt2
    V[..., 0:3, 9:12] = v03
    V[..., 3:6, 3:6] = 0.5 * I3 * dt3
    V[..., 3:6, 9:12] = 0.5 * I3 * dt3
    V[..., 6:9, 0:3] = 0.5 * R0 * dt3
    v63 = -0.25 * R1a1 * dt2  # 0.5 * (-R1 a1x) * dt * 0.5dt
    V[..., 6:9, 3:6] = v63
    V[..., 6:9, 6:9] = 0.5 * R1 * dt3
    V[..., 6:9, 9:12] = v63
    V[..., 9:12, 12:15] = I3 * dt3
    V[..., 12:15, 15:18] = I3 * dt3

    Ft = F.transpose(-1, -2)
    Vt = V.transpose(-1, -2)
    jac = F @ state.jacobian
    cov = F @ state.covariance @ Ft + (V * noise_d) @ Vt

    # Consecutive midpoint steps SHARE the boundary IMU sample; X carries
    # cov(delta_x_k, w_k) so the recursion adds the exact cross terms
    # F X Vᵀ + V Xᵀ Fᵀ (see vio_tpu/imu.py midpoint_step for the derivation).
    if X is not None:
        cross = (F @ X) @ Vt
        cov = cov + cross + cross.transpose(-1, -2)
        X_next = torch.zeros_like(X)
        X_next[..., :, 0:3] = V[..., :, 6:9] * noise_d[0]
        X_next[..., :, 3:6] = V[..., :, 9:12] * noise_d[3]
    else:
        X_next = None

    return PreintState(
        delta_p=result_p, delta_q=result_q, delta_v=result_v,
        jacobian=jac, covariance=cov,
        sum_dt=state.sum_dt + dt,
        linearized_ba=ba, linearized_bg=bg,
        acc_last=acc1, gyr_last=gyr1,
    ), X_next


def preintegrate_reference(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                           exact_noise: bool = True) -> PreintState:
    """The kernel's plain version: ``preintegrate`` as a Python loop of
    ``midpoint_step`` over the M slots, masked ones included, with the
    carry kept by ``torch.where`` where a slot is masked."""
    st = init_state(acc0, gyr0, ba, bg)
    X = (torch.zeros(acc0.shape[:-1] + (15, 18), dtype=acc0.dtype,
                     device=acc0.device) if exact_noise else None)
    for k in range(dts.shape[-1]):
        m = mask[..., k]
        new, X_new = midpoint_step(st, dts[..., k], accs[..., k, :],
                                   gyrs[..., k, :], noise_d, X=X)
        st = PreintState(*[
            torch.where(m.reshape(m.shape + (1,) * (a.dim() - m.dim())), a, b)
            for a, b in zip(new, st)])
        if exact_noise:
            X = torch.where(m[..., None, None], X_new, X)
    return st


@_build.counted
def preintegrate_kernel(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                        exact_noise: bool = True) -> PreintState:
    """``preintegrate`` with the CUDA kernel (``csrc/preintegrate.cu``), on
    the current stream, without synchronising; outputs come from
    ``torch.empty``, so a CUDA graph's capture records the launch.  Takes
    contiguous float32 or float64 CUDA tensors on one device (the mask
    boolean), with the shapes ``preintegrate`` names and noise_d (18,);
    raises on anything else, on a build failure and on a refused launch."""
    floats = (dts, accs, gyrs, acc0, gyr0, ba, bg, noise_d)
    if not all(t.is_cuda and t.device == dts.device for t in (*floats, mask)):
        raise ValueError("preintegrate_kernel takes CUDA tensors on one device")
    dtype = dts.dtype
    if (dtype not in (torch.float32, torch.float64) or mask.dtype != torch.bool
            or any(t.dtype != dtype for t in floats)):
        raise ValueError(f"preintegrate_kernel takes float32 or float64 and a bool "
                         f"mask, got {[t.dtype for t in (*floats, mask)]}")
    batch, M = tuple(dts.shape[:-1]), dts.shape[-1]
    want = (batch + (M, 3), batch + (M, 3), batch + (M,)) + (batch + (3,),) * 4 + ((18,),)
    got = tuple(tuple(t.shape) for t in (accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d))
    if got != want:
        raise ValueError(f"preintegrate_kernel shapes: dts {tuple(dts.shape)}, "
                         f"the rest {got}, expected {want}")
    if not all(t.is_contiguous() for t in (*floats, mask)):
        raise ValueError("preintegrate_kernel takes contiguous tensors")
    kw = dict(dtype=dtype, device=dts.device)
    out = PreintState(*(torch.empty(batch + s, **kw) for s in (
        (3,), (4,), (3,), (15, 15), (15, 15), (), (3,), (3,), (3,), (3,))))
    B = math.prod(batch)
    if B == 0:
        return out
    lib = _build.load()
    fn = lib.preintegrate_f32 if dtype == torch.float32 else lib.preintegrate_f64
    with torch.cuda.device(dts.device):
        stream = torch.cuda.current_stream(dts.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in (dts, accs, gyrs, mask, acc0, gyr0, ba, bg,
                                        noise_d, *out)),
                B, M, int(exact_noise), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"preintegrate launch failed: CUDA error {rc} "
                           f"({lib.gj_solve_error_string(rc).decode()})")
    if torch.cuda.is_current_stream_capturing():
        preintegrate_kernel.captured += 1   # recorded, not run: each replay launches it
    else:
        preintegrate_kernel.launches += 1
    return out


def preintegrate(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                 exact_noise: bool = True) -> PreintState:
    """Integrate fixed-capacity buffers of IMU samples.

    dts (..., M), accs (..., M, 3), gyrs (..., M, 3), mask (..., M) bool;
    acc0/gyr0/ba/bg (..., 3).  Masked-out steps are no-ops (identity
    carry); the mask need not be a prefix.  Equivalent to repeated
    IntegrationBase::push_back (integration_base.h:30-52).  exact_noise:
    propagate the shared-boundary-sample noise correlation
    (config.imu_noise_model).  CUDA tensors go to the kernel, CPU tensors
    to its plain version."""
    if dts.is_cuda:
        return preintegrate_kernel(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                                   exact_noise)
    return preintegrate_reference(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                                  exact_noise)


def evaluate(state: PreintState, g, Pi, Qi, Vi, Bai, Bgi,
             Pj, Qj, Vj, Baj, Bgj):
    """15-dim IMU factor residual with first-order bias correction
    (reference integration_base.h:160-186 evaluate), batched."""
    J = state.jacobian
    dp_dba = J[..., 0:3, 9:12]
    dp_dbg = J[..., 0:3, 12:15]
    dq_dbg = J[..., 3:6, 12:15]
    dv_dba = J[..., 6:9, 9:12]
    dv_dbg = J[..., 6:9, 12:15]

    dba = (Bai - state.linearized_ba)[..., None]
    dbg = (Bgi - state.linearized_bg)[..., None]

    corrected_q = lie.quat_mul(state.delta_q, lie.delta_q((dq_dbg @ dbg)[..., 0]))
    corrected_v = state.delta_v + (dv_dba @ dba + dv_dbg @ dbg)[..., 0]
    corrected_p = state.delta_p + (dp_dba @ dba + dp_dbg @ dbg)[..., 0]

    sdt = state.sum_dt[..., None]
    Qi_inv = lie.quat_conj(Qi)
    r_p = lie.quat_rotate(Qi_inv, 0.5 * g * sdt * sdt + Pj - Pi - Vi * sdt) - corrected_p
    r_q = 2.0 * lie.quat_mul(lie.quat_conj(corrected_q),
                             lie.quat_mul(Qi_inv, Qj))[..., :3]
    r_v = lie.quat_rotate(Qi_inv, g * sdt + Vj - Vi) - corrected_v
    return torch.cat([r_p, r_q, r_v, Baj - Bai, Bgj - Bgi], dim=-1)


def preintegrate_batch(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                       exact_noise: bool = True) -> PreintState:
    """Preintegration over window slots: (W, M) buffers → batched state.
    ``preintegrate`` is already batched, so this is the same call."""
    return preintegrate(dts, accs, gyrs, mask, acc0, gyr0, ba, bg, noise_d,
                        exact_noise)
