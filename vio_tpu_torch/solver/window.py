"""Sliding-window BA problem in structure-of-arrays form + GEMM assembly.

Port of ``vio_tpu/solver/window.py`` (reference: vins-mono/src/backend/
problem.cc:303-389 MakeHessian).  Every reprojection factor lives on a
dense ``(F, W+1)`` grid with a validity mask; per-factor Jacobians are
expanded over the frame axis with one-hot outer products and the pose
Hessian is one ``JᵀWJ`` matmul.  The landmark block is diagonal.  The
IMU factors' block (``imu_factor``) is, on CUDA tensors, one launch of a
hand-written kernel (``imu_factor_kernel``, ``csrc/imu_factor.cu``) an
assembly and, on CPU tensors, its plain version ``imu_factor_reference``.

Pose-parameter packing (P = 6 + 15·(W+1)):
  [ext(0:6) | frame k: pose(6+15k : 12+15k), speedbias(12+15k : 21+15k)]
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import factors
from ..ops import _build
from ..utils import lie


class WindowStates(NamedTuple):
    """Optimizable states (the vertices)."""
    ext_t: torch.Tensor   # (3,)
    ext_q: torch.Tensor   # (4,)
    Ps: torch.Tensor      # (W1, 3)
    Qs: torch.Tensor      # (W1, 4)
    Vs: torch.Tensor      # (W1, 3)
    Bas: torch.Tensor     # (W1, 3)
    Bgs: torch.Tensor     # (W1, 3)
    inv_dep: torch.Tensor # (F,)


class WindowFactors(NamedTuple):
    """Static-shape factor data (the edges)."""
    imu_terms: factors.ImuFactorTerms  # batched (W,)
    imu_valid: torch.Tensor            # (W,) bool
    pts_i: torch.Tensor      # (F, 3) bearing in the start (host) frame
    pts_j: torch.Tensor      # (F, W1, 3) bearing per observing frame
    start: torch.Tensor      # (F,) int64 start frame index
    obs_mask: torch.Tensor   # (F, W1) bool; False at j == start and invalid
    feat_valid: torch.Tensor # (F,) bool — feature participates in the solve
    H_prior: torch.Tensor    # (P, P)
    b_prior: torch.Tensor    # (P,)
    err_prior: torch.Tensor      # (P,) active in first P-15 entries
    Jt_prior_inv: torch.Tensor   # (P, P) active in top-left (P-15)²
    g: torch.Tensor          # (3,) gravity (0, 0, +g_norm)
    proj_sqrt_info: torch.Tensor  # () focal/1.5


def _one_hot(idx, n: int, dtype):
    """One-hot rows of ``idx`` over n classes, built by comparison so no
    bounds check syncs with the host on CUDA."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def num_pose_params(window_size: int) -> int:
    return 6 + 15 * (window_size + 1)


def pose_plus(Ps, Qs, dp, dtheta):
    """Batched right-multiplicative pose update (vertex_pose.cc:7-19)."""
    return Ps + dp, lie.quat_normalize(lie.quat_mul(Qs, lie.so3_exp_quat(dtheta)))


def apply_delta(states: WindowStates, delta_pose, delta_lm) -> WindowStates:
    """Apply a packed local update (UpdateStates, problem.cc:453-463)."""
    W1 = states.Ps.shape[0]
    d_ext = delta_pose[0:6]
    d_frames = delta_pose[6:].reshape(W1, 15)
    ext_t, ext_q = pose_plus(states.ext_t, states.ext_q, d_ext[:3], d_ext[3:6])
    Ps, Qs = pose_plus(states.Ps, states.Qs, d_frames[:, 0:3], d_frames[:, 3:6])
    return WindowStates(
        ext_t=ext_t, ext_q=ext_q, Ps=Ps, Qs=Qs,
        Vs=states.Vs + d_frames[:, 6:9],
        Bas=states.Bas + d_frames[:, 9:12],
        Bgs=states.Bgs + d_frames[:, 12:15],
        inv_dep=states.inv_dep + delta_lm,
    )


# ---------------------------------------------------------------------------
# Residual / chi² evaluation (no Jacobians)
# ---------------------------------------------------------------------------

def _safe_inv_dep(states: WindowStates, f: WindowFactors):
    """Inverse depths with masked-out features clamped to 1.0 — a padded
    slot's 1/0 would otherwise produce inf, and inf·mask(0) = NaN poisons
    the Hessian GEMMs even though chi² itself is masked."""
    return torch.where(f.feat_valid, states.inv_dep,
                       torch.ones_like(states.inv_dep))


def _grid_obs(states: WindowStates, f: WindowFactors):
    """Per-cell arguments of the reprojection factor on the (F, W1) grid."""
    F, W1 = f.obs_mask.shape
    inv = _safe_inv_dep(states, f)[:, None].expand(F, W1)
    Pi = states.Ps[f.start][:, None].expand(F, W1, 3)
    Qi = states.Qs[f.start][:, None].expand(F, W1, 4)
    pts_i = f.pts_i[:, None].expand(F, W1, 3)
    Pj = states.Ps[None].expand(F, W1, 3)
    Qj = states.Qs[None].expand(F, W1, 4)
    return inv, Pi, Qi, Pj, Qj, states.ext_t, states.ext_q, pts_i, f.pts_j


def _reproj_residuals(states: WindowStates, f: WindowFactors):
    """All reprojection residuals on the (F, W1) grid → (F, W1, 2)."""
    return factors.reproj_residual(*_grid_obs(states, f))


def feature_reproj_errors(states: WindowStates, f: WindowFactors):
    """Mean reprojection error per feature over its observed frames, in
    normalized-plane units (F,).  Drives post-solve outlier rejection
    (the full VINS-Mono's FeatureManager::removeOutlier)."""
    r = _reproj_residuals(states, f)                    # (F, W1, 2)
    e = torch.linalg.norm(r, dim=-1)                    # (F, W1)
    m = f.obs_mask & f.feat_valid[:, None]
    n = torch.clamp(torch.sum(m, dim=1), min=1)
    return torch.sum(torch.where(m, e, torch.zeros_like(e)), dim=1) / n


def _imu_args(states: WindowStates, f: WindowFactors):
    W1 = states.Ps.shape[0]
    i = slice(0, W1 - 1)
    j = slice(1, W1)
    return (f.imu_terms, f.g,
            states.Ps[i], states.Qs[i], states.Vs[i], states.Bas[i], states.Bgs[i],
            states.Ps[j], states.Qs[j], states.Vs[j], states.Bas[j], states.Bgs[j])


def _imu_residuals(states: WindowStates, f: WindowFactors):
    """(W, 15) IMU residuals for intervals k → k+1."""
    return factors.imu_residual(*_imu_args(states, f))


def _imu_infos(f: WindowFactors):
    """(W, 15, 15) information = covariance⁻¹ (edge_imu.cc:35).  solve_ex
    leaves a singular covariance's result non-finite, as jnp.linalg.solve
    does, instead of syncing with the host to raise."""
    C = f.imu_terms.covariance
    eye = torch.eye(15, dtype=C.dtype, device=C.device).expand(C.shape)
    infos = torch.linalg.solve_ex(C, eye)[0]
    # the solver returns column-major matrices; the kernel reads rows (the
    # CPU's plain einsums keep the solver's layout, and so their bits)
    return infos.contiguous() if infos.is_cuda else infos


# ---------------------------------------------------------------------------
# The IMU factors' block of the normal equations: a CUDA kernel
# (csrc/imu_factor.cu) on the card, its plain version on the CPU
# ---------------------------------------------------------------------------

def imu_factor_reference(states: WindowStates, f: WindowFactors, infos, Hpp, bp, chi):
    """The kernel's plain version: the IMU factors' residuals and Jacobians
    (edge_imu.cc), J expanded densely over the window's pose parameters,
    and JᵀΩJ, −JᵀΩr and rᵀΩr added to Hpp, bp and chi (new tensors).
    Intervals whose ``imu_valid`` is False add nothing."""
    W1 = states.Ps.shape[0]
    dtype = states.Ps.dtype
    kw = dict(dtype=dtype, device=states.Ps.device)
    eyeW = torch.eye(W1, **kw)
    imu_args = _imu_args(states, f)
    ir = factors.imu_residual(*imu_args)
    Jpi_m, Jsbi_m, Jpj_m, Jsbj_m = factors.imu_jacobians(*imu_args)

    W = W1 - 1
    imu_m = f.imu_valid.to(dtype)
    Ji = torch.cat([Jpi_m, Jsbi_m], dim=-1)                         # (W, 15, 15)
    Jj = torch.cat([Jpj_m, Jsbj_m], dim=-1)
    Jfr = (torch.einsum("wab,wk->wakb", Ji, eyeW[:W]) +
           torch.einsum("wab,wk->wakb", Jj, eyeW[1:])).reshape(W, 15, W1 * 15)
    Jimu = torch.cat([torch.zeros((W, 15, 6), **kw), Jfr], dim=-1)
    Jimu = Jimu * imu_m[:, None, None]

    WJi = torch.einsum("wrs,wsp->wrp", infos, Jimu)
    Hpp = Hpp + torch.einsum("wrp,wrq->pq", Jimu, WJi)
    info_ir = torch.einsum("wrs,ws->wr", infos, ir) * imu_m[:, None]
    bp = bp - torch.einsum("wrp,wr->p", Jimu, info_ir)
    imu_chi = torch.einsum("wr,wr->w", ir, info_ir)
    chi = chi + torch.sum(torch.where(f.imu_valid, imu_chi, torch.zeros_like(imu_chi)))
    return Hpp, bp, chi


@_build.counted
def imu_factor_kernel(terms: factors.ImuFactorTerms, g, Ps, Qs, Vs, Bas, Bgs,
                      imu_valid, infos, Hpp, bp, chi) -> None:
    """``imu_factor_reference`` as one launch of ``csrc/imu_factor.cu`` on
    the current stream, without synchronising: updates Hpp (P, P), bp (P,)
    and chi () IN PLACE, P = 6 + 15 (W + 1).  Takes contiguous float32 or
    float64 CUDA tensors on one device (imu_valid bool): the W ≥ 1
    intervals' terms (the covariance unused), g (3,), the W + 1 frames'
    Ps, Vs, Bas, Bgs (W + 1, 3) and Qs (W + 1, 4), the information
    ``infos`` (W, 15, 15); raises on anything else (types, shapes and
    layout checked first, then the device, all before any build), on a
    build failure and on a refused launch.  An interval whose
    ``imu_valid`` is False is skipped, where the plain version multiplies
    it by 0."""
    floats = (terms.delta_p, terms.delta_q, terms.delta_v, terms.jacobian, terms.sum_dt,
              terms.linearized_ba, terms.linearized_bg, g, Ps, Qs, Vs, Bas, Bgs, infos,
              Hpp, bp, chi)
    dtype = Hpp.dtype
    if (dtype not in (torch.float32, torch.float64) or imu_valid.dtype != torch.bool
            or any(t.dtype != dtype for t in floats)):
        raise ValueError(f"imu_factor_kernel takes float32 or float64 and a bool mask, "
                         f"got {[t.dtype for t in (*floats, imu_valid)]}")
    W1 = Ps.shape[0] if Ps.dim() == 2 else 0
    W, P = W1 - 1, num_pose_params(W1 - 1)
    want = ((W, 3), (W, 4), (W, 3), (W, 15, 15), (W,), (W, 3), (W, 3), (3,),
            (W1, 3), (W1, 4), (W1, 3), (W1, 3), (W1, 3), (W, 15, 15), (P, P), (P,), (),
            (W,))
    got = tuple(tuple(t.shape) for t in (*floats, imu_valid))
    if W < 1 or got != want:
        raise ValueError(f"imu_factor_kernel shapes: {got}, expected {want} (W >= 1)")
    if not all(t.is_contiguous() for t in (*floats, imu_valid)):
        raise ValueError("imu_factor_kernel takes contiguous tensors")
    if not all(t.is_cuda and t.device == Hpp.device for t in (*floats, imu_valid)):
        raise ValueError("imu_factor_kernel takes CUDA tensors on one device")
    lib = _build.load()
    fn = lib.imu_factor_f32 if dtype == torch.float32 else lib.imu_factor_f64
    with torch.cuda.device(Hpp.device):
        stream = torch.cuda.current_stream(Hpp.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in (*floats[:13], imu_valid, *floats[13:])),
                W, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"imu_factor launch failed: CUDA error {rc} "
                           f"({lib.gj_solve_error_string(rc).decode()})")
    if torch.cuda.is_current_stream_capturing():
        imu_factor_kernel.captured += 1   # recorded, not run: each replay launches it
    else:
        imu_factor_kernel.launches += 1


def imu_factor(states: WindowStates, f: WindowFactors, infos, Hpp, bp, chi):
    """The IMU factors' terms added into the normal equations: on CUDA
    tensors one launch of the kernel, which updates Hpp, bp and chi in
    place (they are returned); on CPU tensors its plain version."""
    if not Hpp.is_cuda:
        return imu_factor_reference(states, f, infos, Hpp, bp, chi)
    imu_factor_kernel(f.imu_terms, f.g, states.Ps, states.Qs, states.Vs, states.Bas,
                      states.Bgs, f.imu_valid, infos, Hpp, bp, chi)
    return Hpp, bp, chi


def robust_chi2(states: WindowStates, f: WindowFactors,
                loss_delta: float = 1.0, imu_infos=None):
    """0.5 · (Σ robust chi² over edges + ‖err_prior‖)
    (reference problem.cc:497-507 / 549-556)."""
    rr = _reproj_residuals(states, f)
    e2 = f.proj_sqrt_info ** 2 * torch.sum(rr * rr, dim=-1)
    rho0, _, _ = factors.cauchy_rho(e2, loss_delta)
    m = f.obs_mask & f.feat_valid[:, None]
    chi = torch.sum(torch.where(m, rho0, torch.zeros_like(rho0)))

    ir = _imu_residuals(states, f)
    infos = _imu_infos(f) if imu_infos is None else imu_infos
    imu_e2 = torch.einsum("wr,wrs,ws->w", ir, infos, ir)
    chi = chi + torch.sum(torch.where(f.imu_valid, imu_e2, torch.zeros_like(imu_e2)))

    # the reference adds the UNsquared prior norm; reproduced, not fixed
    chi = chi + torch.linalg.norm(f.err_prior)
    return 0.5 * chi


# ---------------------------------------------------------------------------
# Hessian assembly (MakeHessian, problem.cc:303-389)
# ---------------------------------------------------------------------------

class Normal(NamedTuple):
    """Block normal equations with diagonal landmark block."""
    Hpp: torch.Tensor   # (P, P)
    bp: torch.Tensor    # (P,)
    Hpm: torch.Tensor   # (P, F)
    Hmm: torch.Tensor   # (F,)
    bm: torch.Tensor    # (F,)
    chi2: torch.Tensor  # () current robust chi² (0.5-scaled)


def live_index(flat, n_obs: int):
    """Fixed-size index of the first ``n_obs`` True entries of ``flat``,
    padded with 0, and the live count — ``jnp.nonzero(flat, size=n_obs,
    fill_value=0)`` without a host sync: each live entry's rank comes from
    a cumsum and is scattered into its slot; entries past the cap (and the
    dead ones) land in a discarded overflow slot, so overflow keeps the
    prefix."""
    rank = torch.cumsum(flat.to(torch.int64), 0) - 1
    slot = torch.where(flat & (rank < n_obs), rank, torch.full_like(rank, n_obs))
    buf = torch.zeros(n_obs + 1, dtype=torch.int64, device=flat.device)
    buf.scatter_(0, slot, torch.arange(flat.shape[0], device=flat.device))
    return buf[:n_obs], torch.sum(flat)


def _robust_info(r, s2, sqrt_info, loss_delta, eye2):
    """Cauchy-weighted information (edge.cc RobustInfo) and its rho terms."""
    e2 = s2 * torch.sum(r * r, dim=-1)
    rho0, rho1, rho2 = factors.cauchy_rho(e2, loss_delta)
    w_err = sqrt_info * r
    guard = (rho1 + 2.0 * rho2 * e2 > 0.0).to(r.dtype)
    # robust_info = (rho1·I + guard·2·rho2·w_err w_errᵀ) · (s²·I)
    rinfo = (rho1[..., None, None] * eye2 +
             (guard * 2.0 * rho2)[..., None, None] *
             (w_err[..., :, None] * w_err[..., None, :])) * s2
    return rinfo, rho0, rho1


def assemble(states: WindowStates, f: WindowFactors,
             fix_ext: bool = True, loss_delta: float = 1.0,
             imu_infos=None, n_obs: int | None = None) -> Normal:
    """imu_infos: optional precomputed (W, 15, 15) information matrices
    (constant across LM iterations).

    n_obs: optional live-observation cap.  When set, the (F, W1) grid is
    compacted to the first n_obs live cells (``live_index``) before
    Jacobian evaluation, so the JᵀWJ GEMM scales with live factors; live
    cells beyond the cap are dropped (the prefix is kept).  None keeps the
    exact dense-grid path."""
    W1 = states.Ps.shape[0]
    F = states.inv_dep.shape[0]
    P = num_pose_params(W1 - 1)
    dtype = states.Ps.dtype
    kw = dict(dtype=dtype, device=states.Ps.device)

    ext_scale = 0.0 if fix_ext else 1.0
    s2 = f.proj_sqrt_info ** 2
    eye2 = torch.eye(2, **kw)
    eyeW = torch.eye(W1, **kw)

    if n_obs is None:
        # ---------------- reprojection factors: dense (F, W1) grid ------
        args = _grid_obs(states, f)
        r = factors.reproj_residual(*args)
        Jd, Jpi, Jpj, Jext = factors.reproj_jacobians(*args)
        # shapes: r (F,W1,2), Jd (F,W1,2,1), Jpi/Jpj/Jext (F,W1,2,6)
        mask = (f.obs_mask & f.feat_valid[:, None]).to(dtype)       # (F, W1)
        rinfo, rho0, rho1 = _robust_info(r, s2, f.proj_sqrt_info, loss_delta, eye2)

        onehot_i = _one_hot(f.start, W1, dtype)              # (F, W1)
        Jframes6 = (torch.einsum("fjab,fk->fjakb", Jpi, onehot_i) +
                    torch.einsum("fjab,jk->fjakb", Jpj, eyeW))      # (F,W1,2,W1,6)
        Jframes = torch.zeros((F, W1, 2, W1, 15), **kw)
        Jframes[..., 0:6] = Jframes6
        Jfull = torch.cat(
            [Jext * ext_scale, Jframes.reshape(F, W1, 2, W1 * 15)], dim=-1)  # (F,W1,2,P)
        Jfull = Jfull * mask[..., None, None]

        WJ = torch.einsum("fjrs,fjsp->fjrp", rinfo, Jfull)
        Hpp = Jfull.reshape(F * W1 * 2, P).T @ WJ.reshape(F * W1 * 2, P)

        info_r = (s2 * rho1[..., None] * mask[..., None]) * r       # (F,W1,2)
        bp = -torch.einsum("fjrp,fjr->p", Jfull, info_r)

        Jd2 = Jd[..., 0] * mask[..., None]                          # (F,W1,2)
        WJd = torch.einsum("fjrs,fjs->fjr", rinfo, Jd2)
        Hpm = torch.einsum("fjrp,fjr->pf", Jfull, WJd)              # (P, F)
        Hmm = torch.einsum("fjr,fjr->f", Jd2, WJd)                  # (F,)
        bm = -torch.einsum("fjr,fjr->f", Jd2, info_r)

        chi = torch.sum(torch.where(mask > 0, rho0, torch.zeros_like(rho0)))
    else:
        # ------------- reprojection factors: compacted live list --------
        flat = (f.obs_mask & f.feat_valid[:, None]).reshape(-1)
        idx, cnt = live_index(flat, n_obs)
        fo = idx // W1
        jo = idx % W1
        ovalid = (torch.arange(n_obs, device=idx.device) < cnt).to(dtype)

        inv_all = _safe_inv_dep(states, f)
        args = (inv_all[fo], states.Ps[f.start[fo]], states.Qs[f.start[fo]],
                states.Ps[jo], states.Qs[jo], states.ext_t, states.ext_q,
                f.pts_i[fo], f.pts_j[fo, jo])
        r = factors.reproj_residual(*args)
        Jd, Jpi, Jpj, Jext = factors.reproj_jacobians(*args)
        # shapes: r (n_obs,2), Jd (n_obs,2,1), Jpi/Jpj/Jext (n_obs,2,6)
        rinfo, rho0, rho1 = _robust_info(r, s2, f.proj_sqrt_info, loss_delta, eye2)

        oh_i = _one_hot(f.start[fo], W1, dtype)              # (n_obs, W1)
        oh_j = _one_hot(jo, W1, dtype)
        Jframes6 = (torch.einsum("oab,ok->oakb", Jpi, oh_i) +
                    torch.einsum("oab,ok->oakb", Jpj, oh_j))        # (n_obs,2,W1,6)
        Jframes = torch.zeros((n_obs, 2, W1, 15), **kw)
        Jframes[..., 0:6] = Jframes6
        Jfull = torch.cat(
            [Jext * ext_scale, Jframes.reshape(n_obs, 2, W1 * 15)], dim=-1)  # (n_obs,2,P)
        Jfull = Jfull * ovalid[:, None, None]

        WJ = torch.einsum("ors,osp->orp", rinfo, Jfull)
        Hpp = Jfull.reshape(n_obs * 2, P).T @ WJ.reshape(n_obs * 2, P)

        info_r = (s2 * rho1[..., None] * ovalid[:, None]) * r       # (n_obs,2)
        bp = -torch.einsum("orp,or->p", Jfull, info_r)

        Jd2 = Jd[..., 0] * ovalid[:, None]                          # (n_obs,2)
        WJd = torch.einsum("ors,os->or", rinfo, Jd2)
        ohf = _one_hot(fo, F, dtype) * ovalid[:, None]       # (n_obs,F)
        Hpm = torch.einsum("orp,or->op", Jfull, WJd).T @ ohf        # (P, F)
        Hmm = ohf.T @ torch.einsum("or,or->o", Jd2, WJd)            # (F,)
        bm = -(ohf.T @ torch.einsum("or,or->o", Jd2, info_r))

        chi = torch.sum(rho0 * ovalid)

    # ---------------- IMU factors ----------------
    infos = _imu_infos(f) if imu_infos is None else imu_infos       # (W, 15, 15)
    Hpp, bp, chi = imu_factor(states, f, infos, Hpp, bp, chi)

    # ---------------- prior fold (problem.cc:365-384) ----------------
    free = torch.ones((P,), **kw)
    if fix_ext:
        free[0:6] = 0.0
    Hpp = Hpp + f.H_prior * free[:, None] * free[None, :]
    bp = bp + f.b_prior * free

    # the reference adds the UNsquared prior norm; reproduced, not fixed
    chi = chi + torch.linalg.norm(f.err_prior)
    return Normal(Hpp=Hpp, bp=bp, Hpm=Hpm, Hmm=Hmm, bm=bm, chi2=0.5 * chi)
