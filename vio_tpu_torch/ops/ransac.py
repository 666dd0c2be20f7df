"""The 8-point RANSAC of the essential matrix: hand-written CUDA kernels.

``init/sfm.py::essential_ransac`` scores ``n_hyp`` minimal 8-point
samples and refits E on the best one's consensus set.  ``vio_tpu`` runs
that as one jitted program whose SVDs XLA compiles
(``vio_tpu/init/sfm.py:172``); here ``sweep`` and ``refit_best`` (the
refit with the choice of the best hypothesis and its consensus set folded
in) send CUDA tensors to ``csrc/essential_ransac.cu`` and CPU tensors to
their plain versions, ``sweep_reference`` and ``refit_best_reference``
(the batched ``torch.linalg.svd`` that the port ran on every device
before the kernels).  ``refit`` (``refit_reference``) refits a system the
caller weighs.  None falls back to its plain version.  The kernels launch
on the current stream and do not synchronise, so they can be captured
into a CUDA graph; ``torch.linalg.svd`` on the card cannot (it reads
cuSOLVER's ``info`` back to the host).

All take correspondences x0, x1 (N, 2) in normalised coordinates and a
mask ``valid`` (N,); rows outside ``valid`` count as zero rows, whatever
they hold (the tracker passes the lifts of failed tracks, which can be
NaN).  E's sign is arbitrary, in both versions.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

# The most rows a refit takes (essential_ransac.cu's kMaxRefitN): one
# block walks them all, ten chunks of rows a warp at most.
MAX_REFIT_N = 2048


def eight_point(x0, x1, w):
    """Weighted least-squares E from correspondences (N,2)+(N,2) with
    weights w (..., N), batched over w's leading dims."""
    a = torch.stack([
        x1[:, 0] * x0[:, 0], x1[:, 0] * x0[:, 1], x1[:, 0],
        x1[:, 1] * x0[:, 0], x1[:, 1] * x0[:, 1], x1[:, 1],
        x0[:, 0], x0[:, 1], torch.ones_like(x0[:, 0]),
    ], dim=-1) * w[..., None]                                   # (..., N, 9)
    _, _, Vt = torch.linalg.svd(a, full_matrices=False)
    E = Vt[..., -1, :].reshape(w.shape[:-1] + (3, 3))
    # project onto the essential manifold (rank 2, equal singular values)
    U, _, Vt2 = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * d) @ Vt2


def epipolar_err(E, x0, x1):
    """Sampson distance of normalized correspondences to E (..., 3, 3)."""
    h0 = torch.cat([x0, torch.ones_like(x0[:, :1])], -1)
    h1 = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)
    Ex0 = h0 @ E.transpose(-1, -2)                              # (..., N, 3)
    Etx1 = h1 @ E
    num = torch.sum(h1 * Ex0, dim=-1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-30)


def masked(x0, x1, valid):
    """x0, x1 with the rows outside ``valid`` zeroed."""
    return (torch.where(valid[:, None], x0, 0.0),
            torch.where(valid[:, None], x1, 0.0))


def sweep_reference(x0, x1, valid, idx, thresh):
    """Plain version of ``sweep``: E of every sample idx (n_hyp, 8) by the
    SVD of its (N, 9) weighted system, and its inlier count.  Returns
    (Es (n_hyp, 3, 3), counts (n_hyp,) int64)."""
    x0, x1 = masked(x0, x1, valid)
    w = torch.zeros((idx.shape[0], x0.shape[0]), dtype=x0.dtype, device=x0.device)
    w.scatter_(1, idx, 1.0)
    w = w * valid
    Es = eight_point(x0, x1, w)
    inl = (epipolar_err(Es, x0, x1) < thresh * thresh) & valid
    return Es, torch.sum(inl, dim=-1)


def refit_reference(x0, x1, valid, w, thresh):
    """Plain version of ``refit``: E of the weighted system (weights w
    (N,)), its inlier mask and count.  Returns (E (3, 3), inl (N,), count
    () int64)."""
    x0, x1 = masked(x0, x1, valid)
    E = eight_point(x0, x1, w)
    inl = (epipolar_err(E, x0, x1) < thresh ** 2) & valid
    return E, inl, torch.sum(inl)


def refit_best_reference(x0, x1, valid, Es, counts, thresh):
    """Plain version of ``refit_best``: the first hypothesis with the
    largest count (``torch.argmax``), the valid rows within ``thresh`` of
    its E, then ``refit_reference`` on them.  Returns (E (3, 3), inl (N,),
    count () int64)."""
    best = torch.argmax(counts)
    E0 = torch.index_select(Es, 0, best.reshape(1))[0]
    xm0, xm1 = masked(x0, x1, valid)
    inl = (epipolar_err(E0, xm0, xm1) < thresh ** 2) & valid
    return refit_reference(x0, x1, valid, inl.to(x0.dtype), thresh)


def _check(x0, x1, valid, name):
    if not (x0.is_cuda and x1.is_cuda and valid.is_cuda
            and x0.device == x1.device == valid.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x0.dtype != x1.dtype or x0.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name} takes float32 or float64, got {x0.dtype}/{x1.dtype}")
    N = x0.shape[0]
    if x0.shape != (N, 2) or x1.shape != (N, 2) or valid.shape != (N,) or N < 1:
        raise ValueError(f"{name} shapes: x0 {tuple(x0.shape)}, x1 {tuple(x1.shape)}, "
                         f"valid {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise ValueError(f"{name}: valid must be bool, not {valid.dtype}")
    return x0.contiguous(), x1.contiguous(), valid.contiguous()


def _check_null(null_out, shape, x0, name) -> None:
    if null_out is not None and (null_out.shape != shape or null_out.dtype != x0.dtype
                                 or null_out.device != x0.device
                                 or not null_out.is_contiguous()):
        raise ValueError(f"{name}: null_out must be a contiguous {shape} {x0.dtype} tensor "
                         f"on {x0.device}")


def _scalar(dtype):
    return ctypes.c_float if dtype == torch.float32 else ctypes.c_double


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _count(fn) -> None:
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1      # recorded, not run: each replay launches it
    else:
        fn.launches += 1


def _raise(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.gj_solve_error_string(rc).decode()})")


@_build.counted
def sweep(x0, x1, valid, idx, thresh, null_out=None):
    """E (n_hyp, 3, 3) of every 8-point sample idx (n_hyp, 8) (the null
    vector of its 8 × 9 system, projected onto the essential manifold) and
    its inlier count (n_hyp,) int64 under the Sampson threshold ``thresh``
    (normalised units).  The kernel on CUDA tensors, ``sweep_reference``
    on CPU tensors.  On the card, ``null_out`` (n_hyp, 9), when given,
    receives each sample's unit null vector before its projection, so that
    a caller can hold the kernel's backward error."""
    if not x0.is_cuda:
        return sweep_reference(x0, x1, valid, idx, thresh)
    x0, x1, valid = _check(x0, x1, valid, "ransac.sweep")
    n_hyp = idx.shape[0]
    if (not idx.is_cuda or idx.device != x0.device or idx.dtype != torch.int64
            or idx.shape != (n_hyp, 8) or n_hyp < 1):
        raise ValueError(f"ransac.sweep: idx must be (n_hyp, 8) int64 on {x0.device}, "
                         f"got {tuple(idx.shape)} {idx.dtype} on {idx.device}")
    _check_null(null_out, (n_hyp, 9), x0, "ransac.sweep")
    idx = idx.contiguous()
    lib = _build.load()
    E = torch.empty((n_hyp, 3, 3), dtype=x0.dtype, device=x0.device)
    count = torch.empty((n_hyp,), dtype=torch.int64, device=x0.device)
    fn = lib.essential_sweep_f32 if x0.dtype == torch.float32 else lib.essential_sweep_f64
    with torch.cuda.device(x0.device):
        rc = fn(x0.data_ptr(), x1.data_ptr(), valid.data_ptr(), idx.data_ptr(),
                x0.shape[0], n_hyp, _scalar(x0.dtype)(thresh * thresh), E.data_ptr(),
                count.data_ptr(), None if null_out is None else null_out.data_ptr(),
                _stream(x0.device))
    _raise(lib, rc, "ransac.sweep")
    _count(sweep)
    return E, count


def _refit_outputs(x0, N):
    return (torch.empty((3, 3), dtype=x0.dtype, device=x0.device),
            torch.empty((N,), dtype=torch.bool, device=x0.device),
            torch.empty((), dtype=torch.int64, device=x0.device))


def _check_rows(N, name) -> None:
    if N > MAX_REFIT_N:
        raise ValueError(f"{name} takes at most {MAX_REFIT_N} rows (MAX_REFIT_N), got {N}")


@_build.counted
def refit(x0, x1, valid, w, thresh, null_out=None):
    """E (3, 3) of the weighted (N, 9) system (weights w (N,)), its inlier
    mask (N,) and count () int64 under ``thresh``.  The kernel on CUDA
    tensors (N ≤ MAX_REFIT_N, or it raises), ``refit_reference`` on CPU
    tensors.  On the card, ``null_out`` (9,), when given, receives the
    system's unit null vector before its projection."""
    if not x0.is_cuda:
        return refit_reference(x0, x1, valid, w, thresh)
    x0, x1, valid = _check(x0, x1, valid, "ransac.refit")
    N = x0.shape[0]
    _check_rows(N, "ransac.refit")
    if w.shape != (N,) or w.dtype != x0.dtype or w.device != x0.device:
        raise ValueError(f"ransac.refit: w must be ({N},) {x0.dtype} on {x0.device}")
    _check_null(null_out, (9,), x0, "ransac.refit")
    w = w.contiguous()
    lib = _build.load()
    E, inl, count = _refit_outputs(x0, N)
    fn = lib.essential_refit_f32 if x0.dtype == torch.float32 else lib.essential_refit_f64
    with torch.cuda.device(x0.device):
        rc = fn(x0.data_ptr(), x1.data_ptr(), valid.data_ptr(), w.data_ptr(), N,
                _scalar(x0.dtype)(thresh ** 2), E.data_ptr(), inl.data_ptr(),
                count.data_ptr(), None if null_out is None else null_out.data_ptr(),
                _stream(x0.device))
    _raise(lib, rc, "ransac.refit")
    _count(refit)
    return E, inl, count


@_build.counted
def refit_best(x0, x1, valid, Es, counts, thresh, null_out=None):
    """``refit`` on the consensus set of the best hypothesis, in one
    launch: the first of the largest ``counts`` (n_hyp,) int64, the valid
    rows whose Sampson error under its E (of ``Es`` (n_hyp, 3, 3)) is below
    ``thresh`` (in the input type) weighing 1, the others 0.  Returns (E
    (3, 3), inl (N,), count () int64).  The kernel on CUDA tensors (N ≤
    MAX_REFIT_N, or it raises), ``refit_best_reference`` on CPU tensors;
    ``null_out`` as ``refit``'s."""
    if not x0.is_cuda:
        return refit_best_reference(x0, x1, valid, Es, counts, thresh)
    x0, x1, valid = _check(x0, x1, valid, "ransac.refit_best")
    N, n_hyp = x0.shape[0], Es.shape[0]
    _check_rows(N, "ransac.refit_best")
    if (Es.shape != (n_hyp, 3, 3) or Es.dtype != x0.dtype or Es.device != x0.device
            or n_hyp < 1 or counts.shape != (n_hyp,) or counts.dtype != torch.int64
            or counts.device != x0.device):
        raise ValueError(f"ransac.refit_best: Es must be (n_hyp, 3, 3) {x0.dtype} and counts "
                         f"(n_hyp,) int64 on {x0.device}, got {tuple(Es.shape)} {Es.dtype} "
                         f"on {Es.device}, {tuple(counts.shape)} {counts.dtype} on "
                         f"{counts.device}")
    _check_null(null_out, (9,), x0, "ransac.refit_best")
    Es, counts = Es.contiguous(), counts.contiguous()
    lib = _build.load()
    E, inl, count = _refit_outputs(x0, N)
    fn = (lib.essential_refit_best_f32 if x0.dtype == torch.float32
          else lib.essential_refit_best_f64)
    with torch.cuda.device(x0.device):
        rc = fn(x0.data_ptr(), x1.data_ptr(), valid.data_ptr(), Es.data_ptr(),
                counts.data_ptr(), n_hyp, N, _scalar(x0.dtype)(thresh ** 2), E.data_ptr(),
                inl.data_ptr(), count.data_ptr(),
                None if null_out is None else null_out.data_ptr(), _stream(x0.device))
    _raise(lib, rc, "ransac.refit_best")
    _count(refit_best)
    return E, inl, count


def launches() -> int:
    """The kernels' launches so far: sweeps, refits and best refits."""
    return sweep.launches + refit.launches + refit_best.launches


# ---------------------------------------------------------------------------
# Accuracy, on the host in float64.  What the kernel's E is held to: its
# null vector's backward error and its projection's, each at most
# BACKWARD_C · eps of its type, whatever the sample's condition (a
# Householder reflection's or a Jacobi rotation's backward error is O(eps);
# a sample takes 8 reflections, a refit's triangle a few sweeps of 9 steps
# after its QR, each in double).  The tracker's minimal
# samples have κ ~ 1e4-1e5, so a backward-stable E is bounded in float32
# only to eps·κ ~ 1e-2; what tells a kernel from its plain version there is
# how far each lands from the float64 answer (chip_smoke.py, phase 23).
# ---------------------------------------------------------------------------

BACKWARD_C = 64


def design_rows(x0, x1):
    """The 8-point design rows (N, 9) of host float64 correspondences."""
    return np.stack([x1[:, 0] * x0[:, 0], x1[:, 0] * x0[:, 1], x1[:, 0],
                     x1[:, 1] * x0[:, 0], x1[:, 1] * x0[:, 1], x1[:, 1],
                     x0[:, 0], x0[:, 1], np.ones(len(x0))], axis=-1)


def e_condition(A):
    """κ of E from the system A (..., M, 9) in float64: the
    smallest-singular-vector sensitivity σ1/(σ8 − σ9) (σ9 = 0 for 8 rows)
    times 1 + 1/σ2 of the unit-norm E it gives.  To first order, E's
    error in a type is at most a small multiple of eps·κ."""
    _, s, Vt = np.linalg.svd(A, full_matrices=True)
    s9 = s[..., 8] if s.shape[-1] > 8 else 0.0
    E = Vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    sE = np.linalg.svd(E, compute_uv=False)
    with np.errstate(divide="ignore", invalid="ignore"):
        return s[..., 0] / (s[..., 7] - s9) * (1.0 + 1.0 / sE[..., 1])


def null_backward(A, e):
    """Backward error of the null vectors e (H, 9) of the systems A (H, M,
    9), in float64: (‖A ê‖ − σ_min(A)) / ‖A‖_F, ê = e / ‖e‖ (σ_min = 0 for
    M = 8).  A backward-stable null vector gives at most a few eps,
    whatever A's condition."""
    e = e / np.linalg.norm(e, axis=-1, keepdims=True)
    r = np.linalg.norm(np.einsum("hmk,hk->hm", A, e), axis=-1)
    s = np.linalg.svd(A, compute_uv=False)
    s_min = s[..., 8] if s.shape[-1] > 8 else 0.0
    return (r - s_min) / np.linalg.norm(A, axis=(-2, -1))


def projection_backward(e, E):
    """How far E (H, 3, 3) is from the projection onto the essential
    manifold (u1 v1ᵀ + u2 v2ᵀ) of the null vector e (H, 9), as a backward
    error of unit ê, in float64.  E = U2 V2ᵀ is that projection iff its
    singular values are (1, 1, 0) (E Eᵀ a projector of trace 2, det E = 0),
    ê has no part in the blocks that the frames (U2, u3) × (V2, v3) leave
    off the diagonal (P_U = E Eᵀ, P_V = Eᵀ E), U2ᵀ ê V2 is symmetric
    positive semi-definite (so is Eᵀ ê P_V) and the part u3ᵀ ê v3 left out
    is no larger than its least eigenvalue.  Returns the largest violation
    of these, each none of ê's condition.  Products only: LAPACK's float64
    SVD of these 3 × 3 matrices has a backward error of up to ~35 eps
    itself."""
    e = (e / np.linalg.norm(e, axis=-1, keepdims=True)).reshape(-1, 3, 3)
    T = lambda m: np.swapaxes(m, -1, -2)          # noqa: E731
    I = np.eye(3)
    PU, PV = E @ T(E), T(E) @ E
    manifold = np.maximum(np.abs(PU @ PU - PU).max(axis=(-2, -1)),
                          np.maximum(np.abs(np.trace(PU, axis1=-2, axis2=-1) - 2.0),
                                     np.abs(np.linalg.det(E))))
    dropped = (I - PU) @ e @ (I - PV)
    off = np.linalg.norm(e - PU @ e @ PV - dropped, axis=(-2, -1))
    M = T(E) @ e @ PV
    # U2ᵀ ê V2's eigenvalues, and 2 along v3 (above both: ‖ê‖ = 1)
    lam = np.linalg.eigvalsh(0.5 * (M + T(M)) + 2.0 * (I - PV))[..., 0]
    return np.max(np.stack([
        manifold, off, np.abs(M - T(M)).max(axis=(-2, -1)), np.maximum(-lam, 0.0),
        np.maximum(np.linalg.norm(dropped, axis=(-2, -1)) - lam, 0.0)]), axis=0)
