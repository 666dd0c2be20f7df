"""The port's photometric direct method (vio_tpu_torch/features/direct.py)
against the JAX package's, on tests/test_direct_ba.py's analytically
textured plane, CPU float64.

Tolerances: one assembly ≤ 1e-9 relative to each array's largest entry
(the Jacobian columns come from forward mode in both packages: ``jvp``
along the 9 unit tangents here, ``vmap(jacfwd)`` there); whole solves
take the same accept/reject path and agree to 1e-6 (chi² relative to its
first entry, states absolute).  The known-answer bounds are
tests/test_direct_ba.py's own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_direct_ba import _make_scene
from vio_tpu.features import direct as jdirect
from vio_tpu.utils import lie as jlie
from vio_tpu_torch import convert, sim
from vio_tpu_torch.features import direct as tdirect
from vio_tpu_torch.utils import lie

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _np(nt):
    return {k: (v if isinstance(v, tuple) else np.asarray(v))
            for k, v in zip(nt._fields, nt)}


def _close(actual, desired, rtol, atol, name):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, name
    err = np.abs(actual - desired).max(initial=0.0)
    bound = atol + rtol * np.abs(desired).max(initial=0.0)
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


@pytest.fixture(scope="module")
def scene():
    """tests/test_direct_ba.py::test_direct_ba_recovers_geometry's scene
    and perturbation: (gt, noisy)."""
    gt = _make_scene()
    rng = np.random.default_rng(1)
    C = gt.cam_q.shape[0]
    mask = (np.arange(C) >= 2).astype(np.float64)
    dth = 0.008 * rng.standard_normal((C, 3)) * mask[:, None]
    q_noisy = jax.vmap(jlie.quat_mul)(gt.cam_q,
                                      jax.vmap(jlie.so3_exp_quat)(jnp.asarray(dth)))
    noisy = gt._replace(
        cam_q=jlie.quat_normalize(q_noisy),
        cam_t=gt.cam_t + jnp.asarray(0.03 * rng.standard_normal((C, 3)) * mask[:, None]),
        points=gt.points + jnp.asarray(0.03 * rng.standard_normal(gt.points.shape)))
    return gt, noisy


@pytest.mark.parametrize("which", ["gt", "noisy"])
def test_direct_assemble_matches_jax(scene, which):
    p = dict(zip(("gt", "noisy"), scene))[which]
    C, M = p.cam_q.shape[0], p.points.shape[0]
    nj = jdirect._direct_assemble_j(p, C, M, 2, 40.0)
    nt = tdirect._direct_assemble(convert.direct_problem_from_numpy(_np(p), **CPU64),
                                  C, M, 2, 40.0)
    for name in nt._fields:
        _close(getattr(nt, name).numpy(), getattr(nj, name), 1e-9, 0.0, name)


def test_jvp_columns_match_jacfwd_per_observation(scene):
    """The batched jvp along the 9 unit tangents gives, for each
    observation, what ``torch.func.jacfwd`` of that observation's residual
    alone gives."""
    _, noisy = scene
    p = convert.direct_problem_from_numpy(_np(noisy), **CPU64)
    q, t, X, ref = (p.cam_q[p.cam_idx], p.cam_t[p.cam_idx], p.points[p.pt_idx],
                    p.ref_patch[p.pt_idx])
    _, J, _ = tdirect._photo_residual_jac(p.images, p.cam_idx, p.K, q, t, X, ref)
    for o in (0, 37, 81, 122, 159):
        sl = slice(o, o + 1)

        def h(z):
            qo = lie.quat_mul(q[sl], lie.so3_exp_quat(z[None, 0:3]))
            return tdirect._photo_residual(p.images, p.cam_idx[sl], p.K, qo,
                                           t[sl] + z[3:6], X[sl] + z[6:9], ref[sl])[0][0]

        Jo = torch.func.jacfwd(h)(torch.zeros(9, dtype=torch.float64))
        _close(J[o].numpy(), Jo.numpy(), 1e-12, 0.0, f"observation {o}")


def test_direct_ba_matches_jax_and_its_bounds(scene):
    gt, noisy = scene
    C, M = gt.cam_q.shape[0], gt.points.shape[0]
    oj, hj = jdirect.direct_ba(noisy, max_iter=30, gauge_fix=2)
    ot, ht = tdirect.direct_ba(convert.direct_problem_from_numpy(_np(noisy), **CPU64),
                               max_iter=30, gauge_fix=2, **CPU64)
    assert len(ht) == len(hj)
    _close(ht, hj, 1e-6, 0.0, "chi2 history")
    for field in ("cam_q", "cam_t", "points"):
        _close(getattr(ot, field).numpy(), getattr(oj, field), 0.0, 1e-6, field)
    # tests/test_direct_ba.py's bounds
    chi_gt = float(tdirect._direct_assemble(
        convert.direct_problem_from_numpy(_np(gt), **CPU64), C, M, 2, 40.0).chi2)
    assert ht[-1] < max(1.5 * chi_gt, 1e-3 * ht[0]), (ht[0], ht[-1], chi_gt)
    cam_err0 = np.linalg.norm(np.asarray(noisy.cam_t - gt.cam_t), axis=1)
    cam_err1 = np.linalg.norm(ot.cam_t.numpy() - np.asarray(gt.cam_t), axis=1)
    assert cam_err1[2:].max() < 0.3 * cam_err0[2:].max(), (cam_err0, cam_err1)
    pt_err0 = np.linalg.norm(np.asarray(noisy.points - gt.points), axis=1)
    pt_err1 = np.linalg.norm(ot.points.numpy() - np.asarray(gt.points), axis=1)
    assert np.median(pt_err1) < 0.3 * np.median(pt_err0)


@pytest.fixture(scope="module")
def frames():
    """tests/test_components.py::test_direct_method_recovers_motion's
    case: two rendered simulator frames, the depths of the landmarks seen
    in both, and the true relative pose X_1 = R X_0 + t."""
    data = sim.generate(noise=False)
    img0, img1 = (sim.render_image(data, k) for k in (0, 1))
    lids = np.where(data.obs_valid[0] & data.obs_valid[1])[0]
    uv0 = data.obs_uv[0][lids]
    depth0 = np.einsum("ji,lj->li", data.cam_R[0],
                       data.landmarks[lids] - data.cam_p[0])[:, 2]
    R_gt = data.cam_R[1].T @ data.cam_R[0]
    t_gt = data.cam_R[1].T @ (data.cam_p[0] - data.cam_p[1])
    return img0, img1, uv0, depth0, R_gt, t_gt


SIM_K = (460.0, 460.0, 255.0, 255.0)


def _motion_error(R, t, R_gt, t_gt):
    ang = np.degrees(np.arccos(np.clip((np.trace(R_gt.T @ R) - 1) / 2, -1, 1)))
    return ang, np.linalg.norm(t - t_gt)


def test_direct_pose_estimation_matches_jax(frames):
    """float64 in both packages; then the test's own bounds (0.5°, 0.05)."""
    img0, img1, uv0, depth0, R_gt, t_gt = frames
    Rj, tj = jdirect.direct_pose_estimation(*(jnp.asarray(a, jnp.float64)
                                              for a in (img0, img1, uv0, depth0)), SIM_K)
    Rt, tt = tdirect.direct_pose_estimation(img0, img1, uv0, depth0, SIM_K, **CPU64)
    _close(Rt.numpy(), Rj, 0.0, 1e-6, "R")
    _close(tt.numpy(), tj, 0.0, 1e-6, "t")
    ang, dt = _motion_error(Rt.numpy(), tt.numpy(), R_gt, t_gt)
    assert ang < 0.5 and dt < 0.05, (ang, dt)


def test_direct_pose_estimation_in_float32_meets_the_bounds(frames):
    """The card's working type, rehearsed on the CPU, as the JAX test runs
    it (float32 images, points and depths)."""
    img0, img1, uv0, depth0, R_gt, t_gt = frames
    Rt, tt = tdirect.direct_pose_estimation(img0, img1, uv0, depth0, SIM_K,
                                            device="cpu", dtype=torch.float32)
    assert Rt.dtype == torch.float32
    ang, dt = _motion_error(Rt.double().numpy(), tt.double().numpy(), R_gt, t_gt)
    assert ang < 0.5 and dt < 0.05, (ang, dt)
