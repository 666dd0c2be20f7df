"""The port's calibration (vio_tpu_torch/calib/allan.py, intrinsics.py)
against the JAX package's, on the CPU: tests/test_allan.py's synthetic
IMU noise and tests/test_intrinsics.py's synthetic views and rendered
chessboard, with the reference's own bounds on the port.

Tolerances: the Allan variance and the host numpy steps (homography,
Zhang's closed form, the per-view poses) are copies, so they agree to
1e-12 relative; the fitted parameters come from the same host float64 LM
on normal equations built by each library's forward mode, 1e-6 relative
(the LM's accept test near convergence compares chi² changes at
round-off); the bundle refinement's parameters 1e-6 relative and the RMS
1e-9 px; the saddle refinement runs in float32 in both packages, 1e-3 px."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu.calib import allan as jallan
from vio_tpu.calib import intrinsics as jic
from test_allan import _imu_noise
from test_intrinsics import TRUE, _render_checker, synth_views
from vio_tpu_torch.calib import allan, intrinsics as ic

torch.set_num_threads(1)
CPU = dict(device="cpu")
PARAMS = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2")
EXACT_BOUNDS = (("fx", 0.01), ("fy", 0.01), ("cx", 0.01), ("cy", 0.01),
                ("k1", 1e-4), ("k2", 1e-4), ("p1", 1e-5), ("p2", 1e-5))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


@pytest.mark.parametrize("sigma,bias,n,seed", [
    (0.015, 1e-5, 400_000, 1), (0.019, 1e-4, 900_000, 2), (0.02, 0.0, 200_000, 3)],
    ids=["gyro", "acc", "white"])
def test_allan_fit_matches_jax(sigma, bias, n, seed):
    """tests/test_allan.py's three streams: the curve, the fit, and the
    reference's bounds."""
    dt = 1.0 / 200.0
    x = _imu_noise(sigma, bias, n, dt, seed=seed)
    taus, avar = allan.allan_variance(x, dt)
    taus_j, avar_j = jallan.allan_variance(x, dt)
    np.testing.assert_array_equal(taus, taus_j)
    np.testing.assert_allclose(avar, avar_j, rtol=1e-12)
    fit = allan.fit_allan_params(taus, np.sqrt(avar))
    fit_j = jallan.fit_allan_params(taus_j, np.sqrt(avar_j))
    for k in ("Q", "N", "B", "K", "R", "chi2"):
        assert _rel(fit[k], float(fit_j[k])) < 1e-6, (k, fit[k], fit_j[k])
    if bias > 0:
        assert abs(fit["N"] - sigma) / sigma < 0.10
    else:
        sel = (taus > 0.01) & (taus < 1.0)
        slope = np.polyfit(np.log(taus[sel]), np.log(np.sqrt(avar[sel])), 1)[0]
        assert abs(slope + 0.5) < 0.1
    if n == 900_000:
        tau = 250.0
        slow = fit["B"] ** 2 + fit["K"] ** 2 * tau + fit["R"] ** 2 * tau ** 2
        true_slow = bias ** 2 * tau
        assert true_slow / 9 < slow < true_slow * 9


def test_static_prefix_and_per_axis_calibrate_match_jax():
    dt = 1.0 / 200.0
    rng = np.random.default_rng(5)
    gyr = np.concatenate([0.003 * rng.standard_normal((2000, 3)),
                          0.3 * rng.standard_normal((1000, 3))])
    assert allan.detect_static_prefix(gyr, dt) == jallan.detect_static_prefix(gyr, dt)
    assert 1200 <= allan.detect_static_prefix(gyr, dt) < 2000
    assert allan.detect_static_prefix(gyr[:1500], dt) == 1500
    x = np.stack([_imu_noise(0.015, 1e-5, 60_000, dt, seed=s) for s in (7, 8, 9)], axis=1)
    out, out_j = allan.calibrate(x, dt), jallan.calibrate(x, dt)
    np.testing.assert_array_equal(out["taus"], out_j["taus"])
    for k in ("N", "K", "B"):
        assert len(out[k]) == 3
        for a, b in zip(out[k], out_j[k]):
            assert _rel(a, float(b)) < 1e-6, (k, a, b)


def test_zhang_closed_form_matches_jax():
    board, img_pts = synth_views()
    Hs = [ic.homography_dlt(board, v) for v in img_pts]
    for H, v in zip(Hs, img_pts):
        np.testing.assert_allclose(H, jic.homography_dlt(board, v), rtol=1e-12, atol=1e-12)
    K4 = ic.zhang_init(Hs)
    np.testing.assert_allclose(K4, jic.zhang_init(Hs), rtol=1e-12)
    for H in Hs:
        for a, b in zip(ic.extrinsics_from_homography(H, K4),
                        jic.extrinsics_from_homography(H, K4)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    # tests/test_intrinsics.py's bounds
    assert abs(K4[0] - TRUE["fx"]) / TRUE["fx"] < 0.05
    assert abs(K4[2] - TRUE["cx"]) < 15 and abs(K4[3] - TRUE["cy"]) < 15


@pytest.mark.parametrize("noise", [0.0, 0.2], ids=["exact", "noisy"])
def test_calibrate_chessboard_matches_jax(noise):
    board, img_pts = synth_views()
    if noise:
        img_pts = img_pts + np.random.default_rng(11).normal(0, noise, img_pts.shape)
    out = ic.calibrate_chessboard(board, img_pts, **CPU)
    out_j = jic.calibrate_chessboard(board, img_pts)
    for k in PARAMS:
        assert abs(out[k] - float(out_j[k])) <= 1e-6 * max(abs(float(out_j[k])), 1e-3), k
    np.testing.assert_allclose(out["poses"], np.asarray(out_j["poses"]), rtol=0, atol=1e-8)
    assert abs(out["reproj_rms_px"] - out_j["reproj_rms_px"]) < 1e-9
    np.testing.assert_allclose(out["init_K"], out_j["init_K"], rtol=1e-12)
    if noise:
        assert abs(out["fx"] - TRUE["fx"]) / TRUE["fx"] < 0.01
        assert abs(out["cx"] - TRUE["cx"]) < 3.0
        assert abs(out["k1"] - TRUE["k1"]) < 0.02
        assert 0.1 < out["reproj_rms_px"] < 0.35
    else:
        for k, tol in EXACT_BOUNDS:
            assert abs(out[k] - TRUE[k]) < tol, k
        assert out["reproj_rms_px"] < 1e-4


def test_calibrate_chessboard_float32_rehearsal():
    """float32 residuals and Jacobian (the card's type), the LM on the host
    in float64: tests/test_intrinsics.py's exact-corner bounds."""
    board, img_pts = synth_views()
    out = ic.calibrate_chessboard(board, img_pts, device="cpu", dtype=torch.float32)
    for k, tol in EXACT_BOUNDS:
        assert abs(out[k] - TRUE[k]) < tol, (k, out[k])
    assert out["reproj_rms_px"] < 1e-4


def test_refine_corners_subpix_matches_jax():
    """tests/test_intrinsics.py's rendered, perspective-warped board."""
    rng = np.random.default_rng(0)
    sq = 24.0
    Hm = np.array([[1.05, 0.08, 40.0], [-0.05, 0.98, 30.0], [1e-4, -8e-5, 1.0]])
    img = _render_checker(Hm, sq=sq).astype(np.float32)
    pts = []
    for i in range(1, 10):
        for j in range(1, 7):
            p = Hm @ np.array([i * sq, j * sq, 1.0])
            p = p[:2] / p[2]
            if 15 < p[0] < 320 - 15 and 15 < p[1] < 240 - 15:
                pts.append(p)
    pts = np.asarray(pts)
    start = pts + rng.uniform(-0.7, 0.7, pts.shape)
    ref = ic.refine_corners_subpix(img, start, half=4, n_iter=4, **CPU)
    assert ref.dtype == torch.float32 and ref.device.type == "cpu"
    ref = ref.numpy()
    ref_j = np.asarray(jic.refine_corners_subpix(img, start, half=4, n_iter=4))
    np.testing.assert_allclose(ref, ref_j, rtol=0, atol=1e-3)
    err = np.linalg.norm(ref - pts, axis=1)
    assert err.mean() < 0.05
    assert np.percentile(err, 90) < 0.08
