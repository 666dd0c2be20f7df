"""The port's stereo disparity (vio_tpu_torch/features/stereo.py) and
point-cloud alignment (vio_tpu_torch/init/icp.py) against the JAX
package's, on the CPU: tests/test_stereo.py's and
tests/test_components.py::test_icp_*'s cases, in both packages, with the
reference's own bounds on the port.

Tolerances: disparities 1e-4 px with equal ``ok`` masks (float32 images,
float64 positions; the same integer scan and LK steps, reductions summed
in another order); back-projections 1e-12 relative (float64 arithmetic);
Umeyama and Gauss-Newton (R, t) 1e-10 (one 3×3 SVD or 6×6 solve per
step, compared as R and t since the SVD's factors carry arbitrary
signs)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu.features import stereo as jstereo
from vio_tpu.init import icp as jicp
from vio_tpu.utils import lie as jlie
from test_stereo import BASELINE, FX, _make_stereo_pair
from vio_tpu_torch.features import stereo
from vio_tpu_torch.init import icp

torch.set_num_threads(1)
K = np.array([[FX, 0, 320.0], [0, FX, 320.0], [0, 0, 1.0]])


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("seed", [0, 3])
def test_disparity_from_flow_matches_jax(seed):
    left, right, uv_l, Z, disp_gt = _make_stereo_pair(seed=seed)
    left32, right32 = left.astype(np.float32), right.astype(np.float32)
    valid = np.ones(len(uv_l), bool)
    disp, ok = stereo.disparity_from_flow(_t(left32, torch.float32),
                                          _t(right32, torch.float32), _t(uv_l),
                                          torch.as_tensor(valid))
    disp_j, ok_j = jstereo.disparity_from_flow(jnp.asarray(left32), jnp.asarray(right32),
                                               jnp.asarray(uv_l), jnp.asarray(valid))
    disp, ok = disp.numpy(), ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(ok_j))
    np.testing.assert_allclose(disp[ok], np.asarray(disp_j)[ok], rtol=0, atol=1e-4)
    # tests/test_stereo.py's bounds
    assert ok.sum() >= 0.8 * len(uv_l)
    assert np.median(np.abs(disp[ok] - disp_gt[ok])) < 0.1
    r = float(stereo.pearson(_t(disp[ok]), _t(disp_gt[ok])))
    assert r > 0.99
    assert abs(r - float(jstereo.pearson(jnp.asarray(disp[ok]), jnp.asarray(disp_gt[ok])))) < 1e-12
    # depth to < 1 % through the sparse back-projection, as the reference
    pts, pvalid = stereo.points_to_pointcloud(_t(uv_l), _t(disp), _t(K), BASELINE)
    pts_j, pvalid_j = jstereo.points_to_pointcloud(jnp.asarray(uv_l), jnp.asarray(disp),
                                                   jnp.asarray(K), BASELINE)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(pvalid_j))
    np.testing.assert_allclose(pts.numpy(), np.asarray(pts_j), rtol=1e-12, atol=0)
    sel = ok & pvalid.numpy()
    assert np.median(np.abs(pts.numpy()[sel, 2] - Z[sel]) / Z[sel]) < 0.01


def test_disparity_to_pointcloud_matches_jax():
    """The dense back-projection on tests/test_stereo.py's exact image,
    plus a ramp that crosses min_disp."""
    H, W = 64, 96
    K_small = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    for dense in (np.full((H, W), 5.0), np.linspace(0.0, 8.0, H * W).reshape(H, W)):
        pc, valid = stereo.disparity_to_pointcloud(_t(dense), _t(K_small), BASELINE)
        pc_j, valid_j = jstereo.disparity_to_pointcloud(jnp.asarray(dense),
                                                        jnp.asarray(K_small), BASELINE)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
        np.testing.assert_allclose(pc.numpy(), np.asarray(pc_j), rtol=1e-12, atol=0)
    pc, valid = stereo.disparity_to_pointcloud(_t(np.full((H, W), 5.0)),
                                               _t(K_small), BASELINE)
    assert bool(valid.all())
    np.testing.assert_allclose(pc[..., 2].numpy(), FX * BASELINE / 5.0, rtol=1e-6)
    np.testing.assert_allclose(pc[H // 2, W // 2, :2].numpy(), [0.0, 0.0], atol=1e-5)


def _rot(w):
    return np.asarray(jlie.so3_exp_mat(jnp.asarray(w)))


@pytest.mark.parametrize("weighted", [False, True])
def test_icp_umeyama_matches_jax(weighted):
    """tests/test_components.py::test_icp_umeyama_exact, and a weighted
    noisy case."""
    rng = np.random.default_rng(0)
    src = rng.standard_normal((50, 3)) * 2.0
    R_gt, t_gt = _rot([0.2, -0.1, 0.5]), np.array([1.0, -2.0, 0.5])
    dst = src @ R_gt.T + t_gt
    w = None
    if weighted:
        dst = dst + 0.01 * rng.standard_normal(dst.shape)
        w = rng.uniform(0.5, 2.0, 50)
    R, t = icp.umeyama(_t(src), _t(dst), None if w is None else _t(w))
    R_j, t_j = jicp.umeyama(jnp.asarray(src), jnp.asarray(dst),
                            None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), rtol=0, atol=1e-10)
    if not weighted:
        np.testing.assert_allclose(R.numpy(), R_gt, atol=1e-10)
        np.testing.assert_allclose(t.numpy(), t_gt, atol=1e-10)
    assert abs(float(torch.linalg.det(R)) - 1.0) < 1e-12


def test_icp_umeyama_reflection_case():
    """Planar points give a rank-2 covariance, where the sign fix decides
    between a rotation and a reflection."""
    rng = np.random.default_rng(4)
    src = np.concatenate([rng.standard_normal((30, 2)), np.zeros((30, 1))], axis=1)
    R_gt = _rot([0.3, 0.2, -0.4])
    dst = src @ R_gt.T
    R, t = icp.umeyama(_t(src), _t(dst))
    R_j, t_j = jicp.umeyama(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(R.numpy(), R_gt, atol=1e-10)


def test_icp_gn_matches_jax():
    """tests/test_components.py::test_icp_gn_refines_noisy."""
    rng = np.random.default_rng(1)
    src = rng.standard_normal((100, 3)) * 2.0
    R_gt, t_gt = _rot([0.1, 0.3, -0.2]), np.array([0.5, 0.2, -0.7])
    dst = src @ R_gt.T + t_gt + 0.01 * rng.standard_normal((100, 3))
    R0 = _rot([0.05, 0.0, 0.0]) @ R_gt
    R, t, res = icp.icp_gn(_t(src), _t(dst), _t(R0), _t(t_gt + 0.1))
    R_j, t_j, res_j = jicp.icp_gn(jnp.asarray(src), jnp.asarray(dst),
                                  jnp.asarray(R0), jnp.asarray(t_gt + 0.1))
    np.testing.assert_allclose(R.numpy(), np.asarray(R_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(t.numpy(), np.asarray(t_j), rtol=0, atol=1e-10)
    assert abs(float(res) - float(res_j)) < 1e-12
    ang = np.degrees(np.arccos(np.clip((np.trace(R_gt.T @ R.numpy()) - 1) / 2, -1, 1)))
    assert ang < 0.5
    assert np.linalg.norm(t.numpy() - t_gt) < 0.02
    assert float(res) < 0.03
