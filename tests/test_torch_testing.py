"""The port's problem builders (vio_tpu_torch/testing.py) against the JAX
package's (vio_tpu/testing.py): given the same arguments both draw the
same numbers from the same numpy streams, so the problems agree to
round-off in float64 (≤ 1e-12 relative to each array's largest entry:
the rotations and the preintegration go through each package's own
arithmetic) and their integer and boolean arrays agree exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import testing as jt
from vio_tpu_torch import testing as tt

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _same(actual, desired, name, rtol=1e-12):
    actual = actual.numpy() if isinstance(actual, torch.Tensor) else np.asarray(actual)
    desired = np.asarray(desired)
    assert actual.shape == desired.shape, name
    if desired.dtype.kind in "biu":
        np.testing.assert_array_equal(actual, desired, err_msg=name)
        return
    err = np.abs(actual - desired).max(initial=0.0)
    assert err <= rtol * np.abs(desired).max(initial=0.0), f"{name}: {err:.3e}"


def _same_tuple(t, j, prefix=""):
    for name in j._fields:
        a, b = getattr(t, name), getattr(j, name)
        if hasattr(b, "_fields"):
            _same_tuple(a, b, f"{prefix}{name}.")
        else:
            _same(a, b, prefix + name)


@pytest.mark.parametrize("N,M,obs", [(12, 120, 6), (16, 64, 4), (100, 400, 8)])
def test_global_problem_matches_jax(N, M, obs):
    pj, pts_j = jt.make_global_problem(N=N, M=M, obs_per_lm=obs)
    pt, pts_t = tt.make_global_problem(N=N, M=M, obs_per_lm=obs, **CPU64)
    _same_tuple(pt, pj)
    _same(pts_t, pts_j, "pts")
    assert pt.lm_idx.dtype == torch.int64 and pt.valid.dtype == torch.bool


def test_perturb_global_matches_jax():
    pj, _ = jt.make_global_problem(N=16, M=64, obs_per_lm=4)
    pt, _ = tt.make_global_problem(N=16, M=64, obs_per_lm=4, **CPU64)
    kw = dict(seed=3, pose_sigma=0.02, rot_sigma=0.005, dep_sigma=0.05, fix_frames=2)
    _same_tuple(tt.perturb_global(pt, **kw), jt.perturb_global(pj, **kw))


def test_builders_keep_dtype_and_device():
    p, _ = tt.make_global_problem(N=8, M=32, obs_per_lm=4, device="cpu",
                                  dtype=torch.float32)
    q = tt.perturb_global(p)
    assert q.Ps.dtype == q.Qs.dtype == q.inv_dep.dtype == torch.float32
    states, f, gt = tt.make_window_problem(window_size=2, max_features=8,
                                           imu_per_interval=2, device="cpu",
                                           dtype=torch.float32)
    assert states.Ps.dtype == f.imu_terms.covariance.dtype == torch.float32
    assert f.start.dtype == torch.int64 and f.obs_mask.dtype == torch.bool


@pytest.mark.parametrize("W,F,imu", [(10, 64, 8), (4, 32, 4)])
def test_window_problem_matches_jax(W, F, imu):
    sj, fj, gj = jt.make_window_problem(window_size=W, max_features=F,
                                        imu_per_interval=imu, dtype=jnp.float64)
    st, ft, gt = tt.make_window_problem(window_size=W, max_features=F,
                                        imu_per_interval=imu, **CPU64)
    _same_tuple(st, sj, "states.")
    _same_tuple(ft, fj, "factors.")
    _same_tuple(gt, gj, "gt.")
