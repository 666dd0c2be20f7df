"""The image path as a whole, on the CPU: rendered frames →
``FeatureTracker`` → ``Estimator`` through ``runner.run_images``, the port
beside ``vio_tpu`` at half resolution (320×320, focal 230), float64.

What the two packages cannot share is the RANSAC stream of the
estimator's bootstrap (``sfm.solve_relative_rt``): ``vio_tpu`` draws from
``jax.random``, the port from a ``torch.Generator``.  At this resolution
the bootstrap's inlier threshold (0.3/460 on the normalized plane, 0.15 px
at focal 230) sits at the tracker's noise, so which frame the window first
bootstraps on is luck of the draw in both packages alike (0-2 successes in
20 seeds on most windows of this stream).  The parity run therefore gives
the port the reference's bootstrap solve; everything else is each
package's own."""
import numpy as np
import pytest
import torch

from vio_tpu import runner as jrunner
from vio_tpu.config import sim_images_config as jax_sim_images_config
from vio_tpu.init import sfm as jsfm
from test_torch_features import RENDER, half_res_cfg, half_res_data
from vio_tpu_torch import estimator as port_estimator
from vio_tpu_torch import metrics, runner, sim

torch.set_num_threads(1)

N_PARITY = 75


@pytest.fixture(scope="module")
def data():
    return half_res_data()


def _run(data, n_frames, **kw):
    return runner.run_images(
        runner.sim_image_frames(data, n_frames=n_frames, **RENDER),
        data.imu_t, data.acc, data.gyr, half_res_cfg(), device="cpu", **kw)


def test_run_images_tracks_jax(data, monkeypatch):
    """75 frames through both packages with the same bootstrap solve: the
    same frames initialize, the trajectories agree to 1e-2 m, and both
    meet tests/test_image_pipeline.py's bounds on what they have.  The
    tolerance is the trackers' 1e-5 px difference and round-off, carried
    through an initialization whose scale is poorly conditioned (measured:
    2e-5 m at the first pose, 2e-3 m after 40)."""
    def reference_bootstrap(x0, x1, valid, seed=0, thresh=0.3 / 460.0, *, device, dtype):
        return jsfm.solve_relative_rt(x0, x1, valid, seed, thresh)

    monkeypatch.setattr(port_estimator.sfm, "solve_relative_rt", reference_bootstrap)
    est_t, traj_t = _run(data, N_PARITY)
    est_j, traj_j = jrunner.run_images(
        jrunner.sim_image_frames(data, n_frames=N_PARITY, **RENDER),
        data.imu_t, data.acc, data.gyr, half_res_cfg(jax_sim_images_config))

    assert est_j.initialized and est_t.initialized
    assert est_t.failure_count == 0 and est_j.failure_count == 0
    np.testing.assert_array_equal(traj_t["initialized"], traj_j["initialized"])
    assert len(traj_t["initialized"]) == N_PARITY - 3
    assert len(traj_t["t"]) >= 30
    np.testing.assert_allclose(traj_t["t"], traj_j["t"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(traj_t["p"], traj_j["p"], rtol=0, atol=1e-2)
    gt_p, _ = runner.sim_ground_truth_at(data, traj_t["t"])
    ape_t = metrics.ape_rmse(traj_t["p"], gt_p)["rmse"]
    ape_j = metrics.ape_rmse(traj_j["p"], gt_p)["rmse"]
    assert ape_t < 0.05 and ape_j < 0.05, (ape_t, ape_j)
    assert abs(ape_t - ape_j) < 1e-3, (ape_t, ape_j)
    # the image path's own estimator branches ran: features died and were
    # born, velocities were real, the outlier gate and prior decay were on
    cfg = half_res_cfg()
    assert (cfg.imu_noise_model, cfg.prior_forgetting, cfg.outlier_reproj_px) == \
        ("independent", 0.95, 1.0)
    assert est_t.device.type == "cpu" and est_t.dtype == torch.float64
    assert len(est_t.telemetry) == len(est_j.telemetry)


def test_run_images_with_its_own_random_stream(data):
    """The port alone, its own RANSAC draws: 60 frames run, initialize and
    never fail.  Accuracy is held where the draw does not decide it: above
    with the shared bootstrap, and at full resolution in
    tests/test_torch_image_pipeline_long.py."""
    est, traj = _run(data, 60)
    assert est.initialized and est.failure_count == 0
    assert len(traj["initialized"]) == 57
    assert len(traj["t"]) == int(traj["initialized"].sum()) >= 5
    assert np.isfinite(traj["p"]).all() and traj["p"].shape == (len(traj["t"]), 3)
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    assert metrics.ape_rmse(traj["p"], gt_p)["rmse"] < 0.25


def test_run_images_publish_count(data):
    """12 frames: not enough to initialize, but the whole path runs, and
    12 − 2 primers − 1 unpublished reach the estimator."""
    est, traj = _run(data, 12)
    assert not est.initialized
    assert len(traj["initialized"]) == 9
    assert traj["p"].shape[0] == 0


def test_run_images_takes_arrays_and_a_tracker(data):
    """Frames as arrays (not loaders), and a tracker made by the caller."""
    trk = runner.make_tracker(half_res_cfg(), seed=1, device="cpu")
    frames = [(float(data.cam_t[k]), sim.render_image(data, k, **RENDER)) for k in range(6)]
    seen = []
    est, traj = _run_frames(data, frames, tracker=trk,
                            on_frame=lambda est, t, feats: seen.append(len(feats)))
    assert trk.frame_idx == 4 and len(seen) == len(traj["initialized"]) == 3
    assert min(seen) > 20


def _run_frames(data, frames, **kw):
    return runner.run_images(frames, data.imu_t, data.acc, data.gyr,
                             half_res_cfg(), device="cpu", **kw)


def test_image_stream_discontinuity_resets_freq_control(data):
    """A >1 s camera gap must trip the reset branch (System.cpp:93-100)
    and the run must continue without raising."""
    def frames():
        for k in range(8):
            yield float(data.cam_t[k]), sim.render_image(data, k, **RENDER)
        # 2-second hole, then resume
        for k in range(70, 76):
            yield float(data.cam_t[k]), sim.render_image(data, k, **RENDER)

    est, traj = _run_frames(data, frames())
    # 8 − 3 before the hole; after it one frame trips the reset and one
    # primes the stream again
    assert len(traj["initialized"]) == 5 + 4
