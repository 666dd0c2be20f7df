"""The port's image path at full length, on the CPU in float64: the twin
of tests/test_image_pipeline.py::test_images_to_estimator_end_to_end and
of chip_smoke.py's image main path.

It runs at the card's resolution, 640×640 at focal 460, not at the half
resolution of the reference's test.  At half resolution the estimator's
bootstrap (``sfm.solve_relative_rt``) succeeds on 0-2 of 20 RANSAC seeds
on most windows of this stream, in both packages alike, so which frame
initializes, and with it the run's scale error, follows the random stream
(``jax.random`` there, a ``torch.Generator`` here): the reference's own
half-resolution run measures 0.0473 m against the 0.05 m bound, the
port's with its stream 0.105 m.  At full resolution both packages
initialize on the same frame and measure 0.0388 m (vio_tpu) and 0.0383 m
(the port).  tests/test_torch_image_pipeline.py holds the half-resolution
path against vio_tpu with the bootstrap draw shared."""
import pytest
import torch

from vio_tpu_torch import metrics, runner, sim
from vio_tpu_torch.config import sim_images_config

torch.set_num_threads(1)


@pytest.mark.slow
def test_images_to_estimator_end_to_end():
    """155 rendered frames through the real tracker into the estimator:
    APE must beat 0.05 m, with no failure reset."""
    data = sim.generate(noise=False)
    est, traj = runner.run_images(
        runner.sim_image_frames(data, n_frames=155),
        data.imu_t, data.acc, data.gyr, sim_images_config(), device="cpu")
    assert est.initialized
    assert est.failure_count == 0
    assert len(traj["t"]) >= 120
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape = metrics.ape_rmse(traj["p"], gt_p)
    assert ape["rmse"] < 0.05, ape
