"""The port's simulation main path on noisy IMU data, held to
tests/test_e2e_sim.py's noisy bounds (CPU, float64).  Kept apart from
test_torch_e2e_sim.py so that the two 150-frame workloads run on
different test workers."""
import torch

from vio_tpu_torch import metrics, runner, sim

torch.set_num_threads(1)


def test_port_sim_with_noise_short():
    """Noisy IMU with the matched noise prior, noise-free pixels — the
    setup of tests/test_e2e_sim.py::test_sim_with_noise_short."""
    data = sim.generate(noise=True, pixel_noise=0.0)
    est, traj = runner.run_sim(data, n_frames=150, device="cpu")
    assert est.initialized
    assert est.failure_count == 0
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape = metrics.ape_rmse(traj["p"], gt_p)
    assert ape["rmse"] < 0.08, ape
