"""The port's simulation main path end to end (vio_tpu_torch.sim,
vio_tpu_torch.runner.run_sim) against the JAX package's, on the CPU in
float64, and on tests/test_e2e_sim.py's noise-free bounds (the noisy
bounds are in test_torch_e2e_noisy.py).

Tolerances: the simulator's float arrays rtol 1e-12, atol 1e-10 (libm
trig against XLA's, float64).  The 150-frame trajectories: max position
difference 1e-6 m — the round-off of ~140 window solves compounding; the
packages solve the damped system differently on the CPU (Gauss-Jordan
here, LU in vio_tpu) and the LM's accept test near convergence compares
chi² changes at round-off level, so no tighter bound is meaningful."""
import jax
import numpy as np
import pytest
import torch

from vio_tpu import runner as jrunner
from vio_tpu import sim as jsim
from vio_tpu.solver import frame_step as jframe_step
from vio_tpu_torch import metrics, runner, sim
from vio_tpu_torch.solver import frame_step as tframe_step

torch.set_num_threads(1)

SIM_FLOAT_FIELDS = ("imu_t", "acc", "gyr", "acc_bias", "gyr_bias", "cam_t",
                    "cam_p", "cam_R", "imu_p", "imu_R", "imu_v", "landmarks",
                    "obs_xy", "obs_uv")


@pytest.mark.parametrize("noise,pixel_noise", [(False, 0.0), (True, 0.0), (True, 1.0)],
                         ids=["noise_free", "noisy_imu", "noisy_imu_and_pixels"])
def test_sim_generate_matches_jax(noise, pixel_noise):
    ref = jsim.generate(noise=noise, pixel_noise=pixel_noise)
    out = sim.generate(noise=noise, pixel_noise=pixel_noise)
    for name in SIM_FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(out, name), getattr(ref, name),
                                   rtol=1e-12, atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(out.obs_valid, ref.obs_valid)


@pytest.fixture(scope="module")
def clean_data():
    return sim.generate(noise=False)


@pytest.fixture(scope="module")
def port_run(clean_data):
    return runner.run_sim(clean_data, n_frames=150, device="cpu")


@pytest.fixture(scope="module")
def jax_run():
    """vio_tpu's 150-frame run, also recording the host inputs and fetched
    outputs of two of its per-frame frame_step calls: the 10th that
    marginalizes the oldest frame and the first that drops the newest."""
    original = jframe_step.frame_step
    calls = {"n_old": 0}

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        key = "marg_old" if kwargs["marg_old"] else "marg_new"
        if key == "marg_old":
            calls["n_old"] += 1
        if key not in calls and (key == "marg_new" or calls["n_old"] == 10):
            calls[key] = (args, kwargs, jax.device_get(out))
        return out

    jframe_step.frame_step = recording
    try:
        est, traj = jrunner.run_sim(jsim.generate(noise=False), n_frames=150)
    finally:
        jframe_step.frame_step = original
    return est, traj, calls


@pytest.mark.parametrize("case", ["marg_old", "marg_new"])
def test_frame_step_matches_jax(jax_run, case):
    """One estimator frame on identical host inputs: the LM's iteration
    count is exact; states, prior terms and the marg blocks agree to
    round-off relative to each array's largest entry (rtol 1e-7)."""
    args, kwargs, ref = jax_run[2][case]
    out = tframe_step.fetch(tframe_step.frame_step(
        *args, **kwargs, device="cpu", dtype=torch.float64))
    assert out.iterations == int(ref.iterations)
    pairs = list(zip(out.states, ref.states)) + [
        (getattr(out, k), getattr(ref, k)) for k in
        ("b_prior", "err_prior", "chi2", "chi2_init", "feat_errs", "marg_Hpp", "marg_bp")]
    for a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-12 + 1e-7 * np.abs(b).max()


def test_run_sim_tracks_jax(port_run, jax_run):
    """Same initialization sequence, same number of poses, and the
    trajectories within 1e-6 m of each other over 150 noise-free frames."""
    est, traj = port_run
    est_j, traj_j, _ = jax_run
    np.testing.assert_array_equal(traj["initialized"], traj_j["initialized"])
    assert len(traj["t"]) == len(traj_j["t"])
    np.testing.assert_array_equal(traj["t"], traj_j["t"])
    dp = np.abs(traj["p"] - traj_j["p"]).max()
    assert dp <= 1e-6, dp
    assert [t["marg"] for t in est.telemetry] == [t["marg"] for t in est_j.telemetry]


def test_port_sim_noise_free_short(port_run, clean_data):
    """tests/test_e2e_sim.py's noise-free bounds, on the port alone."""
    est, traj = port_run
    assert est.initialized
    assert est.failure_count == 0
    assert len(traj["t"]) >= 130
    gt_p, _ = runner.sim_ground_truth_at(clean_data, traj["t"])
    ape = metrics.ape_rmse(traj["p"], gt_p)
    assert ape["rmse"] < 0.01, ape
