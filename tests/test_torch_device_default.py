"""The port's default device: an entry point runs on the card unless its
caller asks for the CPU, and raises where there is no card instead of
carrying on quietly on the CPU.  The inner functions take the device from
their caller and keep no default of their own."""
import inspect

import pytest
import torch

from vio_tpu_torch import convert, runner, sim
from vio_tpu_torch.config import sim_config
from vio_tpu_torch.device import resolve
from vio_tpu_torch.estimator import Estimator
from vio_tpu_torch.init import sfm
from vio_tpu_torch.solver import frame_step

torch.set_num_threads(1)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def data():
    return sim.generate(noise=False)


def test_estimator_without_device_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Estimator(sim_config())


def test_run_sim_without_device_raises_without_a_card(no_card, data, monkeypatch):
    """It raises before any frame is processed: nothing ran on the CPU."""
    def no_frame(*args, **kwargs):
        raise AssertionError("a frame was processed without a device")

    monkeypatch.setattr(Estimator, "process_image", no_frame)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runner.run_sim(data, n_frames=3)


def test_explicit_cpu_runs(no_card, data):
    est = Estimator(sim_config(), device="cpu")
    assert est.device == torch.device("cpu") and est.dtype == torch.float64
    est, traj = runner.run_sim(data, n_frames=4, device="cpu")
    assert est.device.type == "cpu" and est.dtype == torch.float64
    assert len(traj["initialized"]) == 4


@pytest.mark.parametrize("device,dtype,expect", [
    ("cpu", None, torch.float64), ("cuda:0", None, torch.float32),
    ("cpu", torch.float32, torch.float32), ("cuda:0", torch.float64, torch.float64)])
def test_dtype_rule(device, dtype, expect):
    """float32 on CUDA, float64 on the CPU, unless the caller names one."""
    assert resolve(device, dtype) == (torch.device(device), expect)


@pytest.mark.parametrize("fn", [
    frame_step.frame_step, sfm.relative_rotation, sfm.solve_relative_rt,
    sfm.construct, convert.to_tensor, convert.window_states_from_numpy,
    convert.window_factors_from_numpy], ids=lambda f: f.__name__)
def test_inner_functions_keep_no_device_default(fn):
    params = inspect.signature(fn).parameters
    assert params["device"].default is inspect.Parameter.empty
    assert params["dtype"].default is inspect.Parameter.empty
