"""The port's default device: an entry point runs on the card unless its
caller asks for the CPU, and raises where there is no card instead of
carrying on quietly on the CPU.  The inner functions take the device from
their caller and keep no default of their own."""
import inspect

import numpy as np
import pytest
import torch

from vio_tpu_torch import bench, checkpoint, cli, convert, hybrid, runner, sim, testing
from vio_tpu_torch import io as vio_io
from vio_tpu_torch.calib import allan, intrinsics
from vio_tpu_torch.camera import PinholeCamera
from vio_tpu_torch.config import sim_config, sim_images_config
from vio_tpu_torch.device import resolve
from vio_tpu_torch.estimator import Estimator
from vio_tpu_torch.features import clahe, detect, direct, klt, pyramid, stereo
from vio_tpu_torch.features.tracker import FeatureTracker
from vio_tpu_torch.init import icp, sfm
from vio_tpu_torch.loop import posegraph, vocab
from vio_tpu_torch.loop.closer import LoopCloser
from vio_tpu_torch.ops import ransac
from vio_tpu_torch.parallel import global_ba, sharded
from vio_tpu_torch.solver import bal, frame_step, lm, marginalize, pcg

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


def _no_frame(*args, **kwargs):
    raise AssertionError("a frame was processed without a device")


def test_tracker_without_device_raises_without_a_card(no_card):
    cam = PinholeCamera(fx=460.0, fy=460.0, cx=255.0, cy=255.0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FeatureTracker(cam)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runner.make_tracker(sim_images_config())


def test_run_images_without_device_raises_without_a_card(no_card, data, monkeypatch):
    """It raises before any frame is rendered, tracked or solved."""
    monkeypatch.setattr(Estimator, "process_image", _no_frame)
    monkeypatch.setattr(FeatureTracker, "read_image", _no_frame)
    monkeypatch.setattr(sim, "render_image", _no_frame)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runner.run_images(runner.sim_image_frames(data, n_frames=5),
                          data.imu_t, data.acc, data.gyr, sim_images_config())


def test_run_images_async_without_device_raises_without_a_card(no_card, data, monkeypatch):
    """It raises before the producer thread starts or anything is tracked."""
    monkeypatch.setattr(Estimator, "process_image", _no_frame)
    monkeypatch.setattr(FeatureTracker, "read_image", _no_frame)
    monkeypatch.setattr(sim, "render_image", _no_frame)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runner.run_images_async(runner.sim_image_frames(data, n_frames=5),
                                data.imu_t, data.acc, data.gyr, sim_images_config())


def test_loop_closer_without_device_raises_without_a_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LoopCloser()
    closer = LoopCloser(device="cpu")
    assert closer.device == torch.device("cpu") and closer.dtype == torch.float64
    assert LoopCloser(device="cpu", dtype=torch.float32).dtype == torch.float32
    closer.save(str(tmp_path / "closer.npz"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        LoopCloser.load(str(tmp_path / "closer.npz"))
    assert LoopCloser.load(str(tmp_path / "closer.npz"), device="cpu").device.type == "cpu"


def test_image_path_runs_on_an_explicit_cpu(no_card, data):
    """device="cpu": float32 images, float64 positions and estimator; a
    caller's dtype reaches both."""
    small = dict(height=160, width=160)
    cfg = sim_images_config(image_width=160, image_height=160, min_dist=8)
    est, traj = runner.run_images(
        runner.sim_image_frames(data, n_frames=5, **small),
        data.imu_t, data.acc, data.gyr, cfg, device="cpu")
    assert est.device.type == "cpu" and est.dtype == torch.float64
    assert len(traj["initialized"]) == 2
    trk = runner.make_tracker(cfg, device="cpu")
    assert trk.device.type == "cpu" and trk.dtype == torch.float64
    trk.read_image(sim.render_image(data, 0, **small), 0.0)
    assert trk.prev_img.dtype == torch.float32 and trk.prev_img.device.type == "cpu"
    trk32 = runner.make_tracker(cfg, device="cpu", dtype=torch.float32)
    assert trk32.dtype == torch.float32


@pytest.mark.parametrize("device,dtype,expect", [
    ("cpu", None, torch.float64), ("cuda:0", None, torch.float32),
    ("cpu", torch.float32, torch.float32), ("cuda:0", torch.float64, torch.float64)])
def test_dtype_rule(device, dtype, expect):
    """float32 on CUDA, float64 on the CPU, unless the caller names one."""
    assert resolve(device, dtype) == (torch.device(device), expect)


@pytest.mark.parametrize("fn", [
    frame_step.frame_step, frame_step.frame_step_graphed, frame_step.frame_key,
    sfm.relative_rotation, sfm.solve_relative_rt,
    sfm.construct, convert.to_tensor, convert.window_states_from_numpy,
    convert.window_factors_from_numpy, convert.global_ba_from_numpy,
    convert.bal_problem_from_numpy, convert.direct_problem_from_numpy, posegraph.optimize,
    posegraph.optimize_eager, vocab.Vocabulary.__init__,
    vocab.Vocabulary.train], ids=lambda f: f.__qualname__)
def test_inner_functions_keep_no_device_default(fn):
    """The vocabulary's device work is integer only: it takes no dtype."""
    params = inspect.signature(fn).parameters
    assert params["device"].default is inspect.Parameter.empty
    if fn.__qualname__.startswith("Vocabulary."):
        assert "dtype" not in params
    else:
        assert params["dtype"].default is inspect.Parameter.empty


@pytest.mark.parametrize("fn", [
    pyramid.build_pyramid, pyramid.downsample2, pyramid.scharr_gradients,
    pyramid.central_gradients, pyramid.bilinear_sample, pyramid.patch_sample,
    pyramid.patch_sample_multi, klt.track, klt.track_fb, klt.sample_templates,
    klt.refine_on_templates, klt._patch_grid, klt._gauss_weights,
    detect.shi_tomasi_response, detect.detect, detect.occupancy_from_points,
    clahe.clahe, PinholeCamera.lift, PinholeCamera.project,
    sfm.essential_ransac_from_samples, sfm.essential_ransac, sfm.ransac_samples,
    ransac.sweep, ransac.refit, ransac.refit_best,
    stereo.disparity_from_flow, stereo.disparity_to_pointcloud,
    stereo.points_to_pointcloud, stereo.pearson, icp.umeyama, icp.icp_gn,
    marginalize.marginalize_old, marginalize.marginalize_new,
    marginalize.marginalize_old_host, pcg.pcg_solve, pcg.solve_with, lm.solve_window,
    lm.solve_with, global_ba.solve_with],
    ids=lambda f: f.__qualname__)
def test_frontend_functions_take_the_device_from_their_inputs(fn):
    """No frontend or solver function below the entry points has a device
    or dtype to default: it works where its tensors are.  The two helpers that make
    a tensor from nothing are told both, with no default."""
    params = inspect.signature(fn).parameters
    for name in ("device", "dtype"):
        if name in params:
            assert params[name].default is inspect.Parameter.empty
    assert not {"device", "dtype"} & set(params) or fn in (klt._patch_grid, klt._gauss_weights)


@pytest.mark.parametrize("entry", [FeatureTracker.__init__, runner.make_tracker,
                                   runner.run_images, runner.run_images_async,
                                   runner.run_sim, runner.run_euroc, Estimator.__init__,
                                   intrinsics.calibrate_chessboard,
                                   LoopCloser.__init__, LoopCloser.load, checkpoint.load,
                                   global_ba.solve,
                                   global_ba.solve_sharded,
                                   sharded.solve_window_sharded, sharded.training_step,
                                   bal.solve, bal.load_bal, direct.direct_ba,
                                   direct.direct_pose_estimation,
                                   testing.make_global_problem,
                                   testing.make_window_problem,
                                   bench.window_problem, bench.bench_window,
                                   bench.klt_inputs, bench.bench_klt,
                                   bench.global_problem, bench.global_solve,
                                   bench.bench_global_ba, bench.bench_e2e_sim,
                                   bench.bench_fp32_ape],
                         ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(entry):
    params = inspect.signature(entry).parameters
    assert params["device"].default is None and params["dtype"].default is None


def test_scale_out_entry_points_raise_without_a_card(no_card, tmp_path):
    """Each raises before any work: the problems are built on the CPU
    first, as a machine without a card would."""
    cpu = dict(device="cpu")
    p, _ = testing.make_global_problem(N=8, M=16, obs_per_lm=2, **cpu)
    states, f, _ = testing.make_window_problem(window_size=2, max_features=8,
                                               imu_per_interval=2, **cpu)
    calls = [lambda: testing.make_global_problem(N=8, M=16, obs_per_lm=2),
             lambda: testing.make_window_problem(window_size=2, max_features=8),
             lambda: global_ba.solve(p),
             lambda: global_ba.solve_sharded(p),
             lambda: sharded.solve_window_sharded(states, f),
             lambda: sharded.training_step(states, f),
             lambda: bal.load_bal(str(tmp_path / "absent.txt")),
             lambda: direct.direct_pose_estimation(
                 np.zeros((32, 32)), np.zeros((32, 32)), np.zeros((1, 2)), np.ones(1),
                 (1.0, 1.0, 0.0, 0.0))]
    for call in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    bp = bal.BalProblem(*(torch.zeros(1) for _ in bal.BalProblem._fields))
    dp = direct.DirectBAProblem(*(torch.zeros(1) for _ in direct.DirectBAProblem._fields))
    for call in (lambda: bal.solve(bp), lambda: direct.direct_ba(dp)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_scale_out_entry_points_run_on_an_explicit_cpu():
    p, _ = testing.make_global_problem(N=8, M=32, obs_per_lm=3, device="cpu",
                                       dtype=torch.float32)
    out, stats = global_ba.solve(p, max_iter=2, fix_frames=2, device="cpu")
    assert out.Ps.device.type == "cpu" and out.Ps.dtype == torch.float64
    out, _ = global_ba.solve(p, max_iter=2, fix_frames=2, device="cpu",
                             dtype=torch.float32)
    assert out.Ps.dtype == torch.float32


def test_host_only_calibration_and_datasets_take_no_device():
    """The Allan fit is host float64, as in vio_tpu; the hybrid builder and
    the dataset IO are numpy: none of them touches a device."""
    for fn in (allan.fit_allan_params, allan.calibrate, allan.allan_variance,
               hybrid.generate_hybrid, vio_io.load_euroc, vio_io.write_euroc):
        assert not {"device", "dtype"} & set(inspect.signature(fn).parameters), fn


def test_refine_corners_defaults_to_the_card():
    """Images and corners are float32 everywhere, so it takes a device only."""
    params = inspect.signature(intrinsics.refine_corners_subpix).parameters
    assert params["device"].default is None and "dtype" not in params


def test_run_euroc_cli_and_calibration_raise_without_a_card(no_card, data, monkeypatch, tmp_path):
    """Each raises before any frame is read or tracked: run_euroc, the
    CLI's default --device, and the chessboard calibration and corner
    refinement."""
    monkeypatch.setattr(vio_io, "load_image", _no_frame)
    monkeypatch.setattr(FeatureTracker, "read_image", _no_frame)
    monkeypatch.setattr(Estimator, "process_image", _no_frame)
    seq = str(tmp_path / "seq")
    vio_io.write_euroc(data, seq, n_frames=3, render_kw=dict(height=32, width=32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        runner.run_euroc(seq)
    for argv in (["run", "--frames", "3"], ["run", "--dataset", "euroc", "--path", seq]):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cli.main(argv)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        intrinsics.calibrate_chessboard(np.zeros((4, 2)), np.zeros((3, 4, 2)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        intrinsics.refine_corners_subpix(np.zeros((32, 32)), np.zeros((1, 2)))


@pytest.mark.parametrize("call", [
    lambda: bench.main(), lambda: cli.main(["bench"]),
    lambda: bench.window_problem(8), lambda: bench.bench_window(8),
    lambda: bench.klt_inputs(), lambda: bench.bench_klt(), lambda: bench.global_problem(),
    lambda: bench.global_solve(None), lambda: bench.bench_global_ba(),
    lambda: bench.bench_e2e_sim(), lambda: bench.bench_fp32_ape()],
    ids=["main", "cli bench", "window_problem", "bench_window",
         "klt_inputs", "bench_klt", "global_problem", "global_solve", "bench_global_ba",
         "bench_e2e_sim", "bench_fp32_ape"])
def test_bench_raises_without_a_card(no_card, monkeypatch, tmp_path, call):
    """The bench and each of its stages raise before any work: no details
    file is written and no simulator run starts."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sim, "generate", _no_frame)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    assert not (tmp_path / bench.DETAILS).exists()
