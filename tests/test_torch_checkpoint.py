"""Checkpoint / resume in the port, and checkpoints crossing between the
packages: the file is host numpy in ``vio_tpu``'s layout, so each package
loads what the other saved.  CPU, float64."""
import numpy as np
import pytest
import torch

from vio_tpu import checkpoint as jcheckpoint, runner as jrunner
from vio_tpu_torch import checkpoint, runner, sim
from vio_tpu_torch.config import sim_config

torch.set_num_threads(1)

N_SAVE = 50


def continue_frames(est, feed_interval, data, first, last):
    """Feed frames first..last-1 of the simulator into an estimator that
    has seen frames 0..first-1, as ``run_sim`` would (with the frame's
    descriptors where the stream carries them); returns the published
    positions."""
    imu_i = int(np.searchsorted(data.imu_t, data.cam_t[first - 1], side="right"))
    t_prev = data.cam_t[first - 1]
    ps = []
    for k in range(first, last):
        t = data.cam_t[k]
        imu_i = feed_interval(est, data.imu_t, data.acc, data.gyr, t_prev, t, imu_i)
        t_prev = t
        feats = {}
        for lid in np.where(data.obs_valid[k])[0]:
            xy = data.obs_xy[k, lid]
            feats[int(lid)] = (np.array([xy[0], xy[1], 1.0]),
                               data.obs_uv[k, lid], np.zeros(2))
        if getattr(data, "descriptors", None) is None:
            est.process_image(feats, t)
        else:
            est.process_image(feats, t, {lid: data.descriptors[lid] for lid in feats})
        if est.initialized:
            ps.append(est.latest_pose()[1])
    return np.asarray(ps)


@pytest.fixture(scope="module")
def data():
    return sim.generate(noise=False)


@pytest.fixture(scope="module")
def port_run(data, tmp_path_factory):
    """The uninterrupted 80-frame run, which saves a checkpoint after its
    50th frame.  Returns (est, traj, the checkpoint's path, what the
    window's positions were when it was saved)."""
    path = str(tmp_path_factory.mktemp("ckpt") / "port.npz")
    seen = []

    def on_frame(est, t, feats):
        seen.append(t)
        if len(seen) == N_SAVE:
            checkpoint.save(est, path)
            seen.append(est.Ps.copy())

    est, traj = runner.run_sim(data, n_frames=80, on_frame=on_frame, device="cpu")
    return est, traj, path, seen[N_SAVE]


def test_resume_equivalence(data, port_run):
    """tests/test_checkpoint.py in the port: save after 50 frames → load →
    continue to 80 reproduces the uninterrupted run to solver precision."""
    est_ref, traj_ref, path, _ = port_run
    est_b = checkpoint.load(path, device="cpu")
    assert est_b.device.type == "cpu" and est_b.dtype == torch.float64
    assert est_b.cfg == est_ref.cfg
    ps = continue_frames(est_b, runner.feed_interval, data, N_SAVE, 80)
    assert len(ps) == 30
    np.testing.assert_allclose(ps, traj_ref["p"][-30:], rtol=0, atol=1e-9)
    np.testing.assert_allclose(est_b.Ps, est_ref.Ps, rtol=0, atol=1e-9)
    np.testing.assert_allclose(est_b.H_prior, est_ref.H_prior, rtol=0, atol=1e-6)
    assert est_b.failure_count == 0 and est_b.frame_solved == est_ref.frame_solved


def test_load_follows_the_device_rule(port_run, monkeypatch):
    """No device named and no card: it raises, like every entry point; a
    named dtype reaches the estimator; the path may lack its ``.npz``."""
    _, _, path, Ps_saved = port_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        checkpoint.load(path)
    est = checkpoint.load(path[:-len(".npz")], device="cpu", dtype=torch.float32)
    assert est.dtype == torch.float32
    np.testing.assert_array_equal(est.Ps, Ps_saved)
    assert est.initialized and len(est.fm.features) > 20 and len(est.all_frames) > 0
    assert all(b is not None for b in est.bufs[1:])


def test_a_checkpoint_written_by_vio_tpu_continues_in_the_port(data, port_run, tmp_path):
    """vio_tpu runs 50 frames and saves; the port loads the file; both go
    on for 10 frames: max |Δp| ≤ 1e-6 m (round-off of ten window solves
    from one shared state).  And back: vio_tpu loads the port's file."""
    est_j, _ = jrunner.run_sim(data, n_frames=N_SAVE)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(est_j, path)
    est_t = checkpoint.load(path, device="cpu")
    for name in ("Ps", "Rs", "Vs", "Bas", "Bgs", "headers", "H_prior", "b_prior",
                 "err_prior", "Jt_prior_inv", "g", "ric", "tic"):
        np.testing.assert_array_equal(getattr(est_t, name), np.asarray(getattr(est_j, name)),
                                      err_msg=name)
    assert est_t.initialized and est_t.frame_count == est_j.frame_count
    assert checkpoint._cfg_fields(est_t.cfg) == est_j.cfg.__dict__   # no loop fields
    assert sorted(est_t.fm.features) == sorted(est_j.fm.features)
    ps_t = continue_frames(est_t, runner.feed_interval, data, N_SAVE, N_SAVE + 10)
    ps_j = continue_frames(est_j, jrunner.feed_interval, data, N_SAVE, N_SAVE + 10)
    assert ps_t.shape == ps_j.shape == (10, 3)
    assert np.abs(ps_t - ps_j).max() <= 1e-6
    assert est_t.failure_count == 0

    _, _, port_path, Ps_saved = port_run
    est_back = jcheckpoint.load(port_path)
    np.testing.assert_array_equal(np.asarray(est_back.Ps), Ps_saved)
    assert est_back.initialized
