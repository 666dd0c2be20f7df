"""Loop closing around a run of the port: ``Estimator.apply_live_correction``
against ``vio_tpu``'s on the same window, and (slow) the simulator's whole
closed circuit through ``run_sim`` with loop closing on (the estimator's
``loop_closure`` flag and its closer), at tests/test_loop_integration.py's
bounds.  CPU, float64."""
import numpy as np
import pytest
import torch

from test_torch_checkpoint import continue_frames
from vio_tpu import runner as jrunner
from vio_tpu_torch import metrics, runner, sim
from vio_tpu_torch.config import sim_config
from vio_tpu_torch.utils import lie_np

torch.set_num_threads(1)

N_FRAMES = 40
STATE = ("Ps", "Rs", "Vs", "b_prior", "err_prior")


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def test_apply_live_correction_matches_jax_and_the_next_frame_solves():
    """Both estimators over the same 40 noise-free frames.  After 30
    window solves the two agree in position to 1e-6 m but not in the
    prior's b, which sits near zero at convergence (4e-5 relative), so the
    port's window and prior are then set to vio_tpu's numbers: what is
    compared is the correction, not the run before it.  The same 5° yaw +
    0.3 m correction (with a little pitch and roll, which must be
    projected away) is applied to both: Ps, Rs, Vs, b_prior and err_prior
    agree to 1e-9 relative.  Then the next frame solves in both with no
    failure, 1e-6 m apart."""
    data = sim.generate(noise=False)
    est_t, _ = runner.run_sim(data, n_frames=N_FRAMES, device="cpu")
    est_j, _ = jrunner.run_sim(data, n_frames=N_FRAMES)
    assert est_t.initialized and est_j.initialized
    assert np.abs(est_t.Ps - est_j.Ps).max() < 1e-6
    for name in STATE + ("Bas", "Bgs", "H_prior", "Jt_prior_inv", "last_P", "last_R"):
        setattr(est_t, name, np.array(getattr(est_j, name)))

    dR = lie_np.ypr_to_mat_np(np.array([5.0, 0.8, -0.5]))
    dt = np.array([0.2, -0.1, 0.15])
    Ps0, Rs0, Vs0 = est_t.Ps.copy(), est_t.Rs.copy(), est_t.Vs.copy()
    b0, H = est_t.b_prior.copy(), est_t.H_prior.copy()
    depths0 = {fid: ft.depth for fid, ft in est_t.fm.features.items()}

    Ry, ty = est_t.apply_live_correction(dR, dt)
    jRy, jty = est_j.apply_live_correction(dR, dt)

    np.testing.assert_allclose(Ry, jRy, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ty, jty, rtol=0, atol=1e-9)
    for name in STATE + ("last_P", "last_R"):
        assert _rel(getattr(est_t, name), getattr(est_j, name)) < 1e-9, name
    # what tests/test_loop_integration.py holds vio_tpu's to: yaw only, an
    # exact rigid transform of the window, the anchor frame agreeing with
    # the full correction, the prior updated to first order, depths as
    # they were
    np.testing.assert_allclose(Ry @ np.array([0, 0, 1.0]), [0, 0, 1.0], atol=1e-12)
    for i in range(est_t.W1):
        np.testing.assert_allclose(est_t.Ps[i], Ry @ Ps0[i] + ty, atol=1e-9)
        np.testing.assert_allclose(est_t.Rs[i], Ry @ Rs0[i], atol=1e-9)
        np.testing.assert_allclose(est_t.Vs[i], Ry @ Vs0[i], atol=1e-9)
    k = est_t.frame_count
    np.testing.assert_allclose(est_t.Ps[k], dR @ Ps0[k] + dt, atol=1e-9)
    dx = np.zeros(est_t.P)
    for i in range(est_t.W1):
        base = 6 + 15 * i
        dx[base:base + 3] = est_t.Ps[i] - Ps0[i]
        dx[base + 3:base + 6] = lie_np.so3_log_np(Rs0[i].T @ est_t.Rs[i])
        dx[base + 6:base + 9] = est_t.Vs[i] - Vs0[i]
    np.testing.assert_allclose(est_t.b_prior, b0 - H @ dx, atol=1e-6)
    assert all(ft.depth == depths0[fid] for fid, ft in est_t.fm.features.items())

    n0 = est_t.frame_solved
    ps_t = continue_frames(est_t, runner.feed_interval, data, N_FRAMES, N_FRAMES + 1)
    ps_j = continue_frames(est_j, jrunner.feed_interval, data, N_FRAMES, N_FRAMES + 1)
    assert est_t.frame_solved == n0 + 1 and est_t.failure_count == 0
    assert np.abs(ps_t - ps_j).max() < 1e-6


@pytest.mark.slow
def test_loop_detection_and_metric_edge_accuracy():
    """tests/test_loop_integration.py's run in the port: the 600-frame
    closed circuit with priors underestimated by 3, one fixed random
    descriptor per landmark, loop closing on (``loop_min_gap`` 80), at the
    same bounds on the window's odometry; the published poses are the
    drift-corrected ones; then the loop's feedback into the live window
    and one more solved frame."""
    data = sim.generate(noise=True, pixel_noise=0.0, descriptor_seed=12345)
    cfg = sim_config(acc_n=0.2687 / 3.0, gyr_n=0.2121 / 3.0, loop_closure=1,
                     loop_min_gap=80, loop_train_after=25)
    raw = []

    def on_frame(est, t, feats):
        if est.initialized:
            raw.append((est.Ps[est.frame_count].copy(), est.Rs[est.frame_count].copy()))

    n = len(data.cam_t) - 1          # the last frame is kept for after the rebase
    est, traj = runner.run_sim(data, cfg, n_frames=n, on_frame=on_frame, device="cpu")
    assert est.initialized and est.failure_count == 0
    closer = est.closer
    published = traj["p"]
    traj["p"], traj["R"] = (np.stack(x) for x in zip(*raw))
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape_raw = metrics.ape_rmse(traj["p"], gt_p)
    assert ape_raw["rmse"] < 0.1583, ape_raw
    assert len(closer.loops) >= 1, "no loop accepted over a closed circuit"

    def gt_at(tt):
        i = int(np.searchsorted(data.cam_t, tt))
        return data.imu_p[i], data.imu_R[i]

    perr, aerr = [], []
    for (j, k, dP, dq) in closer.loops:
        pj, Rj = gt_at(closer.kfs[j].t)
        pk, Rk = gt_at(closer.kfs[k].t)
        R_edge = lie_np.quat_to_mat_np(dq)
        perr.append(np.linalg.norm(dP - Rj.T @ (pk - pj)))
        aerr.append(np.degrees(np.arccos(np.clip(
            (np.trace((Rj.T @ Rk).T @ R_edge) - 1) / 2, -1, 1))))
    perr, aerr = np.array(perr), np.array(aerr)
    assert np.median(perr) < 0.3 and np.percentile(perr, 90) < 1.0, perr
    assert np.median(aerr) < 1.0 and np.percentile(aerr, 90) < 2.0, aerr

    Ps_c, Rs_c = closer.correct(traj["t"], traj["p"], traj["R"])
    ape_corr = metrics.ape_rmse(Ps_c, gt_p)
    assert ape_corr["rmse"] < max(2.0 * ape_raw["rmse"], 0.30), (ape_raw, ape_corr)
    p_c, R_c = closer.live_correct(traj["p"][-1], traj["R"][-1])
    np.testing.assert_array_equal(published[-1], p_c)
    assert np.all(np.isfinite(p_c)) and np.all(np.isfinite(R_c))
    assert np.linalg.norm(closer.drift_t) < 2.0

    # the loop's feedback: rebase the live window and the closer together,
    # the corrected output stays where it was, and the next frame solves
    Ry, ty = est.apply_live_correction(closer.drift_R, closer.drift_t)
    closer.rebase(Ry, ty)
    p_c1, _ = closer.live_correct(Ry @ traj["p"][-1] + ty, Ry @ traj["R"][-1])
    np.testing.assert_allclose(p_c1, p_c, atol=1e-9)
    n0 = est.frame_solved
    continue_frames(est, runner.feed_interval, data, n, n + 1)
    assert est.frame_solved == n0 + 1 and est.failure_count == 0
