"""The estimator's time-offset, rolling-shutter and online-extrinsic
branches (vio_tpu_torch/estimator.py: td configured or refined online by
``_estimate_td``, the rolling-shutter row time, ``estimate_extrinsic == 2``
handing over to mode 1, the extrinsic in BA; runner.py: td applied before
pairing) against the JAX package's, on the CPU in float64.

The inputs are the reference tests' own: tests/test_td.py's camera clock
lagging the IMU clock, with finite-difference feature velocities for the
online estimate, and tests/test_ex_calib_online.py's identity start.

Tolerances: trajectories 1e-6 m, as tests/test_torch_e2e_sim.py (the
round-off of the window solves compounding); the online td 1e-9 s frame
by frame (its update is a sum over the solved states); the rolling-shutter
shift is host float64 arithmetic, bit for bit.  The calibrator's inputs
come from each package's own RANSAC (jax.random against torch.Generator),
and on exact data its camera quaternions agree to 1e-12 (measured 2e-15),
the solved R_ic to 1e-6 (entrywise, once three pairs close its null
space).  Depths are cut from the
reference's 150-300 frames to keep this file near two minutes on one
worker; the 300-frame handover is marked slow, as its reference is."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from vio_tpu import runner as jrunner
from vio_tpu import sim as jsim
from vio_tpu.config import sim_config as jsim_config
from vio_tpu.estimator import Estimator as JEstimator
from vio_tpu_torch import metrics, runner, sim
from vio_tpu_torch.config import sim_config
from vio_tpu_torch.estimator import Estimator

torch.set_num_threads(1)

TD = 0.012           # tests/test_td.py: a 12 ms camera clock lag
N_TD = 50            # frames of each td run (the reference runs 150-200)
N_EXACT = 12         # the online-td stream's last frame before round-off
                     # flips an LM decision (frame 13, in vio_tpu alone too)
N_EX = 90            # frames of the mode-2 comparison
R_IC_GT = np.array([[0.0, 0.0, -1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
IDENTITY = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


@pytest.fixture(scope="module")
def data():
    return jsim.generate(noise=False)


def _angle(Ra, Rb):
    c = np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.arccos(c))


def test_fixed_td_run_sim_matches_jax(data):
    """cfg.td = 12 ms through run_sim on the lagged stream: the same
    published stamps (shifted by td before pairing) and trajectories."""
    lagged = dataclasses.replace(data, cam_t=data.cam_t - TD)
    _, traj_j = jrunner.run_sim(lagged, cfg=jsim_config(td=TD), n_frames=N_TD)
    est, traj = runner.run_sim(lagged, cfg=sim_config(td=TD), n_frames=N_TD,
                               device="cpu")
    assert est.td == TD
    np.testing.assert_array_equal(traj["initialized"], traj_j["initialized"])
    np.testing.assert_array_equal(traj["t"], traj_j["t"])
    assert len(traj["t"]) >= N_TD - 15
    assert np.abs(traj["p"] - traj_j["p"]).max() <= 1e-6
    # the stamps are the camera's shifted back onto the IMU clock
    k = np.searchsorted(data.cam_t, traj["t"])
    assert np.abs(traj["t"] - data.cam_t[k]).max() < 1e-12


def _online_td(est, feed, data, true_td, n):
    """tests/test_td.py::_run_online_td's stream, recording est.td and the
    latest pose after every frame."""
    lagged_t = data.cam_t - true_td
    imu_i = 0
    t_prev = lagged_t[0] + est.td
    tds, ts, ps = [], [], []
    for k in range(n):
        t = lagged_t[k] + est.td
        if k:
            imu_i = feed(est, data.imu_t, data.acc, data.gyr, t_prev, t, imu_i)
        t_prev = t
        feats = {}
        dt = data.cam_t[k] - data.cam_t[k - 1] if k else 1.0
        for lid in np.where(data.obs_valid[k])[0]:
            xy = data.obs_xy[k, lid]
            vel = ((xy - data.obs_xy[k - 1, lid]) / dt
                   if k and data.obs_valid[k - 1, lid] else np.zeros(2))
            feats[int(lid)] = (np.array([xy[0], xy[1], 1.0]),
                               data.obs_uv[k, lid], vel)
        est.process_image(feats, t)
        tds.append(est.td)
        if est.initialized:
            tt, p, _ = est.latest_pose()
            ts.append(tt)
            ps.append(p)
    return np.asarray(tds), np.asarray(ts), np.asarray(ps)


def test_online_td_matches_jax(data, monkeypatch):
    """estimate_td from td = 0 against a true 6 ms lag.

    The branch itself: at every frame, JAX's ``_estimate_td`` applied to
    the port's own state gives the port's td to the last bit.  The runs:
    est.td and the trajectory frame by frame to 1e-9 s and 1e-6 m up to
    frame N_EXACT; after that, at solves the LM ends at its iteration cap,
    round-off decides the accept test, and the reference itself moves by
    as much under a 1e-14 relative change of its accelerometer samples
    (over 50 frames: 8.0e-6 s and 0.0161 m, against the port's 8.7e-6 s
    and 0.0174 m; scripts/torch_round_off_spread.py td).  The whole run is
    held to three times the reference's own spread, measured here."""
    port_td = Estimator._estimate_td
    checked = []

    def both(est):
        ref = copy.copy(est)
        JEstimator._estimate_td(ref)
        port_td(est)
        checked.append(ref.td == est.td)

    monkeypatch.setattr(Estimator, "_estimate_td", both)
    est = Estimator(sim_config(td=0.0, estimate_td=True), device="cpu")
    tds, ts, ps = _online_td(est, runner.feed_interval, data, 0.006, N_TD)
    assert len(checked) >= N_TD - 12 and all(checked)

    def jax_run(d):
        return _online_td(JEstimator(jsim_config(td=0.0, estimate_td=True)),
                          jrunner.feed_interval, d, 0.006, N_TD)

    tds_j, ts_j, ps_j = jax_run(data)
    tds_e, _, ps_e = jax_run(dataclasses.replace(data, acc=data.acc * (1 + 1e-14)))
    assert np.count_nonzero(np.diff(tds_j)) >= 10       # the branch ran
    assert len(ts) == len(ts_j)
    lead = N_TD - len(ts)                # frames before the first pose
    assert np.abs(tds - tds_j)[:N_EXACT + 1].max() <= 1e-9
    assert np.abs(ps - ps_j)[:N_EXACT + 1 - lead].max() <= 1e-6
    assert np.abs(ts - ts_j)[:N_EXACT + 1 - lead].max() <= 1e-9
    assert np.abs(tds - tds_j).max() <= 3 * np.abs(tds_e - tds_j).max()
    assert np.abs(ps - ps_j).max() <= 3 * np.abs(ps_e - ps_j).max()
    gt_p, _ = runner.sim_ground_truth_at(data, ts + (0.006 - est.td))
    assert metrics.ape_rmse(ps, gt_p)["rmse"] < 0.15


def test_rolling_shutter_matches_jax():
    """tests/test_td.py::test_rolling_shutter_row_time_compensation's two
    features: bit for bit the JAX package's, and xyz[:2] - vel·tr·row."""
    tr = 0.03
    vel = np.array([0.5, -0.2])
    xyz = np.array([0.1, 0.2, 1.0])
    out = []
    for est in (Estimator(sim_config(rolling_shutter=True, rolling_shutter_tr=tr),
                          device="cpu"),
                JEstimator(jsim_config(rolling_shutter=True, rolling_shutter_tr=tr))):
        h = float(est.cfg.image_height)
        est.process_image({1: (xyz.copy(), np.array([100.0, 0.0]), vel),
                           2: (xyz.copy(), np.array([100.0, h]), vel)}, 0.0)
        out.append((est.fm.features[1].pts[0], est.fm.features[2].pts[0]))
    (top, bot), (top_j, bot_j) = out
    np.testing.assert_array_equal(top, top_j)
    np.testing.assert_array_equal(bot, bot_j)
    np.testing.assert_allclose(top[:2], xyz[:2], atol=1e-12)
    np.testing.assert_allclose(bot[:2], xyz[:2] - vel * tr, atol=1e-12)


def _calibrator_states(run_sim_fn, data, cfg, n, **kw):
    rec = []

    def on_frame(est, t, feats):
        c = est.ex_calibrator
        rec.append(dict(mode=est.estimate_extrinsic, ric=np.array(est.ric),
                        calib_ric=np.array(c.ric), n=len(c.q_cam),
                        q_cam=np.array(c.q_cam).reshape(-1, 4),
                        q_imu=np.array(c.q_imu).reshape(-1, 4)))

    est, traj = run_sim_fn(data, cfg, n_frames=n, on_frame=on_frame, **kw)
    return est, traj, rec


def test_extrinsic_mode2_calibrator_matches_jax(data):
    """estimate_extrinsic=2 from an identity R_ic: the pairs the
    calibrator holds, its solved R_ic and the estimator's mode, frame by
    frame over the first frames (the estimator does not initialize while
    it waits for the calibrator)."""
    ric = dict(estimate_extrinsic=2, ric=IDENTITY)
    _, traj, rec = _calibrator_states(runner.run_sim, data, sim_config(**ric), N_EX,
                                      device="cpu")
    _, traj_j, rec_j = _calibrator_states(jrunner.run_sim, data, jsim_config(**ric), N_EX)
    np.testing.assert_array_equal(traj["initialized"], traj_j["initialized"])
    assert not traj["initialized"].any()
    assert rec[-1]["n"] >= N_EX - 5
    for k, (a, b) in enumerate(zip(rec, rec_j)):
        assert a["mode"] == b["mode"] == 2, k
        assert a["n"] == b["n"], k
        np.testing.assert_allclose(a["q_imu"], b["q_imu"], rtol=0, atol=1e-12)
        # a quaternion and its negative are one rotation: the w >= 0 rule
        # fixes the sign in both packages
        np.testing.assert_allclose(a["q_cam"], b["q_cam"], rtol=0, atol=1e-12)
        np.testing.assert_array_equal(a["ric"], np.eye(3))   # not yet installed
        if a["n"] >= 3:   # one or two pairs leave the hand-eye null space open
            np.testing.assert_allclose(a["calib_ric"], b["calib_ric"], rtol=0,
                                       atol=1e-6, err_msg=str(k))


@pytest.mark.slow
def test_extrinsic_handover_matches_jax(data):
    """tests/test_ex_calib_online.py's 300 frames: the calibrator accepts
    (~8 s of pairs) at the same frame in both packages, with the same
    R_ic to 1e-6 rad, hands over to mode 1, and the estimator initializes
    on that frame with R_ic refined in BA, again to 1e-6 rad.  From there
    the BA's round-off decides: vio_tpu itself, given accelerometer
    samples changed by 1e-14 relative, ends 1.66e-3 rad from its own run
    at frame 299 (the port: 1.94e-3 rad; scripts/torch_round_off_spread.py
    handover), so the rest of the run is held to the reference's bounds
    in both packages."""
    ric = dict(estimate_extrinsic=2, ric=IDENTITY)
    est, traj, rec = _calibrator_states(runner.run_sim, data, sim_config(**ric), 300,
                                        device="cpu")
    est_j, traj_j, rec_j = _calibrator_states(jrunner.run_sim, data,
                                              jsim_config(**ric), 300)
    modes = [r["mode"] for r in rec]
    assert modes == [r["mode"] for r in rec_j]
    k = modes.index(1)                        # the handover frame
    assert 200 < k < 280 and rec[k]["n"] == rec_j[k]["n"]
    assert _angle(rec[k]["calib_ric"], rec_j[k]["calib_ric"]) <= 1e-6
    assert _angle(rec[k]["ric"], rec_j[k]["ric"]) <= 1e-6
    assert traj["initialized"][k] and traj_j["initialized"][k]
    assert not traj["initialized"][:k].any()
    for e, tr in ((est, traj), (est_j, traj_j)):
        assert e.estimate_extrinsic == 1
        assert np.degrees(_angle(np.asarray(e.ric), R_IC_GT)) < 2.0
        assert e.initialized and e.failure_count == 0
        gt_p, _ = runner.sim_ground_truth_at(data, tr["t"])
        assert metrics.ape_rmse(tr["p"], gt_p)["rmse"] < 0.1
    np.testing.assert_array_equal(traj["t"], traj_j["t"])
