"""Loop closing on the estimator's normal path (``VioConfig.loop_closure``,
VINS-Mono's flag): the estimator owns its ``LoopCloser``, hands it each
keyframe inside ``process_image`` and publishes the drift-corrected pose.
CPU, float64, a short run of the simulator's circuit with a small
``loop_min_gap`` and ``loop_train_after`` so that loops close within it.

Held: loops are accepted and each solved in the frame that found it
(``loop_ms`` and ``loop_solve_ms`` in its telemetry); every published
pose is the window's newest pose under the closer's ``live_correct`` at
that frame; the window is never rebased, so the frame steps' inputs and
outputs are bit for bit those of the same run with loop closing off,
which is the estimator as it was; ``process_image`` refuses a frame
without descriptors while loop closing is on; the pose graph's edges
are the keyframes' odometry and the loops; a failure reset starts
the closer anew; a checkpoint keeps its layout where loop closing is
off."""
import numpy as np
import pytest
import torch

from vio_tpu_torch import checkpoint, runner, sim
from vio_tpu_torch.config import sim_config
from vio_tpu_torch.estimator import Estimator
from vio_tpu_torch.solver import frame_step

torch.set_num_threads(1)

N_FRAMES = 64
LOOP = dict(loop_closure=1, loop_min_gap=4, loop_train_after=6)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _host(v) for k, v in x._asdict().items()}
    return np.array(x, copy=True)


def _run(cfg, monkeypatch):
    """``run_sim`` over the first N_FRAMES frames of a noisy stream that
    carries descriptors; returns the estimator, the trajectory, every
    frame step's inputs and outputs, and what each frame published
    beside the window's newest pose and the closer's correction of it."""
    data = sim.generate(noise=True, seed=3, descriptor_seed=7)
    steps, frames = [], []
    eager = frame_step.frame_step

    def recorded(*args, **kw):
        out = eager(*args, **kw)
        steps.append(([_host(a) for a in args], {k: v for k, v in kw.items()
                                                   if k not in ("device", "dtype")},
                      [_host(o) for o in out]))
        return out

    def on_frame(est, t, feats):
        if est.initialized:
            k = est.frame_count
            raw = (est.Ps[k].copy(), est.Rs[k].copy())
            fixed = raw if est.closer is None else est.closer.live_correct(*raw)
            frames.append((est.latest_pose(), raw, fixed))

    monkeypatch.setattr(frame_step, "frame_step", recorded)
    est, traj = runner.run_sim(data, cfg, n_frames=N_FRAMES, on_frame=on_frame, device="cpu")
    return est, traj, steps, frames


@pytest.fixture(scope="module")
def runs():
    out = []
    for cfg in (sim_config(**LOOP), sim_config()):
        mp = pytest.MonkeyPatch()
        try:
            out.append(_run(cfg, mp))
        finally:
            mp.undo()
    return tuple(out)


def test_the_flag_closes_loops_in_the_frame(runs):
    (est, traj, _, frames), _ = runs
    closer = est.closer
    assert est.failure_count == 0 and closer.device.type == "cpu"
    assert closer.dtype == est.dtype == torch.float64
    assert len(closer.loops) >= 2, len(closer.loops)
    assert closer.stats["loops"] == closer.stats["solves"] == len(closer.loops)
    assert closer.stats["keyframes"] == len(closer.kfs) > LOOP["loop_train_after"]
    solved = [t for t in est.telemetry if "loop_solve_ms" in t]
    assert len(solved) == len(closer.loops)
    assert all(t["loop_ms"] >= t["loop_solve_ms"] > 0 for t in solved)
    assert all("loop_query_ms" in t and "loop_verify_ms" in t for t in solved)
    # the closer's spans do not enter the frame step's solve_ms
    assert all(abs(t["solve_ms"] - t["pack_ms"] - t["step_ms"]) < 2e-3 for t in solved)
    assert all(kf.desc.dtype == np.uint32 and kf.desc.shape[1] == 8 for kf in closer.kfs)


def test_the_closers_edges_are_its_keyframes_odometry_and_its_loops(runs):
    """The pose graph's edges, built in one batch, are bit for bit each
    consecutive pair's relative pose (R_kᵀ (p_k+1 - p_k), R_kᵀ R_k+1) at
    weight 1, then the accepted loops at the loop weight; ``prepare``
    captures nothing on the CPU."""
    from vio_tpu_torch.utils import lie_np
    (est, _, _, _), _ = runs
    closer = est.closer
    K = len(closer.kfs)
    ei, ej, dPs, dqs, w = closer._edges(K)
    kfs = closer.kfs
    want_dP = [kfs[k].R.T @ (kfs[k + 1].p - kfs[k].p) for k in range(K - 1)]
    want_dq = [lie_np.mat_to_quat_np(kfs[k].R.T @ kfs[k + 1].R) for k in range(K - 1)]
    want_dP += [l[2] for l in closer.loops]
    want_dq += [l[3] for l in closer.loops]
    np.testing.assert_array_equal(ei, [*range(K - 1), *(l[0] for l in closer.loops)])
    np.testing.assert_array_equal(ej, [*range(1, K), *(l[1] for l in closer.loops)])
    np.testing.assert_array_equal(dPs, np.stack(want_dP))
    np.testing.assert_array_equal(dqs, np.stack(want_dq))
    np.testing.assert_array_equal(w, [1.0] * (K - 1) + [closer.loop_weight] * len(closer.loops))
    assert closer.prepare(K + 40) == 0


def test_published_poses_are_the_windows_under_the_closers_drift(runs):
    (est, traj, _, frames), _ = runs
    assert len(frames) == len(traj["t"]) > 0
    for (t, p, R), raw, (pc, Rc) in frames:
        np.testing.assert_array_equal(p, pc)
        np.testing.assert_array_equal(R, Rc)
    np.testing.assert_array_equal(traj["p"], np.stack([f[0][1] for f in frames]))
    # after the loops the drift is not the identity, so the two differ
    moved = [np.abs(f[0][1] - f[1][0]).max() for f in frames]
    assert max(moved) > 0
    assert np.linalg.norm(est.closer.drift_t) > 0


def test_loop_closing_leaves_every_frame_step_bit_identical(runs):
    """The same frames with loop closing off (the estimator as it was,
    ``closer`` None) make the same frame steps, bit for bit: the closer
    reads the window and never writes it (fast_relocalization 0)."""
    (est_on, _, steps_on, _), (est_off, traj_off, steps_off, frames_off) = runs
    assert est_off.closer is None and est_off.cfg.loop_closure == 0
    assert len(steps_on) == len(steps_off) > 20
    for (a_on, kw_on, o_on), (a_off, kw_off, o_off) in zip(steps_on, steps_off):
        assert kw_on == kw_off
        for x, y in zip(a_on + o_on, a_off + o_off):
            if isinstance(x, dict):
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
            else:
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(est_on.Ps, est_off.Ps)
    np.testing.assert_array_equal(est_on.b_prior, est_off.b_prior)
    for (pub, raw, _) in frames_off:      # no closer: the window's pose as it is
        np.testing.assert_array_equal(pub[1], raw[0])
    assert not any("loop_ms" in t for t in est_off.telemetry)


def test_a_failure_reset_starts_the_closer_anew(monkeypatch):
    """A failure reset starts a new world frame: once a loop has moved the
    drift, a forced failure empties the closer (no keyframe of the old
    frame is left to join the new one by an odometry edge) and sets its
    drift back to the identity, so until a loop links the new frame the
    estimator publishes its window's pose as it is."""
    fail = {}
    detect = Estimator._failure_detection

    def once_after_a_loop(est):
        if est.closer.loops and not fail:
            fail.update(t=est.headers[est.frame_count], loops=len(est.closer.loops),
                        frame=len(frames))
            return True
        return detect(est)

    frames = []

    def on_frame(est, t, feats):
        if est.initialized:
            k = est.frame_count
            frames.append((est.latest_pose(), (est.Ps[k].copy(), est.Rs[k].copy()),
                           len(est.closer.loops)))

    monkeypatch.setattr(Estimator, "_failure_detection", once_after_a_loop)
    data = sim.generate(noise=True, seed=3, descriptor_seed=7)
    est, _ = runner.run_sim(data, sim_config(**LOOP), n_frames=N_FRAMES, on_frame=on_frame,
                            device="cpu")
    assert fail, "no loop before the stream ended"
    closer = est.closer
    assert closer.stats["loops"] >= fail["loops"] > 0
    assert all(kf.t > fail["t"] for kf in closer.kfs)
    assert len(closer.loops) == closer.stats["loops"] - fail["loops"]
    after = frames[fail["frame"]:]
    assert after and est.initialized
    for (_, p, R), (p_raw, R_raw), n_loops in after:
        if n_loops == 0:
            np.testing.assert_array_equal(p, p_raw)
            np.testing.assert_array_equal(R, R_raw)
    if not closer.loops:
        np.testing.assert_array_equal(closer.drift_R, np.eye(3))
        np.testing.assert_array_equal(closer.drift_t, np.zeros(3))


def test_process_image_needs_descriptors_while_loop_closing_is_on():
    est = Estimator(sim_config(**LOOP), device="cpu")
    assert est.closer is not None
    with pytest.raises(ValueError, match="descriptors"):
        est.process_image({}, 0.0)
    off = Estimator(sim_config(), device="cpu")
    assert off.closer is None
    off.process_image({}, 0.0)


def test_checkpoint_keeps_its_layout_without_loop_closing():
    """A file written with loop closing off names no loop field (the JAX
    package's configuration has none); a file written with it on keeps
    the flag and the settings that differ from their defaults."""
    assert not any(k.startswith("loop_") for k in checkpoint._cfg_fields(sim_config()))
    on = checkpoint._cfg_fields(sim_config(**LOOP))
    assert {k for k in on if k.startswith("loop_")} == set(LOOP)
