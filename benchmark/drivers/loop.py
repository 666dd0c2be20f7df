"""Entry driver: the estimator with loop closing on, on the simulator's
feature stream with a descriptor per landmark.

The stream is ``features``' (``runner.feed_interval``, then each frame's
visible landmarks through ``Estimator.process_image``), and each frame
also hands in its features' descriptors: the traffic's
``descriptors: "landmark"`` is one fixed random 256-bit descriptor per
landmark id, drawn from the run's seed.  The configuration's
``loop_closure: 1`` makes the estimator own its loop closer, which takes
every keyframe inside ``process_image`` (BoW query, Hamming match and
PnP verification, and after an accepted loop a pose-graph solve) and
corrects the published pose by its drift.  One camera stream in a closed
loop: a frame is handed in when the last one's drift-corrected pose is
out.  Before the window opens, the closer captures the pose-graph graphs
of every size the window can reach (``window_graphs``), so that nothing
is captured inside it: the set-up counts those captures.

Recorders: ``program.FrameSteps`` (the window's frame steps),
``program.PoseGraphSolves`` (``sample_solves`` of the window's
pose-graph solves) and ``LoopEdges`` (every keyframe the window hands the
closer, and the loop it accepted).  The counters beside the program's:
the closer's keyframes, loops and solves, the pose graph's attempts,
iterations, poses, captures and their seconds, and its attempts by padded
P (``pg_attempts_P<P>``: a key for every P the stream can reach, so that
a slice's counters hold each one).
"""
from __future__ import annotations

import time

import numpy as np

from benchmark.drivers.features import _features
from benchmark.harness import program, traffic
from benchmark.harness.trace import Tracer

P_STEP = 192                  # the pose graph's padded P: 6 × a multiple of 32 poses
P_KEYS = range(P_STEP, 6 * 2048 + 1, P_STEP)
RATE_FRAMES = 150             # the warm-up's last frames, whose keyframes a second set the rate
AHEAD = 2.0                   # the window's keyframes at that rate, times this, are prepared


def window_graphs(n_now: int, rate: float, seconds: float, bucket: int) -> list[int]:
    """The pose-graph sizes, one a bucket of ``bucket`` poses, from the
    graph's ``n_now`` keyframes to those the window can reach: ``AHEAD``
    times the keyframes that ``rate`` a second adds in ``seconds``."""
    last = n_now + int(np.ceil(AHEAD * max(rate, 0.0) * seconds))
    first = -(-max(n_now, 1) // bucket) * bucket
    return list(range(first, last + bucket, bucket))


def descriptors(seed: int, n_landmarks: int) -> np.ndarray:
    """(L, 8) uint32: one packed 256-bit descriptor per landmark id."""
    return np.random.default_rng([seed, 1]).integers(
        0, 2 ** 32, size=(n_landmarks, 8), dtype=np.uint32)


class LoopEdges:
    """Every keyframe that the closer takes while the window is open: its
    time, and the loop it accepted (the old keyframe's time, the edge's
    dP and dq: the new body frame in the old one), or None; beside an
    accepted loop, the edge that the two keyframes' odometry poses give
    (``odometry``: what a closer that skipped verification would have to
    take).  Records go under "loops" in ``Run.recorded``."""

    def __init__(self, closer):
        self.closer = closer
        self.active = False
        self.records: list[dict] = []
        self._saved = None

    def install(self) -> None:
        from vio_tpu_torch.utils import lie_np
        add = self._saved = self.closer.add_keyframe

        def add_rec(t, *args, **kw):
            out = add(t, *args, **kw)
            if self.active:
                rec = dict(t=float(t), loop=None)
                if out is not None:
                    j, k, dP, dq = out
                    old, new = self.closer.kfs[j], self.closer.kfs[k]
                    rec["loop"] = dict(t_old=float(old.t), dP=np.array(dP, np.float64),
                                       dq=np.array(dq, np.float64))
                    rec["odometry"] = dict(t_old=float(old.t), dP=old.R.T @ (new.p - old.p),
                                           dq=lie_np.mat_to_quat_np(old.R.T @ new.R))
                self.records.append(rec)
            return out

        self.closer.add_keyframe = add_rec

    def uninstall(self) -> None:
        if self._saved is not None:
            self.closer.add_keyframe = self._saved
            self._saved = None


def counters(closer):
    """The program's counters and the loop closer's and pose graph's."""
    from vio_tpu_torch.loop import posegraph
    from vio_tpu_torch.ops import linsolve

    def read() -> dict:
        c = program.counters()
        st = posegraph.STATS
        c.update(cholesky_solves=linsolve.cholesky_solve.launches,
                 kf_added=closer.stats["keyframes"], loops_accepted=closer.stats["loops"],
                 kf_solves=closer.stats["solves"], pg_solves=st["solves"],
                 pg_attempts=st["attempts"], pg_iterations=st["iterations"],
                 pg_poses=st["poses"], pg_captures=st["captures"],
                 pg_capture_s=st["capture_s"])
        c.update({f"pg_attempts_P{P}": posegraph.ATTEMPTS_BY_P[P] for P in P_KEYS})
        return c
    return read


def prepare(closer, mark, seconds: float) -> None:
    """Capture the pose graph's keys of ``window_graphs``, at the rate of
    keyframes since ``mark`` (its time and the keyframes then)."""
    from vio_tpu_torch.loop import posegraph
    n = len(closer.kfs)
    rate = 0.0
    if mark is not None:
        rate = (n - mark[1]) / max(time.perf_counter() - mark[0], 1e-9)
    for size in window_graphs(n, rate, seconds, posegraph.POSE_BUCKET):
        closer.prepare(size)


def run(run, patch=None) -> None:
    import torch

    from vio_tpu_torch import runner
    from vio_tpu_torch.estimator import Estimator

    cell = run.cell
    cfg = traffic.vio_config(cell.config)
    data = traffic.generate(cell, run.seed, run.seconds)
    if cell.traffic.get("descriptors") != "landmark":
        raise SystemExit(f"traffic/{cell.entry['traffic']}.json: the loop driver needs "
                         f"descriptors: \"landmark\"")
    desc = descriptors(run.seed, len(data.landmarks))
    feats = [_features(data, k) for k in range(len(data.cam_t))]
    descs = [{lid: desc[lid] for lid in f} for f in feats]

    est_dtype = cell.config["estimator_dtype"]
    if run.control:
        est_dtype = cell.workload["control"].get("estimator_dtype", est_dtype)
    est = Estimator(cfg, device=run.device, dtype=getattr(torch, est_dtype))
    run._est = est
    if patch is not None:
        patch(run)
    check = cell.workload["check"]
    steps = program.FrameSteps(check["sample_frames"], run.seed)
    solves = program.PoseGraphSolves(check["sample_solves"], run.seed + 2)
    edges = LoopEdges(est.closer)
    run._recorders = (steps, solves, edges)
    for r in run._recorders:
        r.install()
    count = counters(est.closer)
    tracer = Tracer(run, count)

    n = len(data.cam_t)
    imu_i = 0
    t_prev = data.cam_t[0] + est.td
    k = 0
    warming = True
    c0 = t0 = None
    mark = None
    rate_from = max(cell.workload["warmup_frames"] - RATE_FRAMES, 1)
    while True:
        if k >= n:
            if warming:
                raise SystemExit("the stream ran out during the warm-up")
            run.exhausted(k)
        if warming and k == rate_from:
            mark = (time.perf_counter(), len(est.closer.kfs))
        if warming and k > 0 and run.warm(program.counters()["captures"]):
            warming = False
            prepare(est.closer, mark, run.seconds)
            if run.device != "cpu":
                torch.cuda.synchronize()
            c0, t0 = count(), len(est.telemetry)
            for r in run._recorders:
                r.active = True
            run.open_window()
        if not warming and not run.is_open():
            break
        t_in = time.perf_counter()
        with tracer.span("frame"):
            t = data.cam_t[k] + est.td
            if k > 0:
                with tracer.span("feed_imu"):
                    imu_i = runner.feed_interval(est, data.imu_t, data.acc, data.gyr,
                                                 t_prev, t, imu_i)
            t_prev = t
            fails = est.failure_count
            with tracer.span("process_image"):
                est.process_image(feats[k], t, descs[k])
            ok = est.initialized and est.failure_count == fails
            if ok:
                est.latest_pose()
        if not warming:
            run.frame(t_in, time.perf_counter(), ok, program.counters()["captures"])
            tracer.tick()
        k += 1
    tracer.stop()
    run.close_window()
    c1 = count()
    run.counts = {key: c1[key] - c0[key] for key in c0}
    run.telemetry = est.telemetry[t0:]
    for r in run._recorders:
        r.active = False
    run.records = steps.records
    run.recorded["posegraph"] = solves.records
    run.recorded["loops"] = edges.records


def release(run) -> None:
    for r in getattr(run, "_recorders", ()):
        r.uninstall()
    run._est = None
    program.release()
