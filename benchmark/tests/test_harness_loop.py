"""The loop cell on the CPU at a size a test can hold: the ``loop``
driver's run and its line, the ``loops`` judge sound on the closer's own
verified edges and over its limits for each fault, and the six readers of
the loop cell on hand-built runs."""
import time
import types

import numpy as np
import pytest
import torch

from benchmark.harness import core, stream
from benchmark.reference import check
from benchmark.reference.judges import loops as loops_judge

CELL = "sim_features_loop"
LIMITS = core.Cell(CELL).workload["check"]["limits"]
READERS = ("loop_ms", "posegraph_solve_ms", "posegraph_iterations_per_solve",
           "posegraph_poses", "posegraph_capture_s", "posegraph_solve_roofline")


# -- the driver ---------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_run():
    """A traced CPU run: 60 warm-up frames and a window of 25 frames (held
    by count, not by the host's speed: a few keyframes), the closer's gap
    and training cut so that its keyframes loop."""
    cell = core.Cell(CELL)
    cell.workload["warmup_frames"] = 60
    cell.workload["check"]["sample_frames"] = 6
    cell.workload["check"]["sample_solves"] = 3
    cell.config["settings"].update(loop_min_gap=4, loop_train_after=6)
    args = core.parse(["--workload", CELL, "--seed", str(2 ** 31 + 901), "--seconds", "600",
                       "--trace", "1", "--device", "cpu"])

    def by_frames(run):
        run.is_open = lambda: run.n_frames < 25

    out = core.execute(args, time.perf_counter(), cell=cell, patch=by_frames)
    return out, out.pop("_run")


def test_loop_driver_line_and_records(cpu_run):
    out, run = cpu_run
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["check"]) == set(LIMITS)
    # the CPU's early loops join keyframes seconds apart, not a lap: the
    # edges' numbers are read, not held to the cell's limits, here
    for k in ("window_cost_left", "posegraph_cost_left", "posegraph_pose_gap",
              "posegraph_fix_gap", "loop_miss_share"):
        assert out["check"][k]["value"] is not None, k
    for k in ("posegraph_pose_gap", "posegraph_fix_gap"):
        assert out["check"][k]["value"] <= LIMITS[k], k
    keyframes = run.recorded["loops"]
    assert len(keyframes) == run.counts["kf_added"] > 0
    loops = [r for r in keyframes if r["loop"] is not None]
    assert len(loops) == run.counts["loops_accepted"] == run.counts["pg_solves"]
    # beside each accepted edge, the one its keyframes' odometry gives
    assert all(set(r) == ({"t", "loop", "odometry"} if r["loop"] else {"t", "loop"})
               for r in keyframes)
    assert len(run.recorded["posegraph"]) == min(3, run.counts["pg_solves"])
    assert sum(v for k, v in run.counts.items() if k.startswith("pg_attempts_P")) == \
        run.counts["pg_attempts"]
    # the traced line on the CPU: the readers of spans and counters read;
    # the rooflines and the idle share (a device trace) and the graphed
    # frame step's slab, waits and reads (the card's) do not
    assert set(out["metrics"]) == {"loop_ms", "posegraph_solve_ms",
                                   "posegraph_iterations_per_solve", "posegraph_poses",
                                   "posegraph_capture_s", "marg_ms", "frame_step_ms",
                                   "lm_iterations_per_frame", "graph_captures"}
    assert out["metrics"]["posegraph_capture_s"]["value"] == 0.0


@pytest.mark.parametrize("n_now, rate, want", [
    (400, 3.75, [416, 448, 480, 512, 544]),     # 400 + 2 × 3.75 × 16 = 520 keyframes
    (416, 0.0, [416]),                          # no keyframes: the graph's own bucket
    (1, 1.0, [32, 64]),                         # 1 + 32 keyframes
])
def test_the_window_graphs_reach_twice_the_warm_ups_keyframes(n_now, rate, want):
    from benchmark.drivers import loop
    assert loop.window_graphs(n_now, rate, 16.0, 32) == want


def test_prepare_hands_the_closer_each_size_before_the_window():
    """The sizes go to ``LoopCloser.prepare`` at the rate since the mark;
    without a mark, the graph's own bucket alone."""
    from benchmark.drivers import loop
    sizes = []
    closer = types.SimpleNamespace(kfs=[None] * 100, prepare=sizes.append)
    loop.prepare(closer, (time.perf_counter() - 10.0, 60), 16.0)
    # 40 keyframes in ~10 s: ≥ 100 + 2 × 4 × 16 × (10 / 10.x) keyframes
    assert sizes[0] == 128 and sizes == list(range(128, sizes[-1] + 1, 32))
    assert 192 <= sizes[-1] <= 256
    sizes.clear()
    loop.prepare(closer, None, 16.0)
    assert sizes == [128]


# -- the loops judge ------------------------------------------------------------

def _keyframes(drift_m=0.004, drift_deg=0.02, every=10, laps=1.4, seed=5):
    """Keyframes along the simulator's circuit, every ``every`` frames,
    with their true landmarks in the camera frame and an odometry that
    drifts by ``drift_m`` and ``drift_deg`` of yaw a keyframe; fed to a
    closer (gap 30 keyframes, trained after 10).  Returns the window's
    records (the second lap's keyframes) as ``LoopEdges`` keeps them, with
    the edge that odometry alone gives beside each loop."""
    from benchmark.drivers.loop import LoopEdges, descriptors
    from vio_tpu_torch.loop.closer import LoopCloser
    from vio_tpu_torch.utils import lie_np
    data = stream.generate(noise=False, t_end=20.0 * laps)
    desc = descriptors(seed, len(data.landmarks))
    R_bc = np.array([[0.0, 0, -1], [-1, 0, 0], [0, 1, 0]])
    closer = LoopCloser(R_ic=R_bc, t_ic=np.array([0.05, 0.04, 0.03]), min_gap=30,
                        train_after=10, device="cpu", dtype=torch.float64)
    rec = LoopEdges(closer)
    rec.install()
    frames = range(0, len(data.cam_t), every)
    for n, k in enumerate(frames):
        lids = np.flatnonzero(data.obs_valid[k])
        xy = data.obs_xy[k, lids]
        pts = (data.landmarks[lids] - data.cam_p[k]) @ data.cam_R[k]
        dR = lie_np.ypr_to_mat_np(np.array([drift_deg * n, 0.0, 0.0]))
        p, R = dR @ data.imu_p[k] + drift_m * n, dR @ data.imu_R[k]
        rec.active = data.cam_t[k] >= 20.0
        closer.add_keyframe(data.cam_t[k], p, R, desc[lids], xy, pts_cam=pts, pts_xy=xy)
    rec.uninstall()
    return rec.records


@pytest.fixture(scope="module")
def keyframes():
    return _keyframes()


def _judged(records):
    return loops_judge.judge(types.SimpleNamespace(), records, {})[0]


def test_loops_judge_sound_on_the_closers_verified_edges(keyframes):
    numbers = _judged(keyframes)
    assert sum(r["loop"] is not None for r in keyframes) >= 5
    for k in ("loop_edge_m", "loop_edge_deg", "loop_edge_odometry_share", "loop_miss_share"):
        assert numbers[k] < LIMITS[k], (k, numbers[k])
    assert numbers["loop_edge_m"] < 1e-3 and numbers["loop_edge_deg"] < 1e-2
    assert numbers["loop_edge_odometry_share"] == 0.0


def _corrupt(records, how):
    out = []
    for r in records:
        r = dict(r)
        if r["loop"] is not None:
            if how == "dropped":
                r["loop"] = None
            elif how == "unverified":
                r["loop"] = r["odometry"]
            elif how == "edge_m":
                r["loop"] = dict(r["loop"], dP=r["loop"]["dP"] + [0.0, 0.5, 0.0])
            elif how == "edge_deg":
                q = np.asarray(r["loop"]["dq"])
                tilt = np.array([np.sin(np.radians(1.0)), 0.0, 0.0, np.cos(np.radians(1.0))])
                x1, y1, z1, w1 = q
                x2, y2, z2, w2 = tilt
                r["loop"] = dict(r["loop"], dq=np.array([
                    w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2, w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                    w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2, w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2]))
        out.append(r)
    return out


@pytest.mark.parametrize("how, number", [("dropped", "loop_miss_share"),
                                         ("unverified", "loop_edge_odometry_share"),
                                         ("unverified", "loop_edge_m"),
                                         ("edge_m", "loop_edge_m"),
                                         ("edge_deg", "loop_edge_deg")])
def test_loops_judge_fails_each_fault(keyframes, how, number):
    """Every loop dropped reads a miss share of 1; an edge taken from the
    drifting odometry unverified is the odometry's edge on every loop (and,
    on this stream, which drifts 4 mm a keyframe, reads over the edge's
    limit in metres too); an edge moved by 0.5 m or turned by 2° reads
    over the edge's limit."""
    numbers = _judged(_corrupt(keyframes, how))
    assert numbers[number] is None or numbers[number] > LIMITS[number], numbers
    if how == "unverified":
        assert numbers["loop_edge_odometry_share"] == 1.0


def test_loops_judge_truth_is_the_simulators():
    """The judge's truth is the closed-form trajectory: an edge that is the
    true relative pose reads 0."""
    from vio_tpu_torch.utils import lie_np
    m = stream.motion_model(np.array([3.0, 23.1]))
    (p0, p1), (R0, R1) = m["p_wb"], m["R_wb"]
    rec = dict(t=23.1, loop=dict(t_old=3.0, dP=R0.T @ (p1 - p0),
                                 dq=lie_np.mat_to_quat_np(R0.T @ R1)))
    e = loops_judge.edge_errors(rec)
    assert e["edge_m"] < 1e-12 and e["edge_deg"] < 1e-5
    assert _judged([rec, dict(t=24.0, loop=None)])["loop_miss_share"] == 0.5
    assert _judged([rec])["loop_edge_odometry_share"] is None    # no odometry edge beside it
    odo = dict(rec, odometry=dict(rec["loop"], dP=rec["loop"]["dP"] + [0.0, 0.0, 2e-6]))
    assert _judged([odo])["loop_edge_odometry_share"] == 0.0
    odo["odometry"]["dP"] = rec["loop"]["dP"] + [0.0, 0.0, 5e-7]
    assert _judged([odo, dict(t=24.0, loop=None)])["loop_edge_odometry_share"] == 1.0
    assert _judged([]) == dict(loop_edge_m=None, loop_edge_deg=None,
                               loop_edge_odometry_share=None, loop_miss_share=None)


def test_the_cell_names_its_judges_and_limits():
    w = core.Cell(CELL).workload
    assert w["check"]["judges"] == ["window", "prior", "posegraph", "loops"]
    run = types.SimpleNamespace(cell=types.SimpleNamespace(name=CELL, workload=w,
                                                           config=core.Cell(CELL).config),
                                control=False, reference_device="cpu", recorded={})
    numbers = check.evaluate(run)
    assert set(numbers) == set(LIMITS) and all(n["value"] is None for n in numbers.values())


# -- the readers ------------------------------------------------------------------

def _read(name, **run):
    import importlib
    base = dict(telemetry=[], counts={}, trace_summary=None, host_frames=0, traced_from=None,
                cell=types.SimpleNamespace(config=dict(estimator_dtype="float64")))
    base.update(run)
    r = types.SimpleNamespace(**base)
    r.host_telemetry = lambda: r.telemetry[:r.host_frames]
    return importlib.import_module(f"benchmark.metrics.{name}").read(r)


def test_loop_readers_on_hand_built_runs():
    tel = [dict(solve_ms=20.0), dict(solve_ms=20.0, loop_ms=40.0, loop_solve_ms=30.0),
           dict(solve_ms=20.0, loop_ms=4.0), dict(solve_ms=20.0, loop_ms=60.0,
                                                   loop_solve_ms=50.0)]
    assert _read("loop_ms", telemetry=tel, host_frames=4) == pytest.approx(26.0)
    assert _read("loop_ms", telemetry=tel, host_frames=2) == pytest.approx(20.0)
    assert _read("posegraph_solve_ms", telemetry=tel, host_frames=4) == pytest.approx(40.0)
    assert _read("posegraph_solve_ms", telemetry=tel, host_frames=1) is None
    counts = dict(pg_solves=4, pg_iterations=30, pg_poses=1800, pg_capture_s=0.75)
    assert _read("posegraph_iterations_per_solve", counts=counts) == 7.5
    assert _read("posegraph_poses", counts=counts) == 450.0
    assert _read("posegraph_capture_s", counts=counts) == 0.75
    for name in READERS:                      # a run of a program without the closer
        assert _read(name, telemetry=[dict(solve_ms=1.0)], host_frames=1,
                     counts=dict(captures=0)) is None, name


def test_posegraph_solve_roofline_counts_every_padded_size():
    from benchmark.roofline import counts as rc
    lo, hi = 1152, 2880
    s = dict(counters={f"pg_attempts_P{lo}": 5, f"pg_attempts_P{hi}": 8, "captures": 0},
             kernel_s={"void kernel<getrf_wo_pivot_params_<double> >": 0.004,
                       "void trsv_lt_exec<double>": 0.0005, "void trsv_ln_exec<double>": 0.0005,
                       "gj_blk_update": 0.5, "void at::native::elementwise_kernel": 0.3})
    want = 100.0 * (5 * rc.spd_solve_s(lo, "float64") + 8 * rc.spd_solve_s(hi, "float64")) / 0.005
    assert _read("posegraph_solve_roofline", trace_summary=s) == pytest.approx(want)
    assert 0 < want < 100
    assert _read("posegraph_solve_roofline",
                 trace_summary=dict(s, counters={"captures": 0})) is None
    assert _read("posegraph_solve_roofline",
                 trace_summary=dict(s, kernel_s={"gj_blk_update": 1.0})) is None
