"""The check finds its judges by name, and the pose graph's judge reads
sound solves under its thresholds and each fault over one of them."""
import time
import types

import numpy as np
import pytest
import torch

from _small import run_cell
from benchmark.drivers import features
from benchmark.harness import core, program
from benchmark.reference import check, prior, window
from benchmark.reference.judges import posegraph as posegraph_judge

SIX = ("window_cost_left", "marg_H_gap", "marg_b_gap", "prior_shift_gap", "prior_chain_gap",
       "refix_gap")


# -- dispatch ---------------------------------------------------------------

def test_default_judges_give_todays_six_numbers():
    """A workload with no ``judges`` is judged by the window and the prior
    chain, with the reductions the check has always made: the median of
    the cost ratios, the widest of every gap."""
    cell = core.Cell("sim_features")
    assert "judges" not in cell.workload["check"]
    cell.workload["warmup_frames"] = 30
    cell.workload["check"]["sample_frames"] = 6
    run = core.Run(cell, 2 ** 31 + 501, 2.0, False, "cpu", time.perf_counter())
    features.run(run)
    features.release(run)
    numbers = check.evaluate(run)
    assert tuple(numbers) == tuple(cell.workload["check"]["limits"]) and set(numbers) == set(SIX)
    lam = float(cell.config["settings"]["prior_forgetting"])
    js = [window.judge(r) for r in run.records]
    for k in ("marg_H_gap", "marg_b_gap", "prior_shift_gap", "refix_gap"):
        vals = [j[k] for j in js if j[k] is not None]
        assert numbers[k]["value"] == (max(vals) if vals else None), k
    left = [j["cost_gap_out"] / j["cost_gap_in"] for j in js if j["cost_gap_in"] > 0]
    assert numbers["window_cost_left"]["value"] == float(np.median(left))
    chain = [v for v in (prior.judge(r, lam) for r in run.records) if v is not None]
    assert numbers["prior_chain_gap"]["value"] == max(chain)
    # each judge's per-record lines, under its name, and no other recorder's
    assert [n for n, _ in run.judged] == ["window"] * len(js) + ["prior"] * len(js)


def test_limit_that_no_judge_gives_is_not_correct():
    def add_limit(run):
        run.cell.workload["check"]["limits"]["posegraph_cost_left"] = 1e-4
    out = run_cell("sim_features", 2 ** 31 + 502, patch=add_limit)
    assert out["check"]["posegraph_cost_left"]["value"] is None
    assert all(out["check"][k]["value"] <= out["check"][k]["limit"] for k in SIX)
    assert out["correct"] is False


def _bare_run(judges, limits):
    cell = types.SimpleNamespace(name="c", workload=dict(check=dict(judges=judges, limits=limits)))
    return types.SimpleNamespace(cell=cell, control=False, reference_device="cpu",
                                 recorded={"frame_steps": [], "posegraph": []})


@pytest.mark.parametrize("judges, limits", [
    (["window"], {k: 1.0 for k in SIX if k not in ("refix_gap", "prior_chain_gap")}),
    (["posegraph"], {"posegraph_cost_left": 1e-4, "posegraph_pose_gap": 1e-8,
                     "posegraph_fix_gap_": 1e-10}),
])
def test_number_without_a_limit_stops_the_run(judges, limits):
    """A number that a judge gives and the workload does not limit (left
    out, or misspelt) is an error, not a pass."""
    with pytest.raises(SystemExit, match="no limit"):
        check.evaluate(_bare_run(judges, limits))


def test_judge_sees_only_its_recorders_records():
    run = _bare_run(["posegraph"], {"posegraph_cost_left": 1e-4, "posegraph_pose_gap": 1e-8,
                                    "posegraph_fix_gap": 1e-10})
    run.recorded["frame_steps"] = [object()]     # a judge of solves would fail on it
    numbers = check.evaluate(run)
    assert all(n["value"] is None for n in numbers.values()) and run.judged == []


# -- the pose graph's judge ---------------------------------------------------

# The thresholds the judge's numbers are held to here, each between what
# the sound eager solve reads in float64 and what a fault reads, on these
# circuits:
# - cost left 1e-4 (window_cost_left's limit): a sound solve leaves
#   round-off (|·| under 1e-18), doing nothing leaves 1;
# - pose gap 1e-8: the reference takes the same LM steps in float64 with
#   its own rounding (under 1e-14 of the correction); a float32 solve is
#   off by ~1e-6 of it, a solve cut short or of a changed problem by 1e-2;
# - fix gap 1e-10 (refix_gap's limit): pose 0 is held bit for bit (its
#   quaternion renormalised, under 1e-18); float32 rounds it by over 1e-9.
COST_LEFT, POSE_GAP, FIX_GAP = 1e-4, 1e-8, 1e-10
LIMITS = dict(posegraph_cost_left=COST_LEFT, posegraph_pose_gap=POSE_GAP,
              posegraph_fix_gap=FIX_GAP)
# drifting circuits: poses on both sides of POSE_BUCKET = 32 and edges on
# both sides of EDGE_BUCKET = 64 (the loops come after the odometry edges)
LOOPS3 = ((0, -1), (1, -2), (3, -1))
CIRCUITS = [(31, LOOPS3), (33, LOOPS3), (60, LOOPS3), (62, LOOPS3 + ((5, -3), (10, -8)))]
MAX_ITER = 40                      # the loop closer's


def _solves(n, loops, seed):
    from vio_tpu_torch import testing
    from vio_tpu_torch.loop import posegraph as pg
    assert (n < pg.POSE_BUCKET or n > pg.POSE_BUCKET) and n + len(loops) - 1 != pg.EDGE_BUCKET
    _, _, args, w = testing.posegraph_circuit(n, seed, loops)
    return args, w


def _judged(monkeypatch, args, w, fault=None, k=2, calls=1):
    """The recorder over ``optimize`` (with ``fault`` planted underneath),
    the closer's call made ``calls`` times, the records judged."""
    from vio_tpu_torch.loop import posegraph as pg
    if fault is not None:
        monkeypatch.setattr(pg, "optimize", fault)
    rec = program.PoseGraphSolves(k, 2 ** 31 + 601)
    rec.install()
    try:
        rec.active = True
        for _ in range(calls):
            pg.optimize(*args, edge_weights=w, max_iter=MAX_ITER, device="cpu",
                        dtype=torch.float64)
    finally:
        rec.uninstall()
    numbers, items = posegraph_judge.judge(types.SimpleNamespace(reference_device="cpu"),
                                           rec.records, {})
    return numbers, items, rec


@pytest.mark.parametrize("n, loops", CIRCUITS)
def test_posegraph_judge_reads_the_eager_float64_solve_sound(monkeypatch, n, loops):
    args, w = _solves(n, loops, seed=n)
    numbers, items, rec = _judged(monkeypatch, args, w)
    assert len(items) == 1 and items[0]["poses"] == n and items[0]["edges"] == len(args[2])
    assert items[0]["cost_gap_in"] > 1.0         # the drift leaves a cost to reduce
    for k, limit in LIMITS.items():
        assert abs(numbers[k]) < limit, (k, numbers[k])


def test_posegraph_recorder_samples_the_window_only(monkeypatch):
    from vio_tpu_torch.loop import posegraph as pg
    args, w = _solves(31, LOOPS3, seed=7)
    rec = program.PoseGraphSolves(2, 2 ** 31 + 602)
    orig = pg.optimize
    rec.install()
    try:
        pg.optimize(*args, edge_weights=w, max_iter=MAX_ITER, device="cpu", dtype=torch.float64)
        assert rec.records == []                 # the window is not open
        rec.active = True
        for _ in range(4):
            out = pg.optimize(*args, edge_weights=None, max_iter=MAX_ITER, device="cpu",
                              dtype=torch.float32)
    finally:
        rec.uninstall()
    assert pg.optimize is orig and len(rec.records) == 2
    r = rec.records[0]
    assert r["inputs"]["Ps0"].dtype == np.float64 and r["outputs"]["Ps"].dtype == np.float64
    assert np.array_equal(r["inputs"]["w"], np.ones(len(args[2])))
    assert r["inputs"]["fix_first"] is True and r["inputs"]["max_iter"] == MAX_ITER
    assert np.array_equal(r["outputs"]["Ps"], out[0])
    r["inputs"]["Ps0"][0] += 1.0                 # a copy: the caller's arrays stay
    assert not np.array_equal(r["inputs"]["Ps0"][0], args[0][0])


def _fault(how):
    """The pose-graph solve broken in one way, called as the closer calls it."""
    from vio_tpu_torch.loop import posegraph as pg
    from vio_tpu_torch.solver import generic
    eager = pg.optimize_eager

    def broken(Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq, edge_weights=None,
               fix_first=True, max_iter=50, *, device, dtype):
        a = (Ps0, qs0, edges_i, edges_j, edges_dP, edges_dq)
        if how == "no_solve":
            return np.array(Ps0), np.array(qs0), {}
        if how == "one_attempt":
            g = pg.PoseGraph(*(torch.as_tensor(x) for x in pg.padded(*a, edge_weights)))
            q, x0, unpack = pg.problem(g, max_iter)
            Ps, qs = unpack(generic.attempt(generic.start(q, x0), q).x)
            return Ps.numpy()[:len(Ps0)], qs.numpy()[:len(Ps0)], {}
        if how == "loop_edge_dropped":
            a, edge_weights = (*a[:2], *(x[:-1] for x in a[2:])), edge_weights[:-1]
        elif how == "weights_ignored":
            edge_weights = None
        elif how == "pose0_moved":
            fix_first = False
        elif how == "float32":
            dtype = torch.float32
        return eager(*a, edge_weights, fix_first, max_iter, device=device, dtype=dtype)
    return broken


@pytest.mark.parametrize("n, loops", CIRCUITS)
@pytest.mark.parametrize("how, number", [("no_solve", "posegraph_cost_left"),
                                         ("one_attempt", "posegraph_pose_gap"),
                                         ("loop_edge_dropped", "posegraph_pose_gap"),
                                         ("weights_ignored", "posegraph_pose_gap"),
                                         ("pose0_moved", "posegraph_fix_gap"),
                                         ("float32", "posegraph_pose_gap")])
def test_posegraph_judge_fails_each_fault(monkeypatch, n, loops, how, number):
    args, w = _solves(n, loops, seed=n)
    numbers, _, _ = _judged(monkeypatch, args, w, fault=_fault(how))
    assert numbers[number] > LIMITS[number], numbers
