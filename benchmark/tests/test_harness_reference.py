"""The plain reference follows the program's float64 frame step to
round-off, at the small size of a CPU run."""
import time

from benchmark.drivers import features
from benchmark.harness import core
from benchmark.reference import prior, window


def test_reference_follows_the_float64_frame_step():
    cell = core.Cell("sim_features")
    cell.config["estimator_dtype"] = "float64"
    cell.workload["warmup_frames"] = 30
    cell.workload["check"]["sample_frames"] = 6
    run = core.Run(cell, 2 ** 31 + 301, 2.0, False, "cpu", time.perf_counter())
    features.run(run)
    try:
        assert run.records
        left = []
        for r in run.records:
            ref = window.solve(r)
            # an LM decision at its stop threshold may flip between the two
            gap = abs(ref["states"]["Ps"] - r["outputs"]["states"]["Ps"]).max()
            assert gap < 1e-4
            j = window.judge(r)
            assert j["refix_gap"] < 1e-12
            assert j["marg_H_gap"] is None or j["marg_H_gap"] < 1e-12
            assert j["marg_b_gap"] is None or j["marg_b_gap"] < 1e-10
            assert j["prior_shift_gap"] < 1e-3
            chain = prior.judge(r, 1.0)
            assert chain is None or chain < 1e-3
            # a flipped stop decision moves the cost by about the LM's stop
            # threshold (1e-5); the median share left stays at round-off
            assert abs(j["cost_gap_out"]) < 1e-4
            left.append(abs(j["cost_gap_out"]) / j["cost_gap_in"])
        assert sorted(left)[len(left) // 2] < 1e-6
    finally:
        features.release(run)
