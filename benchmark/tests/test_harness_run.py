"""A run's last line: its keys and types, on the CPU at a small size."""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from _small import run_cell

ROOT = Path(__file__).resolve().parents[2]


def _shape(out: dict, metrics: list[str]):
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert isinstance(out["correct"], bool)
    assert isinstance(out["attempted"], int) and out["attempted"] > 0
    assert isinstance(out["failed"], int) and 0 <= out["failed"] <= out["attempted"]
    assert set(out["metrics"]) == set(metrics)
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    d = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(d)
    for n in out["check"].values():
        assert set(n) == {"value", "limit"}
        assert n["value"] is not None and math.isfinite(n["value"])


def test_features_cell_line():
    out = run_cell("sim_features", 2 ** 31 + 101)
    _shape(out, ["frames_per_s", "frame_ms_p95", "setup_s"])
    assert out["failed"] == 0
    assert set(out["check"]) == {"window_cost_left", "marg_H_gap", "marg_b_gap",
                                 "prior_shift_gap", "prior_chain_gap", "refix_gap"}


def test_features_cell_traced_line():
    out = run_cell("sim_features", 2 ** 31 + 102, trace=True)
    # no device trace on the CPU: the readers of spans and counters read
    _shape(out, ["estimator_host_ms", "marg_ms", "frame_step_ms",
                 "lm_iterations_per_frame", "graph_captures"])


def test_command_prints_one_json_line_last():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sim_features",
                          "--seed", str(2 ** 31 + 104), "--seconds", "1", "--trace", "0",
                          "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert "correct" in line and "check" in line
    tail = out.stderr.strip().splitlines()[-3:]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_forbidden_module_no_result(monkeypatch, capsys):
    """A forbidden module loaded by the time the result is due, by the
    reference or a reader too, stops the run before its result line."""
    import types

    from benchmark.harness import core
    out = run_cell("sim_features", 2 ** 31 + 105, seconds=1.0)
    out["_run"] = type("R", (), dict(counts={}, _warm=0, setup_s=0.0, n_frames=0, check_s=0.0,
                                     judged=[], capture_log=[], trace_summary=None))()
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(SystemExit, match="jax"):
        core.report(out)
    assert '"correct"' not in capsys.readouterr().out


def test_no_card_no_result():
    """Without a CUDA device the benchmark exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sim_features",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout
