"""The port's command line (vio_tpu_torch/cli.py) and plots
(vio_tpu_torch/viz.py) on the CPU: ``run --dataset sim`` against the
JAX package's own run of the same frames, ``sim --out`` read back by both
packages' readers, and every plot written as a non-empty PNG from tensors
and from arrays."""
import json
import os

import numpy as np
import pytest
import torch

from vio_tpu import io as jio
from vio_tpu import runner as jrunner
from vio_tpu import sim as jsim
from vio_tpu_torch import bench, cli, io as tio, viz
from vio_tpu_torch.calib import allan
from vio_tpu_torch.solver.generic import LMLog

torch.set_num_threads(1)
N = 20


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_run_sim_matches_jax(capsys, tmp_path):
    """20 frames through ``run --dataset sim --device cpu``: the JSON
    line, the TUM file and the telemetry, against vio_tpu.runner.run_sim
    over the same frames (trajectories 1e-6 m, as test_torch_e2e_sim)."""
    tum, log = str(tmp_path / "traj.tum"), str(tmp_path / "solves.jsonl")
    cli.main(["run", "--dataset", "sim", "--frames", str(N), "--device", "cpu",
              "--out", tum, "--log-jsonl", log])
    out = _last_json(capsys)
    assert out["dataset"] == "sim" and out["device"] == "cpu" and out["dtype"] == "float64"
    assert out["failures"] == 0 and out["gj_solve_launches"] == 0   # the CPU runs the plain version
    _, traj_j = jrunner.run_sim(jsim.generate(noise=False), n_frames=N)
    assert out["frames"] == len(traj_j["t"]) > 0
    rows = np.loadtxt(tum, ndmin=2)
    np.testing.assert_allclose(rows[:, 0], traj_j["t"], rtol=0, atol=1e-9)   # %.9f
    assert np.abs(rows[:, 1:4] - traj_j["p"]).max() <= 1e-6
    assert out["ape"]["rmse"] < 0.01
    with open(log) as fh:
        recs = [json.loads(line) for line in fh]
    assert len(recs) == len(traj_j["t"]) and all("iterations" in r for r in recs)


def test_cli_sim_out_is_read_by_both_packages(capsys, tmp_path):
    out = str(tmp_path / "csv")
    cli.main(["sim", "--out", out])
    assert "wrote reference-format CSVs" in capsys.readouterr().out
    ids, frames = tio.read_sim_keyframes(out)
    ids_j, frames_j = jio.read_sim_keyframes(out)
    assert ids == ids_j and frames == frames_j and len(frames) == 600
    imu = np.loadtxt(os.path.join(out, "imu_pose.txt"))
    data = jsim.generate(noise=False)
    assert imu.shape == (len(data.imu_t), 14)
    np.testing.assert_allclose(imu[:, 8:11], data.gyr, rtol=1e-15, atol=1e-300)


def test_cli_profile_writes_a_chrome_trace(capsys, tmp_path):
    prof = str(tmp_path / "prof")
    cli.main(["run", "--dataset", "sim", "--frames", "3", "--device", "cpu",
              "--profile", prof])
    out = _last_json(capsys)
    assert out["frames"] == 0 and out["ape"] is None     # nothing initialized yet
    with open(os.path.join(prof, "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)


def test_cli_hybrid_needs_a_path():
    with pytest.raises(SystemExit, match="--path"):
        cli.main(["run", "--dataset", "hybrid", "--device", "cpu"])


@pytest.mark.parametrize("argv,want", [
    (["bench", "--device", "cpu"], ("cpu", bench.DETAILS)),
    (["bench", "--device", "cpu", "--details", "d.json"], ("cpu", "d.json")),
    (["bench"], (None, bench.DETAILS))], ids=["cpu", "details", "default"])
def test_cli_bench_parses(monkeypatch, argv, want):
    """``bench`` hands its device and details file to bench.main; a non-zero
    return (a stage failed) becomes the process's exit code."""
    calls = []
    monkeypatch.setattr(bench, "main", lambda device, details_path: calls.append(
        (device, details_path)) or 0)
    cli.main(argv)
    assert calls == [want]
    monkeypatch.setattr(bench, "main", lambda device, details_path: 1)
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 1


def _png(path):
    assert os.path.getsize(path) > 1000
    with open(path, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_every_plot_writes_a_png(tmp_path, as_tensor):
    conv = torch.as_tensor if as_tensor else np.asarray
    rng = np.random.default_rng(0)
    log = LMLog(chi2=[10.0, 1.0, 0.1, 0.05], lam=[1e-3, 3e-4, 1e-4, 3e-5])
    _png(viz.plot_lm_log(log, str(tmp_path / "lm.png")))
    dt = 0.005
    taus, avar = allan.allan_variance(0.02 / np.sqrt(dt) * rng.standard_normal(20_000), dt)
    adev = np.sqrt(avar)
    fit = dict(Q=1e-4, N=0.02, B=1e-4, K=1e-5, R=1e-6)
    _png(viz.plot_allan(conv(taus), conv(np.stack([adev] * 3)), str(tmp_path / "allan.png"),
                        fit=fit))
    p = np.cumsum(rng.standard_normal((50, 3)), axis=0)
    _png(viz.plot_trajectory(conv(p), conv(p + 0.1), str(tmp_path / "traj.png")))
    _png(viz.plot_trajectory(conv(p), None, str(tmp_path / "traj_nogt.png")))
    noise = np.array([0.1, 0.5, 1.0, 2.0])
    _png(viz.plot_triangulation_quality(conv(noise), conv(1e-3 * noise), conv(1e-2 * noise),
                                        str(tmp_path / "tri.png")))
