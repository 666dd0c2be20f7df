"""The port's bench (vio_tpu_torch/bench.py, `vio-torch bench`) on the CPU
in float64: its stages' work against vio_tpu's on the inputs the root
bench.py builds, and its run at shrunk stage sizes.

The inputs come from vio_tpu.testing and the root bench.py's numpy recipes
and seeds, rebuilt here (the root bench.py is not imported: it sets a JAX
cache directory at import).  Tolerances: the window solve takes the same
branch decisions, so its iteration count is exact and the states agree to
rtol 1e-7, atol 1e-9 (tests/test_torch_window_lm.py); KLT the same valid
mask and positions and residuals of the valid tracks within 1e-3 px
(tests/test_torch_features.py); global BA poses to 1e-8 m
(tests/test_torch_global_ba.py)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import testing as jt
from vio_tpu.features import klt as jklt
from vio_tpu.parallel import global_ba as jg
from vio_tpu.solver import lm as jlm
from vio_tpu_torch import bench, cli
from vio_tpu_torch.features import klt as tklt

torch.set_num_threads(1)
CPU = dict(device="cpu")
POS_TOL = 1e-3                   # px, tests/test_torch_features.py:29
SMALL = dict(WINDOW_F=16, WINDOW_F_LARGE=24, KLT_PX=160, KLT_FEATURES=20,
             GLOBAL=dict(N=8, M=40, obs_per_lm=4), E2E_FRAMES=(4, 2), E2E_WARM_FRAMES=2,
             E2E_INIT_FRAMES=20, E2E_TRACE_FRAMES=1)
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
STAGES = ("klt_track_150feat_640px_3lvl", "window_ba_F1024_euroc_shape",
          "global_ba_100kf", "e2e_sim_120frames")


def _close(actual, desired, rtol, atol, name):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, name
    err = np.abs(actual - desired).max(initial=0.0)
    bound = atol + rtol * np.abs(desired).max(initial=0.0)
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


def test_window_stage_matches_jax():
    """F=32 with bench.py's perturbation, n_obs rule and max_iter=10."""
    F = 32
    states, f, _ = jt.make_window_problem(window_size=10, max_features=F,
                                          imu_per_interval=16, dtype=jnp.float64)
    live = int(np.asarray(f.obs_mask).sum())
    n_obs = max(256, ((live + 255) // 256) * 256)
    pert = np.random.default_rng(0).normal(0.0, 0.01, states.Ps.shape)
    out_j, _, _, st_j = jlm.solve_window(states._replace(Ps=states.Ps + pert), f,
                                         max_iter=10, n_obs=n_obs)

    t_states, t_f, t_pert, t_n_obs, t_live = bench.window_problem(F, **CPU)
    assert (t_live, t_n_obs) == (live, n_obs)
    assert t_pert.dtype == torch.float64
    np.testing.assert_array_equal(t_pert.numpy(), pert)
    _close(t_states.Ps.numpy(), states.Ps, 1e-12, 0.0, "Ps start")
    Ps, chi2, iters = bench.window_solve(t_states, t_f, t_pert, t_n_obs)
    assert iters == int(st_j["iterations"]) > 1
    _close(Ps.numpy(), out_j.Ps, 1e-7, 1e-9, "Ps")
    _close(float(chi2), float(st_j["chi2"]), 1e-7, 1e-9, "chi2")


def test_klt_stage_matches_jax(monkeypatch):
    """bench.py's image recipe at 160² with 20 features."""
    px, n = 160, 20
    monkeypatch.setattr(bench, "KLT_PX", px)
    monkeypatch.setattr(bench, "KLT_FEATURES", n)
    rng = np.random.default_rng(0)
    img0 = rng.standard_normal((px, px)).astype(np.float32)
    for _ in range(2):
        img0 = (np.roll(img0, 1, 0) + np.roll(img0, -1, 0) +
                np.roll(img0, 1, 1) + np.roll(img0, -1, 1) + img0) / 5.0
    img0 = (img0 - img0.min()) / (img0.max() - img0.min()) * 255.0
    img1 = np.roll(img0, (2, 3), axis=(0, 1))
    pp = rng.uniform(40, px - 40, (n, 2))

    a0, a1, t_pp, t_vv = bench.klt_inputs(**CPU)
    np.testing.assert_array_equal(a0.numpy(), img0)
    np.testing.assert_array_equal(a1.numpy(), img1)
    np.testing.assert_array_equal(t_pp.numpy(), pp)
    assert t_vv.all() and a0.dtype == torch.float32 and t_pp.dtype == torch.float64

    p_j, ok_j, res_j = (np.asarray(x) for x in jklt.track_fb(
        jnp.asarray(img0), jnp.asarray(img1), jnp.asarray(pp), jnp.ones(n, bool)))
    p_t, ok_t, res_t = (x.numpy() for x in tklt.track_fb(a0, a1, t_pp, t_vv))
    np.testing.assert_array_equal(ok_t, ok_j)
    assert ok_j.sum() >= n // 2
    np.testing.assert_allclose(p_t[ok_j], p_j[ok_j], rtol=0, atol=POS_TOL)
    np.testing.assert_allclose(res_t[ok_j], res_j[ok_j], rtol=0, atol=POS_TOL)


def test_global_ba_stage_matches_jax(monkeypatch):
    """bench.py's perturbation and solve at N=8, M=40."""
    size = dict(N=8, M=40, obs_per_lm=4)
    monkeypatch.setattr(bench, "GLOBAL", size)
    gt_j, _ = jt.make_global_problem(**size)
    noisy_j = jt.perturb_global(gt_j, pose_sigma=0.02, rot_sigma=0.005)
    out_j, st_j = jg.solve(noisy_j, max_iter=10, fix_frames=2, loss_delta=50.0)

    noisy_t = bench.global_problem(**CPU)
    _close(noisy_t.Ps.numpy(), noisy_j.Ps, 1e-12, 0.0, "Ps start")
    out_t, st_t = bench.global_solve(noisy_t, **CPU)
    assert st_t["iterations"] == int(st_j["iterations"])
    _close(out_t.Ps.numpy(), out_j.Ps, 0.0, 1e-8, "Ps")


@pytest.fixture
def small(monkeypatch):
    for name, value in SMALL.items():
        monkeypatch.setattr(bench, name, value)


def _headline(out: str) -> dict:
    head = json.loads(out.splitlines()[0])
    assert set(head) == HEADLINE_KEYS and head["metric"] == "window_ba_solve_fps"
    return head


def test_bench_runs_every_stage_on_the_cpu(small, capsys, tmp_path):
    path = tmp_path / "details.json"
    cli.main(["bench", "--device", "cpu", "--details", str(path)])
    head = _headline(capsys.readouterr().out)
    assert head["value"] > 0 and head["vs_baseline"] == head["value"] / bench.BASELINE_FPS
    d = json.loads(path.read_text())
    assert d["device"] == "cpu" and d["dtype"] == "float64" and d["card"] is None
    assert d["window_ba_device_ms_per_solve"] is None and d["window_ba_wall_ms_per_solve"] > 0
    assert d["window_ba_lm_iterations"] > 1 and d["window_ba_flops_per_solve_matmul_family"] > 0
    assert d["window_ba_max_features"] == SMALL["WINDOW_F"]
    for key in STAGES:
        assert isinstance(d[key], dict), (key, d[key])
        timed = {k: v for k, v in d[key].items() if k.startswith(("wall", "device_ms"))}
        assert timed and all(v is None if k.startswith("device") else v > 0
                             for k, v in timed.items()), (key, timed)
    e2e = d["e2e_sim_120frames"]
    assert e2e["n_frames"] == SMALL["E2E_FRAMES"][0] and e2e["failures"] == 0
    # the second estimator initialized and one post-init frame was traced
    assert (e2e["post_init_frames_traced"], e2e["device_frames_traced"]) == (1, 0)
    assert e2e["device_ms_per_frame"] is None and e2e["busy_share"] is None
    assert set(d["gj_solve_launches_by_stage"]) == {"window_ba", *STAGES}
    assert d["gj_solve_launches"] == 0          # the CPU runs the plain version
    assert set(d["stage_wall_s"]) == set(STAGES)


def test_a_failing_stage_exits_1(small, monkeypatch, capsys, tmp_path):
    """The stage is recorded as an error, the later stages still run, and
    the process exits 1 once the details are written."""
    def broken(**kwargs):
        raise RuntimeError("stage broke")

    monkeypatch.setattr(bench, "bench_global_ba", broken)
    monkeypatch.setattr(bench, "bench_e2e_sim", lambda **kw: {"n_frames": 0})
    path = tmp_path / "details.json"
    with pytest.raises(SystemExit) as exc:
        cli.main(["bench", "--device", "cpu", "--details", str(path)])
    assert exc.value.code == 1
    _headline(capsys.readouterr().out)
    d = json.loads(path.read_text())
    assert d["global_ba_100kf"] == "error: RuntimeError: stage broke"
    assert d["e2e_sim_120frames"] == {"n_frames": 0} and "total_wall_s" in d


def test_details_merge_keeps_earlier_values(tmp_path):
    """bench.py's _flush_details: a budget skip does not overwrite an earlier
    number; a new number or an error does."""
    path = tmp_path / "d.json"
    bench.flush_details({"a": 1.0, "b": 2.0, "c": 3.0}, path)
    bench.flush_details({"a": "skipped (budget)", "b": "error: x", "d": "skipped (budget)"}, path)
    assert json.loads(path.read_text()) == {"a": 1.0, "b": "error: x", "c": 3.0,
                                            "d": "skipped (budget)"}
