"""The port's single-device global BA (vio_tpu_torch/parallel/global_ba.py)
against the JAX package's, and held to tests/test_global_ba.py's
known-answer bounds, on vio_tpu_torch.testing's problems (equal to
vio_tpu.testing's to round-off: tests/test_torch_testing.py), CPU float64.

Tolerances: assembly and one Schur step ≤ 1e-9 relative to each array's
largest entry (another summation order; the JAX package's CPU solve is
LU, the port's the plain elimination); whole solves take the same
accept/reject path, so the iteration counts are equal and the
trajectories agree to 1e-8 m."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import testing as jt
from vio_tpu.parallel import global_ba as jg
from vio_tpu_torch import convert
from vio_tpu_torch import testing as tt
from vio_tpu_torch.parallel import global_ba as tg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _close(actual, desired, rtol, atol, name):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, name
    err = np.abs(actual - desired).max(initial=0.0)
    bound = atol + rtol * np.abs(desired).max(initial=0.0)
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


def _both(N, M, obs, **perturb):
    """The same perturbed problem in both packages: (gt_t, noisy_t, noisy_j)."""
    gt_j, _ = jt.make_global_problem(N=N, M=M, obs_per_lm=obs)
    noisy_j = jt.perturb_global(gt_j, **perturb)
    gt_t, _ = tt.make_global_problem(N=N, M=M, obs_per_lm=obs, **CPU64)
    noisy_t = convert.global_ba_from_numpy(
        {k: np.asarray(v) for k, v in zip(noisy_j._fields, noisy_j)}, **CPU64)
    return gt_t, noisy_t, noisy_j


def _constrained(p, min_obs=2):
    cnt = torch.zeros(p.inv_dep.shape[0], dtype=torch.int64).index_add_(
        0, p.lm_idx, p.valid.to(torch.int64))
    return (p.lm_valid & (cnt >= min_obs)).numpy()


@pytest.mark.parametrize("fix_frames,loss_delta", [(2, 1.0), (1, 50.0)])
def test_assemble_and_schur_step_match_jax(fix_frames, loss_delta):
    _, pt, pj = _both(12, 120, 6)
    nj = jg.assemble(pj, 12, 120, fix_frames, loss_delta)
    nt = tg.assemble(pt, 12, 120, fix_frames, loss_delta)
    for name in tg.GlobalNormal._fields:
        _close(getattr(nt, name).numpy(), getattr(nj, name), 1e-9, 0.0, name)
    lam = 1e-3 * float(jnp.max(jnp.diagonal(nj.Hpp)))
    for name, a, b in zip(("dxp", "dxm"), tg.schur_step(nt, lam, pt.lm_valid),
                          jg.schur_step(nj, lam, pj.lm_valid)):
        _close(a.numpy(), b, 1e-9, 0.0, name)


def test_solve_matches_jax_trajectory():
    _, pt, pj = _both(12, 120, 6)
    oj, sj = jg.solve(pj, max_iter=25, fix_frames=2)
    ot, st = tg.solve(pt, max_iter=25, fix_frames=2, **CPU64)
    assert st["iterations"] == int(sj["iterations"])
    _close(ot.Ps.numpy(), oj.Ps, 0.0, 1e-8, "Ps")
    _close(ot.Qs.numpy(), oj.Qs, 0.0, 1e-8, "Qs")
    _close(float(st["chi2_init"]), float(sj["chi2_init"]), 1e-12, 0.0, "chi2_init")


def test_global_ba_converges_to_ground_truth():
    """tests/test_global_ba.py::test_global_ba_converges_to_ground_truth."""
    gt = tt.make_global_problem(**CPU64)[0]
    opt, stats = tg.solve(tt.perturb_global(gt), max_iter=25, fix_frames=2, **CPU64)
    assert float(stats["chi2"]) < 1e-10 * float(stats["chi2_init"]), stats
    np.testing.assert_allclose(opt.Ps.numpy(), gt.Ps.numpy(), atol=1e-6)
    sel = _constrained(gt)
    np.testing.assert_allclose(opt.inv_dep.numpy()[sel], gt.inv_dep.numpy()[sel],
                               rtol=1e-5)


def test_global_ba_larger_window():
    """tests/test_global_ba.py::test_global_ba_larger_window: 100
    keyframes, 600 pose unknowns (the card's blocked regime)."""
    gt, _ = tt.make_global_problem(N=100, M=400, obs_per_lm=8, **CPU64)
    noisy = tt.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)
    opt, stats = tg.solve(noisy, max_iter=25, fix_frames=2, loss_delta=50.0, **CPU64)
    assert float(stats["chi2"]) < 1e-8 * float(stats["chi2_init"]), stats
    err = torch.linalg.norm(opt.Ps - gt.Ps, dim=1)
    assert float(err.max()) < 1e-4, float(err.max())


def test_global_ba_pcg_matches_direct():
    """tests/test_global_ba.py::test_global_ba_pcg_matches_direct."""
    gt, _ = tt.make_global_problem(N=8, M=64, obs_per_lm=4, **CPU64)
    noisy = tt.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)
    ref, _ = tg.solve(noisy, max_iter=8, fix_frames=2, **CPU64)
    out, _ = tg.solve(noisy, max_iter=8, fix_frames=2, use_pcg=True, **CPU64)
    assert float((out.Ps - ref.Ps).abs().max()) < 1e-8


def test_float32_bench_settings_on_the_cpu():
    """The bench's scale-out run (max_iter=10) in the card's working type,
    rehearsed with the plain elimination, against the JAX package's own
    float32 run of the same problem on the CPU: within 2x of its pose error
    and under chip_smoke.py's 0.01 m bound."""
    gt_j, _ = jt.make_global_problem(N=100, M=400, obs_per_lm=8)
    noisy_j = jt.perturb_global(gt_j, pose_sigma=0.02, rot_sigma=0.005)
    f32 = {k: (np.asarray(v).astype(np.float32) if np.asarray(v).dtype.kind == "f"
               else np.asarray(v)) for k, v in zip(noisy_j._fields, noisy_j)}
    oj, _ = jg.solve(jg.GlobalBA(*(jnp.asarray(v) for v in f32.values())),
                     max_iter=10, fix_frames=2, loss_delta=50.0)
    err_j = np.linalg.norm(np.asarray(oj.Ps, np.float64) - np.asarray(gt_j.Ps), axis=1).max()
    p = convert.global_ba_from_numpy(f32, device="cpu", dtype=torch.float32)
    ot, st = tg.solve(p, max_iter=10, fix_frames=2, loss_delta=50.0, device="cpu",
                      dtype=torch.float32)
    assert ot.Ps.dtype == torch.float32
    err_t = np.linalg.norm(ot.Ps.double().numpy() - np.asarray(gt_j.Ps), axis=1).max()
    assert err_t < max(2.0 * err_j, 1e-4) and err_t < 0.01, (err_t, err_j)
    assert float(st["chi2"]) <= 1e-8 * float(st["chi2_init"])


def test_align_and_local_shards_cover_the_problem():
    """Every observation lands on the rank that holds its landmark, once;
    the ranks' landmark blocks tile the tables."""
    p, _ = tt.make_global_problem(N=16, M=64, obs_per_lm=4, **CPU64)
    world = 4
    parts = [tg.prepare_sharded(p, r, world) for r in range(world)]
    seen = []
    for r, q in enumerate(parts):
        lo = r * 16
        live = q.lm_idx[q.valid]
        assert bool(((live >= lo) & (live < lo + 16)).all())
        seen += list(zip(live.tolist(), q.frame[q.valid].tolist()))
        torch.testing.assert_close(q.inv_dep, p.inv_dep[lo:lo + 16])
        torch.testing.assert_close(q.Ps, p.Ps)
    want = list(zip(p.lm_idx[p.valid].tolist(), p.frame[p.valid].tolist()))
    assert sorted(seen) == sorted(want)


@pytest.mark.gpu
def test_solve_on_the_card_goes_through_the_blocked_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vio_tpu_torch.ops import linsolve
    gt, _ = tt.make_global_problem(N=100, M=400, obs_per_lm=8, dtype=torch.float64)
    noisy = tt.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)
    linsolve.gj_solve.launches = 0
    opt, stats = tg.solve(noisy, max_iter=25, fix_frames=2, loss_delta=50.0,
                          dtype=torch.float64)
    assert opt.Ps.is_cuda and linsolve.gj_solve.launches == stats["iterations"]
    assert float(torch.linalg.norm(opt.Ps - gt.Ps, dim=1).max()) < 1e-4


@pytest.mark.parametrize("world", [3, 5])
def test_shards_that_do_not_divide_are_refused(world):
    p, _ = tt.make_global_problem(N=16, M=64, obs_per_lm=4, **CPU64)
    with pytest.raises(ValueError, match="divide"):
        tg.prepare_sharded(p, 0, world)
    states, f, _ = tt.make_window_problem(window_size=2, max_features=8,
                                          imu_per_interval=2, **CPU64)
    from vio_tpu_torch.parallel import sharded
    with pytest.raises(ValueError, match="divide"):
        sharded.shard_problem(states, f, 0, world)
