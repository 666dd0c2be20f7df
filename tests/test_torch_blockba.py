"""The port's block-BA engine and BAL solver (vio_tpu_torch/solver/
blockba.py, bal.py) against the JAX package's, on tests/test_bal.py's
problems carried across with vio_tpu_torch.convert, CPU float64.

Tolerances: assembly and one Schur step ≤ 1e-9 relative to each array's
largest entry (the same sums in another order); a whole solve takes the
same accept/reject path, so its chi² history has the same length and it
and the states agree to 1e-6 (relative to the chi² history's first entry
for chi², absolute for states of unit scale), the round-off the LM loop
accumulates over its iterations.  The known-answer bounds are
tests/test_bal.py's own."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_bal import _make_problem
from vio_tpu.solver import bal as jbal
from vio_tpu.solver import blockba as jbb
from vio_tpu.utils import lie as jlie
from vio_tpu_torch import convert
from vio_tpu_torch.solver import bal as tbal
from vio_tpu_torch.solver import blockba as tbb

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _np(nt):
    return {k: np.asarray(v) for k, v in zip(nt._fields, nt)}


def _close(actual, desired, rtol, atol, name):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, name
    if desired.dtype.kind in "biu":
        np.testing.assert_array_equal(actual, desired, err_msg=name)
        return
    err = np.abs(actual - desired).max(initial=0.0)
    bound = atol + rtol * np.abs(desired).max(initial=0.0)
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


def _noise_free_case():
    """test_bal_converges_to_ground_truth's problem: (gt, noisy)."""
    gt, key = _make_problem(jax.random.PRNGKey(0))
    ks = jax.random.split(key, 3)
    mask = jnp.arange(gt.cam_q.shape[0]) >= 2
    dth = 0.02 * jax.random.normal(ks[0], gt.cam_t.shape, jnp.float64)
    noisy_q = jax.vmap(jlie.quat_mul)(
        gt.cam_q, jax.vmap(jlie.so3_exp_quat)(dth * mask[:, None]))
    noisy = gt._replace(
        cam_q=jlie.quat_normalize(noisy_q),
        cam_t=gt.cam_t + 0.05 * mask[:, None] *
        jax.random.normal(ks[1], gt.cam_t.shape, jnp.float64),
        points=gt.points + 0.05 *
        jax.random.normal(ks[2], gt.points.shape, jnp.float64))
    return gt, noisy


def _noisy_case():
    """test_bal_noisy_observations_reduce_chi2's problem: (gt, noisy)."""
    gt, key = _make_problem(jax.random.PRNGKey(1), noise_uv=0.5)
    ks = jax.random.split(key, 2)
    return gt, gt._replace(points=gt.points + 0.03 *
                           jax.random.normal(ks[0], gt.points.shape, jnp.float64))


CASES = {
    "noise_free": (_noise_free_case, dict(max_iter=40, optimize_intrinsics=False,
                                          gauge_fix=2)),
    "noisy_uv": (_noisy_case, dict(max_iter=25, optimize_intrinsics=True)),
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    make, kw = CASES[request.param]
    gt, noisy = make()
    return request.param, gt, noisy, kw


@pytest.mark.parametrize("optimize_intrinsics,gauge_fix", [(True, 1), (False, 2)])
def test_assemble_and_schur_step_match_jax(case, optimize_intrinsics, gauge_fix):
    _, _, noisy, _ = case
    C, M = noisy.cam_q.shape[0], noisy.points.shape[0]
    pt = convert.bal_problem_from_numpy(_np(noisy), **CPU64)
    nj = jbal._assemble(noisy, C, M, optimize_intrinsics, 2.0, gauge_fix)
    nt = tbal._assemble(pt, C, M, optimize_intrinsics, 2.0, gauge_fix)
    for name in tbb.BlockNormal._fields:
        _close(getattr(nt, name).numpy(), getattr(nj, name), 1e-9, 0.0, name)
    lam = 1e-4 * float(jnp.max(jnp.abs(jnp.diagonal(nj.Hcc))))
    for name, a, b in zip(("dxc", "dxp"), tbb.schur_solve(nt, lam, C, M),
                          jbb.schur_solve(nj, jnp.asarray(lam), C, M)):
        _close(a.numpy(), b, 1e-9, 0.0, name)


def test_solve_matches_jax_and_its_bounds(case):
    name, gt, noisy, kw = case
    oj, hj = jbal.solve(noisy, **kw)
    ot, ht = tbal.solve(convert.bal_problem_from_numpy(_np(noisy), **CPU64), **kw,
                        **CPU64)
    assert len(ht) == len(hj)
    _close(ht, hj, 1e-6, 0.0, "chi2 history")
    for field in ("cam_q", "cam_t", "cam_fkk", "points"):
        _close(getattr(ot, field).numpy(), getattr(oj, field), 0.0, 1e-6, field)
    # tests/test_bal.py's bounds
    if name == "noise_free":
        assert ht[-1] < 1e-12 * ht[0], ht
        np.testing.assert_allclose(ot.cam_t.numpy(), np.asarray(gt.cam_t), atol=1e-5)
        np.testing.assert_allclose(ot.points.numpy(), np.asarray(gt.points), atol=1e-5)
    else:
        assert ht[-1] < 0.2 * ht[0]
        err = np.linalg.norm(ot.points.numpy() - np.asarray(gt.points), axis=1)
        assert np.median(err) < 0.08


def test_solve_in_float32_on_the_cpu_converges():
    """The card's working type, rehearsed with the plain elimination: the
    noise-free case still recovers the points (to float32's floor)."""
    gt, noisy = _noise_free_case()
    ot, ht = tbal.solve(convert.bal_problem_from_numpy(_np(noisy), **CPU64),
                        max_iter=40, optimize_intrinsics=False, gauge_fix=2,
                        device="cpu", dtype=torch.float32)
    assert ot.points.dtype == torch.float32
    assert ht[-1] < 1e-6 * ht[0], ht
    np.testing.assert_allclose(ot.points.double().numpy(), np.asarray(gt.points), atol=1e-3)


def test_bal_loader_roundtrip(tmp_path):
    """tests/test_bal.py::test_bal_loader_roundtrip's file, read by the
    port; the problems agree with the JAX loader's."""
    gt, _ = _make_problem(jax.random.PRNGKey(2), C=3, M=7)
    path = os.path.join(tmp_path, "problem.txt")
    C, M, O = 3, 7, 21
    with open(path, "w") as fh:
        fh.write(f"{C} {M} {O}\n")
        for o in range(O):
            fh.write(f"{int(gt.cam_idx[o])} {int(gt.pt_idx[o])} "
                     f"{float(gt.uv[o, 0]):.17g} {float(gt.uv[o, 1]):.17g}\n")
        for c in range(C):
            w = jlie.quat_log(gt.cam_q[c])
            for v in [*np.asarray(w), *np.asarray(gt.cam_t[c]),
                      *np.asarray(gt.cam_fkk[c])]:
                fh.write(f"{float(v):.17g}\n")
        for m in range(M):
            for v in np.asarray(gt.points[m]):
                fh.write(f"{float(v):.17g}\n")
    p = tbal.load_bal(path, **CPU64)
    np.testing.assert_allclose(p.cam_t.numpy(), np.asarray(gt.cam_t), atol=1e-12)
    np.testing.assert_allclose(p.points.numpy(), np.asarray(gt.points), atol=1e-12)
    r = tbal.bal_residual(p.cam_q[p.cam_idx], p.cam_t[p.cam_idx],
                          p.cam_fkk[p.cam_idx], p.points[p.pt_idx], p.uv)
    assert float(r.abs().max()) < 1e-9
    pj = jbal.load_bal(path)
    for field in tbal.BalProblem._fields:
        _close(getattr(p, field).numpy(), getattr(pj, field), 1e-15, 0.0, field)


@pytest.mark.gpu
def test_bal_solve_on_the_card_goes_through_the_kernel():
    """tests/test_bal.py's noise-free case in float32 on the card: every
    attempt's 54-unknown camera system goes to the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vio_tpu_torch.ops import linsolve
    gt, noisy = _noise_free_case()
    linsolve.gj_solve.launches = 0
    ot, ht = tbal.solve(convert.bal_problem_from_numpy(_np(noisy), **CPU64),
                        max_iter=40, optimize_intrinsics=False, gauge_fix=2)
    assert ot.points.is_cuda and linsolve.gj_solve.launches >= len(ht) - 1
    assert ht[-1] < 1e-6 * ht[0]
