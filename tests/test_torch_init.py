"""The port's initialization stack (vio_tpu_torch/init/sfm.py,
alignment.py, ex_rotation.py) and generic dense LM (solver/generic.py)
against the JAX package's, on the clean random scenes tests/test_init.py
uses, in float64.  Deterministic geometry agrees to round-off (atol
1e-9); the RANSAC-based solves draw from different generators, so on
clean data they agree through the consensus refit (atol 1e-7 on R, on the
direction of t)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu.init import alignment as jalign
from vio_tpu.init import ex_rotation as jexr
from vio_tpu.init import sfm as jsfm
from vio_tpu.solver import generic as jgeneric
from vio_tpu_torch import factors as tfactors
from vio_tpu_torch.init import alignment as talign
from vio_tpu_torch.init import ex_rotation as texr
from vio_tpu_torch.init import sfm as tsfm
from vio_tpu_torch.solver import generic as tgeneric
from vio_tpu import factors as jfactors

torch.set_num_threads(1)


def _rot(th):
    th = np.asarray(th, np.float64)
    a = np.linalg.norm(th)
    K = np.array([[0, -th[2], th[1]], [th[2], 0, -th[0]], [-th[1], th[0], 0]])
    if a < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(a) / a * K + (1 - np.cos(a)) / a ** 2 * K @ K


def _scene(seed=0, n_pts=40, n_frames=4):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, n_pts), rng.uniform(-3, 3, n_pts),
                    rng.uniform(6, 12, n_pts)], axis=1)
    Rs = np.stack([_rot(0.08 * k * np.array([0.3, 1.0, 0.2])) for k in range(n_frames)])
    ts = np.stack([np.array([0.4 * k, -0.2 * k, 0.1 * k]) for k in range(n_frames)])
    obs = np.einsum("kij,lj->kli", Rs, pts) + ts[:, None, :]
    return pts, Rs, ts, obs[..., :2] / obs[..., 2:3]


T = torch.from_numpy
CPU64 = dict(device="cpu", dtype=torch.float64)


def test_triangulate_dlt_matches_jax():
    pts, Rs, ts, obs = _scene()
    o = obs.transpose(1, 0, 2).copy()
    m = np.ones((len(pts), 4), bool)
    Xj, rj = jsfm.triangulate_dlt_batch(jnp.asarray(Rs), jnp.asarray(ts),
                                        jnp.asarray(o), jnp.asarray(m))
    Xt, rt = tsfm.triangulate_dlt(T(Rs), T(ts), T(o), T(m))
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Xt.numpy(), pts, rtol=0, atol=1e-9)
    assert np.all(rt.numpy() > 1e3)


@pytest.mark.parametrize("solver", ["pnp_gn", "pnp_dlt"])
def test_pnp_matches_jax(solver):
    pts, Rs, ts, obs = _scene()
    k = 2
    mask = np.ones(len(pts), bool)
    if solver == "pnp_gn":
        R0 = Rs[k] @ _rot([0.05, -0.04, 0.06])
        t0 = ts[k] + np.array([0.2, -0.1, 0.15])
        Rj, tj, mj = jsfm.pnp_gn(jnp.asarray(pts), jnp.asarray(obs[k]),
                                 jnp.asarray(mask), jnp.asarray(R0), jnp.asarray(t0))
        Rt, tt, mt = tsfm.pnp_gn(T(pts), T(obs[k].copy()), T(mask), T(R0), T(t0))
        assert float(mt) < 1e-16
    else:
        Rj, tj = jsfm.pnp_dlt(jnp.asarray(pts), jnp.asarray(obs[k]), jnp.asarray(mask))
        Rt, tt = tsfm.pnp_dlt(T(pts), T(obs[k].copy()), T(mask))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(Rt.numpy(), Rs[k], rtol=0, atol=1e-7)


def test_solve_relative_rt_matches_jax():
    pts, Rs, ts, obs = _scene(n_frames=2)
    valid = np.ones(len(pts), bool)
    okj, Rj, tj = jsfm.solve_relative_rt(obs[0], obs[1], valid)
    okt, Rt, tt = tsfm.solve_relative_rt(obs[0], obs[1], valid, **CPU64)
    assert okj and okt
    np.testing.assert_allclose(Rt, Rj, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tt / np.linalg.norm(tt), tj / np.linalg.norm(tj),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(Rt, Rs[0] @ Rs[1].T, rtol=0, atol=1e-6)
    Rrel = tsfm.relative_rotation(obs[0], obs[1], **CPU64)
    np.testing.assert_allclose(Rrel, jsfm.relative_rotation(obs[0], obs[1]),
                               rtol=0, atol=1e-7)


def test_essential_ransac_ignores_non_finite_rows_outside_valid():
    """The tracker passes the NaN lift of a failed track in a row outside
    ``valid``: the port's RANSAC gives the result it gives with that row
    zeroed.  (vio_tpu returns no inliers there: NaN·0 reaches every
    hypothesis.)"""
    pts, Rs, ts, obs = _scene(n_frames=2)
    x0, x1 = obs[0].copy(), obs[1].copy()
    valid = np.ones(len(pts), bool)
    valid[3] = False
    clean = tsfm.essential_ransac(T(x0), T(x1), T(valid), torch.Generator().manual_seed(0))
    x1[3] = np.nan
    out = tsfm.essential_ransac(T(x0), T(x1), T(valid), torch.Generator().manual_seed(0))
    for a, b in zip(out, clean):
        assert torch.equal(a, b)
    assert int(out[2]) == len(pts) - 1
    _, _, n_j = jsfm.essential_ransac(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(valid),
                                      jax.random.PRNGKey(0))
    assert int(n_j) == 0


def test_construct_matches_jax():
    """Incremental SfM + the windowed BA on the generic LM (jacfwd in both)."""
    pts, Rs, ts, obs = _scene(n_frames=6, n_pts=50)
    K, l = 6, 0
    valid = np.ones((K, len(pts)), bool)
    R_rel = Rs[l] @ Rs[K - 1].T
    t_rel = ts[l] - R_rel @ ts[K - 1]
    okj, Rsj, tsj, Xj, trij = jsfm.construct(obs, valid, l, R_rel, t_rel)
    okt, Rst, tst, Xt, trit = tsfm.construct(obs, valid, l, R_rel, t_rel, **CPU64)
    assert okj and okt
    np.testing.assert_array_equal(trit, trij)
    np.testing.assert_allclose(Rst, Rsj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tst, tsj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(Xt, Xj, rtol=0, atol=1e-7)


def test_generic_lm_curve_fit_matches_jax():
    """The dense LM on y = exp(a x² + b x + c), both strategies."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, 1, 60)
    y = np.exp(1.0 * x * x + 2.0 * x + 1.0) + 0.1 * rng.standard_normal(60)

    def make(lib, asarray):
        xs, ys = asarray(x), asarray(y)

        def resid(p):
            return lib.exp(p[0] * xs * xs + p[1] * xs + p[2]) - ys

        def normal_fn(p):
            e = lib.exp(p[0] * xs * xs + p[1] * xs + p[2])
            J = lib.stack([e * xs * xs, e * xs, e], 1)
            r = resid(p)
            return J.T @ J, -J.T @ r, 0.5 * (r @ r)
        return normal_fn, lambda p: 0.5 * (resid(p) @ resid(p))

    for strategy in ("nielsen", "alpha"):
        nj, cj = make(jnp, jnp.asarray)
        pj, sj = jgeneric.lm_solve_dense(nj, cj, lambda a, d: a + d,
                                         jnp.zeros(3), strategy=strategy)
        nt, ct = make(torch, torch.as_tensor)
        pt, st = tgeneric.lm_solve_dense(nt, ct, lambda a, d: a + d,
                                         torch.zeros(3, dtype=torch.float64),
                                         strategy=strategy)
        assert st["iterations"] == sj["iterations"], strategy
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-9, atol=1e-12)


def test_alignment_and_ex_rotation_match_jax():
    """The numpy copies against their originals, on synthetic inputs."""
    rng = np.random.default_rng(4)
    N = 12
    R = np.stack([_rot(0.2 * rng.standard_normal(3)) for _ in range(N + 1)])
    q = rng.standard_normal((N, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    J = rng.standard_normal((N, 3, 3))
    np.testing.assert_array_equal(talign.solve_gyroscope_bias(R, q, J),
                                  jalign.solve_gyroscope_bias(R, q, J))
    T_ = rng.standard_normal((N + 1, 3))
    dp, dv = rng.standard_normal((N, 3)), rng.standard_normal((N, 3))
    dts = 0.2 + 0.01 * rng.random(N)
    tic = np.array([0.05, 0.04, 0.03])
    out_t = talign.linear_alignment(R, T_, dp, dv, dts, tic, max_scale_rel_std=10.0, g_band=50.0)
    out_j = jalign.linear_alignment(R, T_, dp, dv, dts, tic, max_scale_rel_std=10.0, g_band=50.0)
    assert out_t[0] == out_j[0]
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_array_equal(a, b)

    ct, cj = texr.ExtrinsicRotationCalibrator(4), jexr.ExtrinsicRotationCalibrator(4)
    ric = _rot([0.1, -0.2, 0.3])
    for _ in range(6):
        Ri = _rot(0.3 * rng.standard_normal(3))
        Rc = ric.T @ Ri @ ric
        ct.add_pair(Rc, Ri)
        cj.add_pair(Rc, Ri)
    okt, rt = ct.solve()
    okj, rj = cj.solve()
    assert okt == okj
    np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-12)


@pytest.mark.parametrize("loss", ["cauchy_rho", "huber_rho", "tukey_rho"])
def test_robust_losses_match_jax(loss):
    e2 = np.concatenate([np.linspace(0.0, 4.0, 41), [1e-12, 9.0, 100.0]])
    ref = getattr(jfactors, loss)(jnp.asarray(e2), 1.5)
    out = getattr(tfactors, loss)(T(e2), 1.5)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-14)
