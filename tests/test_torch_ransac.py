"""The port's 8-point RANSAC (vio_tpu_torch/ops/ransac.py and
init/sfm.py::essential_ransac_from_samples) against ``vio_tpu.init.sfm``
on the CPU, in float64: the same numpy-seeded correspondences and the
same sample indices go through both packages.  E is compared up to sign
(its sign is arbitrary in both) to 1e-9: both take the null vector of the
same (N, 9) system from LAPACK, and the scenes keep each sample's
condition σ1/σ8 below ~1e4, so round-off stays near 1e-12.  Counts and
inlier masks must be equal.  The CUDA kernels' algorithms are held the
same way through float64 numpy transcriptions of their steps, in the
kernels' order; the kernels against their plain versions run on the card
only (marked ``gpu``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu.init import sfm as jsfm
from vio_tpu_torch.init import sfm as tsfm
from vio_tpu_torch.ops import ransac

torch.set_num_threads(1)

E_TOL = 1e-9
THRESH = 1.0 / 460.0
N_HYP = 64


def _rot(th):
    th = np.asarray(th, np.float64)
    a = np.linalg.norm(th)
    K = np.array([[0, -th[2], th[1]], [th[2], 0, -th[0]], [-th[1], th[0], 0]])
    return np.eye(3) + np.sin(a) / a * K + (1 - np.cos(a)) / a ** 2 * K @ K


def _pairs(N, seed, outliers=0.15, noise=3e-4, drop=0.1):
    """N correspondences (x0, x1) of a random scene seen from two poses
    (normalised coordinates, pixel-scale noise on x1), a share of them
    replaced by outliers, and a mask with a share of rows invalid."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-3, 3, N), rng.uniform(-3, 3, N), rng.uniform(5, 10, N)], 1)
    R, t = _rot([0.05, -0.12, 0.04]), np.array([0.6, -0.2, 0.1])
    c1 = pts @ R.T + t
    x0 = pts[:, :2] / pts[:, 2:]
    x1 = c1[:, :2] / c1[:, 2:] + rng.normal(0.0, noise, (N, 2))
    bad = rng.random(N) < outliers
    x1[bad] += rng.uniform(-0.05, 0.05, (int(bad.sum()), 2))
    valid = rng.random(N) >= drop
    return x0, x1, valid


def _samples(valid, n_hyp, seed):
    """n_hyp 8-point samples of valid rows, without replacement."""
    rng = np.random.default_rng(seed)
    rows = np.where(valid)[0]
    return np.stack([rng.choice(rows, 8, replace=False) for _ in range(n_hyp)])


def _up_to_sign(a, b):
    a, b = np.asarray(a).reshape(-1, 9), np.asarray(b).reshape(-1, 9)
    return np.minimum(np.abs(a - b).max(1), np.abs(a + b).max(1))


def _jax_sweep(x0, x1, valid, idx):
    """vio_tpu's hypothesis sweep (sfm.py:185-192), vmapped over idx."""
    x0, x1, valid = jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(valid)

    def hyp(sample_idx):
        w = jnp.zeros((x0.shape[0],), x0.dtype).at[sample_idx].set(1.0) * valid
        E = jsfm._eight_point(x0, x1, w)
        inl = (jsfm._epipolar_err(E, x0, x1) < THRESH * THRESH) & valid
        return E, jnp.sum(inl)

    Es, n = jax.vmap(hyp)(jnp.asarray(idx))
    return np.asarray(Es), np.asarray(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# csrc/essential_ransac.cu transcribed into float64 numpy, step for step: a
# warp's lanes are the rows of an array, a shuffle reduction a product.
# ---------------------------------------------------------------------------

EPS64 = np.finfo(np.float64).eps


def _householder_qr(m, steps):
    """householder_step 0..steps-1 on a warp's rows m (lanes, columns), in
    place: reflection k zeroes column k below row k."""
    lanes = np.arange(len(m))
    for k in range(steps):
        x = np.where(lanes >= k, m[:, k], 0.0)
        s = x @ m[:, k:]                  # x . m_j for every j >= k; s[0] = |x|²
        r = m[k, k:].copy()               # lane k's row, broadcast
        if not s[0] > 0:
            continue
        xk, nrm = r[0], np.sqrt(s[0])
        alpha = -nrm if xk >= 0 else nrm
        beta = 1.0 / (nrm * (nrm + abs(xk)))
        v = np.where(lanes == k, xk - alpha, x)
        m[:, k + 1:] -= beta * np.outer(v, s[1:] - alpha * r[1:])
        m[:, k] = np.where(lanes == k, alpha, np.where(lanes > k, 0.0, m[:, k]))
    return m


def _sweep_null_vector(A):
    """The sweep's null vector of an 8 × 9 sample A: lane i holds row i of
    [Aᵀ | I] (16 lanes); after 8 reflections lane 8's right block is
    q₉ᵀ = (H₁⋯H₈ e₉)ᵀ."""
    m = np.zeros((16, 17))
    m[:9, :8] = A.T
    m[:9, 8:] = np.eye(9)
    return _householder_qr(m, 8)[8, 8:].copy()


def _rotation(alpha, beta, gamma, tol):
    """(c, s) of Rutishauser's angle, as the kernel forms it (no division)."""
    if not (alpha > 0 and beta > 0):
        return None
    if not gamma * gamma > tol * tol * (alpha * beta):
        return None
    d, g2 = beta - alpha, 2.0 * gamma
    den = abs(d) + np.sqrt(d * d + g2 * g2)
    h = 1.0 / np.sqrt(den * den + g2 * g2)
    return den * h, np.copysign(1.0, d) * g2 * h


def _rotate(a, v, p, q, c, s):
    a[p], a[q] = c * a[p] - s * a[q], s * a[p] + c * a[q]
    v[p], v[q] = c * v[p] - s * v[q], s * v[p] + c * v[q]


def _project_essential(e):
    """project_essential: the 3 × 3 one-sided Jacobi of E's columns (row p
    of b is column p of E), then u1 v1ᵀ + u2 v2ᵀ."""
    b, v = e.reshape(3, 3).T.copy(), np.eye(3)
    tol = np.sqrt(3.0) * EPS64
    for _ in range(30):
        rotated = False
        for p in range(2):
            for q in range(p + 1, 3):
                rot = _rotation(b[p] @ b[p], b[q] @ b[q], b[p] @ b[q], tol)
                if rot is not None:
                    rotated = True
                    _rotate(b, v, p, q, *rot)
        if not rotated:
            break
    n2 = np.sum(b * b, axis=1)
    k = int(np.argmin(n2))
    out = np.zeros((3, 3))
    for j in range(3):
        sigma = np.sqrt(n2[j])
        if j != k and sigma > 0:
            out += np.outer(b[j] / sigma, v[j])
    return out


def _jacobi_null(R):
    """jacobi_null: slot j holds column j of R and of V, slot 9 is empty;
    round r pairs slot 9 with r and the others as (r + i, r − i) mod 9."""
    a, v = np.zeros((10, 9)), np.zeros((10, 9))
    a[:9], v[:9] = R.T, np.eye(9)
    tol = 3.0 * EPS64
    for _ in range(30):
        rotated = False
        for rnd in range(9):
            for p in range(10):
                q = rnd if p == 9 else 9 if p == rnd else (2 * rnd - p) % 9
                if p > q:
                    continue
                rot = _rotation(a[p] @ a[p], a[q] @ a[q], a[p] @ a[q], tol)
                if rot is not None:
                    rotated = True
                    _rotate(a, v, p, q, *rot)
        if not rotated:
            break
    return v[int(np.argmin(np.sum(a[:9] ** 2, axis=1)))]


def _refit_null_vector(rows, warps=9, chunk=23, fan_in=3):
    """The refit's null vector of weighted rows (N, 9): each warp's slab,
    chunk rows at a time under its triangle (lanes 0-8), then the triangles
    fan_in at a time, then the Jacobi on the last triangle."""
    N = len(rows)
    slab = -(-N // warps)
    tri = []
    for w in range(warps):
        m = np.zeros((32, 9))
        hi = min(N, w * slab + slab)
        for base in range(w * slab, hi, chunk):
            m[9:] = 0.0
            m[9:9 + min(chunk, hi - base)] = rows[base:min(base + chunk, hi)]
            if np.any(m[9:] != 0):
                _householder_qr(m, 9)
        tri.append(m[:9].copy())
    stride = 1
    while stride < warps:
        for w in range(0, warps, fan_in * stride):
            m = np.zeros((32, 9))
            for c in range(fan_in):
                if w + c * stride < warps:
                    m[9 * c:9 * c + 9] = tri[w + c * stride]
            if np.any(m[9:] != 0):
                _householder_qr(m, 9)
            tri[w] = m[:9].copy()
        stride *= fan_in
    return _jacobi_null(tri[0])


def _sampson(E, x0, x1):
    """The kernel's Sampson error of every row under E (3, 3)."""
    E = E.reshape(9)
    ex0 = E[0] * x0[:, 0] + E[1] * x0[:, 1] + E[2]
    ex1 = E[3] * x0[:, 0] + E[4] * x0[:, 1] + E[5]
    ex2 = E[6] * x0[:, 0] + E[7] * x0[:, 1] + E[8]
    etx0 = x1[:, 0] * E[0] + x1[:, 1] * E[3] + E[6]
    etx1 = x1[:, 0] * E[1] + x1[:, 1] * E[4] + E[7]
    r = x1[:, 0] * ex0 + x1[:, 1] * ex1 + ex2
    return r * r / np.maximum(ex0 ** 2 + ex1 ** 2 + etx0 ** 2 + etx1 ** 2, 1e-30)


def _kernel_sweep(x0, x1, valid, idx):
    rows = ransac.design_rows(x0, x1) * valid[:, None]
    Es = np.stack([_project_essential(_sweep_null_vector(rows[s])) for s in idx])
    counts = np.array([np.sum((_sampson(E, x0, x1) < THRESH ** 2) & valid) for E in Es])
    return Es, counts


def _kernel_refit(x0, x1, valid, w):
    e = _refit_null_vector(ransac.design_rows(x0, x1) * (w * valid)[:, None])
    E = _project_essential(e)
    return E, (_sampson(E, x0, x1) < THRESH ** 2) & valid, e


def _kernel_refit_best(x0, x1, valid, Es, counts):
    """refit_best: the first largest count, its valid inliers weighing 1."""
    cons = (_sampson(Es[int(np.argmax(counts))], x0, x1) < THRESH ** 2) & valid
    return _kernel_refit(x0, x1, valid, cons.astype(np.float64))


@pytest.mark.parametrize("N", [20, 150])
def test_sweep_transcription_matches_jax(N):
    """The sweep's Householder null vector and 3 × 3 Jacobi projection give
    vio_tpu's E up to sign and its counts, every hypothesis."""
    x0, x1, valid = _pairs(N, seed=N)
    idx = _samples(valid, N_HYP, seed=1)
    Es, n = _kernel_sweep(x0, x1, valid, idx)
    Ej, nj = _jax_sweep(x0, x1, valid, idx)
    assert _up_to_sign(Es, Ej).max() <= E_TOL
    np.testing.assert_array_equal(n, nj)


@pytest.mark.parametrize("N", [20, 150])
def test_refit_transcription_matches_jax(N):
    """The refit's row-block QR, its Jacobi on R and the projection give
    vio_tpu's E on the best sample's consensus set and on a fractional
    weighting; refit_best's choice of the best sample and of its consensus
    set gives the same as vio_tpu's argmax and consensus."""
    x0, x1, valid = _pairs(N, seed=N + 7)
    rng = np.random.default_rng(N)
    Es, n = _jax_sweep(x0, x1, valid, _samples(valid, N_HYP, seed=2))
    cons = np.asarray(jsfm._epipolar_err(jnp.asarray(Es[int(np.argmax(n))]), jnp.asarray(x0),
                                         jnp.asarray(x1))) < THRESH ** 2
    w_cons = (cons & valid).astype(np.float64)
    for w in (w_cons, rng.uniform(0.5, 1.5, N) * valid):
        E, inl, _ = _kernel_refit(x0, x1, valid, w)
        Ej = jsfm._eight_point(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(w))
        inl_j = (np.asarray(jsfm._epipolar_err(Ej, jnp.asarray(x0), jnp.asarray(x1)))
                 < THRESH ** 2) & valid
        assert _up_to_sign(E, np.asarray(Ej)).max() <= E_TOL
        np.testing.assert_array_equal(inl, inl_j)
    E, inl, _ = _kernel_refit_best(x0, x1, valid, Es, n)
    Ej = jsfm._eight_point(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(w_cons))
    assert _up_to_sign(E, np.asarray(Ej)).max() <= E_TOL


def test_null_vectors_of_rank_deficient_systems_are_backward_stable():
    """A sample with a row outside ``valid`` has rank 7: the Householder
    vector is one unit vector of its null space, to ≤ BACKWARD_C float64
    eps in backward error (null_backward), as is the refit's of a system
    with most rows zero."""
    x0, x1, valid = _pairs(40, seed=6)
    rows = ransac.design_rows(x0, x1) * valid[:, None]
    limit = ransac.BACKWARD_C * EPS64
    bad = np.where(~valid)[0][:1]
    sample = np.concatenate([bad, _samples(valid, 1, seed=0)[0][:7]])
    A = rows[sample]
    assert np.linalg.matrix_rank(A) == 7
    e = _sweep_null_vector(A)
    assert abs(np.linalg.norm(e) - 1.0) <= 8 * EPS64
    assert ransac.null_backward(A[None], e[None])[0] <= limit
    w = np.zeros(40)
    w[np.where(valid)[0][:12]] = 1.0
    Aw = rows * w[:, None]
    assert ransac.null_backward(Aw[None], _refit_null_vector(Aw)[None])[0] <= limit


def test_refit_best_reference_is_argmax_consensus_refit():
    """refit_best_reference is the sequence essential_ransac_from_samples
    ran before refit_best, bit for bit; of tied counts the first wins."""
    x0, x1, valid = _pairs(80, seed=12)
    X0, X1, V = _t(x0), _t(x1), _t(valid)
    Es, n = ransac.sweep(X0, X1, V, _t(_samples(valid, N_HYP, seed=4)), THRESH)
    n = n.clone()
    first, later = 5, 40
    n[first] = n[later] = int(n.max()) + 1
    got = ransac.refit_best_reference(X0, X1, V, Es, n, THRESH)
    assert int(torch.argmax(n)) == first
    for k, same in ((first, True), (later, False)):
        m0, m1 = ransac.masked(X0, X1, V)
        inl = (ransac.epipolar_err(Es[k], m0, m1) < THRESH ** 2) & V
        want = ransac.refit_reference(X0, X1, V, inl.to(X0.dtype), THRESH)
        assert all(torch.equal(a, b) for a, b in zip(got, want)) == same
    assert ransac.refit_best(X0, X1, V, Es, n, THRESH)[0].equal(got[0])
    assert ransac.refit_best.launches == ransac.refit_best.captured == 0


@pytest.mark.parametrize("N", [20, 150])
def test_plain_sweep_matches_jax(N):
    x0, x1, valid = _pairs(N, seed=N)
    idx = _samples(valid, N_HYP, seed=1)
    Es, n = ransac.sweep(_t(x0), _t(x1), _t(valid), _t(idx), THRESH)
    Ej, nj = _jax_sweep(x0, x1, valid, idx)
    assert Es.dtype == torch.float64 and Es.shape == (N_HYP, 3, 3)
    assert n.dtype == torch.int64
    np.testing.assert_array_equal(n.numpy(), nj)
    assert _up_to_sign(Es.numpy(), Ej).max() <= E_TOL
    assert int(n.max()) >= 0.6 * valid.sum()          # some sample is all inliers
    assert ransac.sweep.launches == 0                  # the CPU runs the plain version


@pytest.mark.parametrize("N", [20, 150])
def test_plain_refit_matches_jax(N):
    """The refit on a weighted system: the best sample's consensus set,
    as essential_ransac weighs it, and a fractional weighting."""
    x0, x1, valid = _pairs(N, seed=N + 7)
    rng = np.random.default_rng(N)
    Es, n = _jax_sweep(x0, x1, valid, _samples(valid, N_HYP, seed=2))
    cons = np.asarray(jsfm._epipolar_err(jnp.asarray(Es[int(np.argmax(n))]), jnp.asarray(x0),
                                         jnp.asarray(x1))) < THRESH ** 2
    for w in ((cons & valid).astype(np.float64), rng.uniform(0.5, 1.5, N) * valid):
        E, inl, cnt = ransac.refit(_t(x0), _t(x1), _t(valid), _t(w), THRESH)
        Ej = jsfm._eight_point(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(w))
        inl_j = (np.asarray(jsfm._epipolar_err(Ej, jnp.asarray(x0), jnp.asarray(x1)))
                 < THRESH ** 2) & valid
        assert _up_to_sign(E.numpy(), np.asarray(Ej)).max() <= E_TOL
        np.testing.assert_array_equal(inl.numpy(), inl_j)
        assert int(cnt) == int(inl_j.sum())
    assert ransac.refit.launches == 0


@pytest.mark.parametrize("N", [20, 150])
def test_from_samples_matches_jax_essential_ransac(N):
    """essential_ransac_from_samples fed the samples that vio_tpu's key
    draws (sfm.py:180-183), against vio_tpu.init.sfm.essential_ransac on
    that key."""
    x0, x1, valid = _pairs(N, seed=3 * N)
    key = jax.random.PRNGKey(N)
    p = jnp.asarray(valid).astype(jnp.float32) + 1e-9
    idx = jax.vmap(lambda k: jax.random.choice(k, N, (8,), replace=False,
                                               p=p / jnp.sum(p)))(
        jax.random.split(key, 256))
    Ej, inl_j, n_j = jsfm.essential_ransac(jnp.asarray(x0), jnp.asarray(x1),
                                           jnp.asarray(valid), key, THRESH)
    E, inl, n = tsfm.essential_ransac_from_samples(
        _t(x0), _t(x1), _t(valid), _t(np.asarray(idx, np.int64)), THRESH)
    assert _up_to_sign(E.numpy(), np.asarray(Ej)).max() <= E_TOL
    np.testing.assert_array_equal(inl.numpy(), np.asarray(inl_j))
    assert int(n) == int(n_j) >= 0.6 * valid.sum()


def test_essential_ransac_is_its_samples_then_the_sweep():
    """essential_ransac = the host draw of ransac_samples, then
    essential_ransac_from_samples; the host mask the caller passes gives
    the same draw as the device mask read back."""
    x0, x1, valid = _pairs(60, seed=5)
    gen = lambda: torch.Generator().manual_seed(11)   # noqa: E731
    idx = tsfm.ransac_samples(valid, 256, gen())
    assert idx.shape == (256, 8) and idx.dtype == torch.int64
    assert all(len(set(r)) == 8 and valid[r].all() for r in idx.tolist())
    want = tsfm.essential_ransac_from_samples(_t(x0), _t(x1), _t(valid), idx, THRESH)
    for host in (None, valid):
        got = tsfm.essential_ransac(_t(x0), _t(x1), _t(valid), gen(), THRESH, host_valid=host)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    """A CPU tensor takes the plain version and launches nothing."""
    x0, x1, valid = _pairs(30, seed=9)
    idx = _samples(valid, 4, seed=0)
    Es, n = ransac.sweep(_t(x0), _t(x1), _t(valid), _t(idx), THRESH)
    Er, nr = ransac.sweep_reference(_t(x0), _t(x1), _t(valid), _t(idx), THRESH)
    assert torch.equal(Es, Er) and torch.equal(n, nr)
    assert ransac.sweep.launches == ransac.sweep.captured == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_backward_errors_hold_plain_and_catch_wrong_e(dtype):
    """ops/ransac.py's accuracy measures, which the kernel is held to on
    the card: the plain version's null vectors and projections stay within
    BACKWARD_C·eps on small-motion samples (κ ~ 1e5, where E itself is not
    determined in float32), and a zero E, a projection that drops the
    wrong singular value, E of the wrong sign or a vector that is no null
    vector are far outside."""
    x0, x1, valid = _pairs(150, seed=4)
    x1 = x0 + 0.01 * (x1 - x0)                    # the tracker's frame-to-frame motion
    idx = _samples(valid, 64, seed=3)
    X0, X1 = _t(x0).to(dtype), _t(x1).to(dtype)
    A = (ransac.design_rows(X0.double().numpy(), X1.double().numpy()) * valid[:, None])[idx]
    assert np.median(ransac.e_condition(A)) > 1e4
    _, _, Vh = torch.linalg.svd(torch.as_tensor(A, dtype=dtype), full_matrices=True)
    e = Vh[:, -1, :]
    U, _, Vt = torch.linalg.svd(e.reshape(-1, 3, 3))
    E = U[..., :2] @ Vt[..., :2, :]
    e, E = e.double().numpy(), E.double().numpy()
    limit = ransac.BACKWARD_C * torch.finfo(dtype).eps
    assert ransac.null_backward(A, e).max() <= limit
    assert ransac.projection_backward(e, E).max() <= limit
    U, Vt = U.double().numpy(), Vt.double().numpy()
    wrong_sigma = U[..., [0, 2]] @ Vt[..., [0, 2], :]
    for bad in (0 * E, wrong_sigma, -E):
        assert ransac.projection_backward(e, bad).min() > 1e4 * limit
    rng = np.random.default_rng(0)
    assert ransac.null_backward(A, rng.normal(size=e.shape)).min() > 1e3 * limit


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_ransac_kernel_matches_plain_on_card(dtype):
    """The CUDA kernel against its plain version run in float64 on the
    same inputs, on the card at the tracker's shape (N = 150, 256
    hypotheses): every sample's null vector and projection within
    BACKWARD_C·eps in backward error (ops/ransac.py), E up to sign within
    64·eps·κ where eps·κ ≤ 1e-2, the counts equal to the plain scoring of
    the kernel's E on 99 % of the hypotheses and within 1 on the rest, and
    in float64 equal to the plain sweep's; the refit on the best
    consensus set likewise, and refit_best against refit_best_reference
    run in float64; both refits raise above MAX_REFIT_N rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x0, x1, valid = _pairs(150, seed=4)
    idx = _samples(valid, 256, seed=3)
    dev = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")  # noqa: E731
    X0, X1, V, I = dev(x0, dtype), dev(x1, dtype), dev(valid), dev(idx)
    W0, W1 = X0.double(), X1.double()
    eps, limit = torch.finfo(dtype).eps, ransac.BACKWARD_C * torch.finfo(dtype).eps
    host = lambda t: t.double().cpu().numpy()   # noqa: E731
    e = torch.empty((256, 9), dtype=dtype, device="cuda")
    E, n = ransac.sweep(X0, X1, V, I, THRESH, null_out=e)
    torch.cuda.synchronize()
    E64, n64 = ransac.sweep_reference(W0, W1, V, I, THRESH)
    rows = ransac.design_rows(host(X0), host(X1)) * valid[:, None]
    assert np.all(ransac.null_backward(rows[idx], host(e)) <= limit)
    assert np.all(ransac.projection_backward(host(e), host(E)) <= limit)
    kappa = ransac.e_condition(rows[idx])
    posed = eps * kappa <= 1e-2
    dE = _up_to_sign(host(E), host(E64))
    assert np.all(dE[posed] <= 64 * eps * kappa[posed])
    m0, m1 = ransac.masked(X0, X1, V)
    n_own = ((ransac.epipolar_err(E, m0, m1) < THRESH * THRESH) & V).sum(-1)
    d = (n - n_own).abs().cpu().numpy()
    assert (d == 0).mean() >= 0.99 and d.max() <= 1
    if dtype == torch.float64:
        assert torch.equal(n, n64)
    best = int(torch.argmax(n64))
    w64 = ((ransac.epipolar_err(E64[best], *ransac.masked(W0, W1, V)) < THRESH ** 2)
           & V).double()
    er = torch.empty(9, dtype=dtype, device="cuda")
    Er, inl, c = ransac.refit(X0, X1, V, w64.to(dtype), THRESH, null_out=er)
    torch.cuda.synchronize()
    Er64, inl64, c64 = ransac.refit_reference(W0, W1, V, w64, THRESH)
    Aw = (rows * host(w64)[:, None])[None]
    assert ransac.null_backward(Aw, host(er)[None])[0] <= limit
    assert ransac.projection_backward(host(er)[None], host(Er)[None])[0] <= limit
    assert _up_to_sign(host(Er), host(Er64)).max() <= (1e-3 if dtype == torch.float32
                                                       else 1e-9)
    assert int((inl != inl64).sum()) <= 1 and abs(int(c) - int(c64)) <= 1
    eb = torch.empty(9, dtype=dtype, device="cuda")
    Eb, inl_b, cb = ransac.refit_best(X0, X1, V, E, n, THRESH, null_out=eb)
    torch.cuda.synchronize()
    Eb64, inl_b64, cb64 = ransac.refit_best_reference(W0, W1, V, E.double(), n, THRESH)
    m0, m1 = ransac.masked(X0, X1, V)
    wb = ((ransac.epipolar_err(E[int(torch.argmax(n))], m0, m1) < THRESH ** 2) & V)
    Ab = (rows * host(wb)[:, None])[None]
    assert ransac.null_backward(Ab, host(eb)[None])[0] <= limit
    assert ransac.projection_backward(host(eb)[None], host(Eb)[None])[0] <= limit
    assert _up_to_sign(host(Eb), host(Eb64)).max() <= 64 * eps * ransac.e_condition(Ab)[0]
    assert int((inl_b != inl_b64).sum()) <= 1 and abs(int(cb) - int(cb64)) <= 1
    big = torch.zeros((ransac.MAX_REFIT_N + 1, 2), dtype=dtype, device="cuda")
    ones = torch.ones(len(big), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="at most"):
        ransac.refit(big, big, ones, ones.to(dtype), THRESH)
    with pytest.raises(ValueError, match="at most"):
        ransac.refit_best(big, big, ones, E, n, THRESH)
