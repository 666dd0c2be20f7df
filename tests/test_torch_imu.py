"""The port's Lie helpers and IMU preintegration (vio_tpu_torch/utils/lie.py,
vio_tpu_torch/imu.py) against the JAX package's, on the same seeded numpy
inputs in float64.  Tolerances: float64 with a different summation order
(rtol 1e-10, atol 1e-12) unless stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import imu as jimu
from vio_tpu.utils import lie as jlie
from vio_tpu_torch import imu as timu
from vio_tpu_torch.utils import lie as tlie

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _rots(rng, n):
    return np.array(jlie.quat_to_mat(jnp.asarray(_quats(rng, n))))


# (name, input makers); each function is batched in the port and vmapped in JAX
_LIE_CASES = [
    ("quat_mul", lambda r: (_quats(r, 32), _quats(r, 32))),
    ("quat_rotate", lambda r: (_quats(r, 32), r.standard_normal((32, 3)))),
    ("quat_to_mat", lambda r: (_quats(r, 32),)),
    ("mat_to_quat", lambda r: (_rots(r, 32),)),
    ("so3_exp_quat", lambda r: (np.concatenate(
        [r.standard_normal((30, 3)), np.zeros((1, 3)), 1e-9 * np.ones((1, 3))]),)),
    ("quat_log", lambda r: (_quats(r, 32),)),
    ("so3_jacobian_r_inv", lambda r: (0.5 * r.standard_normal((32, 3)),)),
    ("ypr_to_mat", lambda r: (90.0 * r.standard_normal((32, 3)),)),
    ("mat_to_ypr", lambda r: (_rots(r, 32),)),
    ("q_left_corner", lambda r: (_quats(r, 32),)),
    ("q_right_corner", lambda r: (_quats(r, 32),)),
]


@pytest.mark.parametrize("name,make", _LIE_CASES, ids=[c[0] for c in _LIE_CASES])
def test_lie_matches_jax(name, make):
    args = make(np.random.default_rng(len(name)))
    ref = np.asarray(jax.vmap(getattr(jlie, name))(*map(jnp.asarray, args)))
    out = getattr(tlie, name)(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_g_to_R_matches_jax():
    g = np.array([0.3, -0.2, 9.7])
    ref = np.asarray(jlie.g_to_R(jnp.asarray(g)))
    np.testing.assert_allclose(tlie.g_to_R(torch.from_numpy(g)).numpy(), ref,
                               rtol=RTOL, atol=ATOL)


def _scatter_mask(seed, batch, M):
    """A mask with live slots scattered through the buffer (not a prefix),
    every interval with at least one live slot but the last, which has
    none."""
    rng = np.random.default_rng(seed)
    mask = rng.random(batch + (M,)) < 0.6
    mask.reshape(-1, M)[:, rng.integers(M)] = True
    mask.reshape(-1, M)[-1] = False
    return mask


def _imu_buffers(seed, batch=(10,), M=64, scattered=False):
    """Seeded IMU buffers over leading dims ``batch``, as the estimator
    packs them (a stationary-ish body plus noise), with masked tails of
    random length (the first interval full) or a scattered mask."""
    rng = np.random.default_rng(seed)
    dts = np.full(batch + (M,), 1.0 / 200.0) * (1.0 + 0.01 * rng.standard_normal(batch + (M,)))
    accs = np.array([0.0, 0.0, 9.81]) + 0.5 * rng.standard_normal(batch + (M, 3))
    gyrs = 0.3 * rng.standard_normal(batch + (M, 3))
    n_live = rng.integers(1, M + 1, size=batch)
    n_live.flat[0] = M
    mask = _scatter_mask(seed, batch, M) if scattered else np.arange(M) < n_live[..., None]
    acc0 = np.array([0.0, 0.0, 9.81]) + 0.5 * rng.standard_normal(batch + (3,))
    gyr0 = 0.3 * rng.standard_normal(batch + (3,))
    ba = 0.01 * rng.standard_normal(batch + (3,))
    bg = 0.001 * rng.standard_normal(batch + (3,))
    nd = np.asarray(jimu.noise_diag(0.2687, 0.2121, 7.07e-6, 7.07e-7))
    return dts, accs, gyrs, mask, acc0, gyr0, ba, bg, nd


@pytest.mark.parametrize("exact_noise", [True, False], ids=["exact", "independent"])
def test_preintegrate_batch_matches_jax(exact_noise):
    args = _imu_buffers(11)
    ref = jimu.preintegrate_batch(*map(jnp.asarray, args), exact_noise)
    out = timu.preintegrate_batch(*map(torch.from_numpy, args), exact_noise)
    for name in timu.PreintState._fields:
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_noise_diag_matches_jax():
    ref = np.asarray(jimu.noise_diag(0.2687, 0.2121, 7.07e-6, 7.07e-7))
    np.testing.assert_array_equal(
        timu.noise_diag(0.2687, 0.2121, 7.07e-6, 7.07e-7).numpy(), ref)


def test_evaluate_matches_jax():
    """The 15-dim IMU residual with first-order bias correction, batched
    over the window intervals in the port, vmapped in JAX."""
    args = _imu_buffers(12)
    st_j = jimu.preintegrate_batch(*map(jnp.asarray, args), True)
    st_t = timu.preintegrate_batch(*map(torch.from_numpy, args), True)
    rng = np.random.default_rng(13)
    W = args[0].shape[0]
    g = np.array([0.0, 0.0, 9.81])
    Pi, Pj, Vi, Vj = (rng.standard_normal((W, 3)) for _ in range(4))
    Qi, Qj = _quats(rng, W), _quats(rng, W)
    Bai, Bgi, Baj, Bgj = (0.01 * rng.standard_normal((W, 3)) for _ in range(4))
    states = (Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj)
    ref = jax.vmap(jimu.evaluate, in_axes=(0, None) + (0,) * 10)(
        st_j, jnp.asarray(g), *map(jnp.asarray, states))
    out = timu.evaluate(st_t, torch.from_numpy(g), *map(torch.from_numpy, states))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-11)


def _to(args, dtype, device="cpu"):
    return [torch.as_tensor(a, device=device) if a.dtype == np.bool_
            else torch.as_tensor(a, dtype=dtype, device=device) for a in args]


@pytest.mark.parametrize("exact_noise", [True, False], ids=["exact", "independent"])
def test_preintegrate_cpu_takes_the_plain_route(exact_noise):
    """CPU tensors go to the plain loop, bit for bit, and the kernel's
    counters stay at 0."""
    timu.preintegrate_kernel.launches = timu.preintegrate_kernel.captured = 0
    args = _to(_imu_buffers(21, (2, 3), 8, scattered=True), torch.float64)
    out = timu.preintegrate(*args, exact_noise)
    ref = timu.preintegrate_reference(*args, exact_noise)
    for name in timu.PreintState._fields:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name
    assert timu.preintegrate_kernel.launches == timu.preintegrate_kernel.captured == 0


@pytest.mark.parametrize("exact_noise", [True, False], ids=["exact", "independent"])
def test_preintegrate_masked_slots_leave_the_carry(exact_noise):
    """A scattered mask integrates exactly the live samples: the same bits
    as those samples packed into a prefix.  The kernel skips masked slots,
    which is this semantics."""
    batch, M = (6,), 24
    dts, accs, gyrs, mask, *rest = _imu_buffers(22, batch, M, scattered=True)
    packed = [np.zeros_like(a) for a in (dts, accs, gyrs)]
    prefix = np.zeros_like(mask)
    for w in range(batch[0]):
        live = np.flatnonzero(mask[w])
        for p, a in zip(packed, (dts, accs, gyrs)):
            p[w, :len(live)] = a[w, live]
        prefix[w, :len(live)] = True
    out = timu.preintegrate(*_to((dts, accs, gyrs, mask, *rest), torch.float64), exact_noise)
    ref = timu.preintegrate(*_to((*packed, prefix, *rest), torch.float64), exact_noise)
    for name in timu.PreintState._fields:
        assert torch.equal(getattr(out, name), getattr(ref, name)), name


def test_preintegrate_kernel_takes_cuda_tensors_only():
    """The kernel's wrapper refuses what it cannot launch: CPU tensors
    here, before any build."""
    args = _to(_imu_buffers(23, (2,), 4), torch.float64)
    n = timu.preintegrate_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        timu.preintegrate_kernel(*args)
    assert timu.preintegrate_kernel.launches == n


# The kernel against its plain version on the card.  float64: the file's
# RTOL/ATOL relative to each leaf's largest entry (the two sum in another
# order and the kernel's FMAs round once).  float32: F32_RTOL of each leaf's
# largest entry: both round in float32 (eps 6e-8) at each of up to 72 steps
# in different orders; on an H100 the two differ by 1.3e-7 to 6.8e-7 at
# M = 48 and 72 (chip_smoke phase 26).
F32_RTOL = 2e-5
_CARD_CASES = [(1, (10,), False), (8, (2, 5), True), (48, (10,), False),
               (72, (10,), True), (72, (3, 2, 2), False)]


def _close_by_leaf(out, ref, rtol, atol):
    for name in timu.PreintState._fields:
        a, b = getattr(out, name), getattr(ref, name)
        bound = atol + rtol * float(b.abs().max())
        d = float((a - b).abs().max()) if a.numel() else 0.0
        assert d <= bound, f"{name}: {d:.3e} > {bound:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("exact_noise", [True, False], ids=["exact", "independent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("M,batch,scattered", _CARD_CASES,
                         ids=[f"M{m}-{'x'.join(map(str, b))}-{'scattered' if s else 'prefix'}"
                              for m, b, s in _CARD_CASES])
def test_preintegrate_kernel_matches_plain_on_card(M, batch, scattered, dtype, exact_noise):
    """``preintegrate`` on CUDA tensors (the kernel) against the plain loop
    on the same tensors, at ragged and scattered masks and leading dims."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _to(_imu_buffers(31 + M, batch, M, scattered), dtype, "cuda")
    n = timu.preintegrate_kernel.launches
    out = timu.preintegrate(*args, exact_noise)
    torch.cuda.synchronize()
    assert timu.preintegrate_kernel.launches == n + 1
    ref = timu.preintegrate_reference(*args, exact_noise)
    if dtype == torch.float64:
        _close_by_leaf(out, ref, RTOL, ATOL)
    else:
        _close_by_leaf(out, ref, F32_RTOL, 0.0)


@pytest.mark.gpu
def test_preintegrate_kernel_graph_replay_is_the_eager_launch():
    """A capture records one launch (``captured``, not ``launches``), and
    its replay gives the eager launch's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = _to(_imu_buffers(41, (10,), 48, scattered=True), torch.float64, "cuda")
    eager = timu.preintegrate_kernel(*args)
    launches, captured = timu.preintegrate_kernel.launches, timu.preintegrate_kernel.captured
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        out = timu.preintegrate_kernel(*args)
    assert timu.preintegrate_kernel.captured == captured + 1
    assert timu.preintegrate_kernel.launches == launches
    g.replay()
    torch.cuda.synchronize()
    for name in timu.PreintState._fields:
        assert torch.equal(getattr(out, name), getattr(eager, name)), name
