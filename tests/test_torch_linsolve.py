"""The port's SPD solve (vio_tpu_torch/ops/linsolve.py) against the JAX
package's: the plain Gauss-Jordan versions (unblocked, as the CUDA kernel
works in registers; blocked, as it works above that) against the Pallas
kernel run in interpret mode (as tests/test_ops.py runs it), spd_solve
against vio_tpu's on float64, an ill-conditioned system of the estimator's
kind against jnp.linalg.solve, and the CUDA kernel against the plain
version on a card."""
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vio_tpu.ops import linsolve as jlin
from vio_tpu.solver import pcg as jpcg
from vio_tpu_torch.ops import _build
from vio_tpu_torch.ops import linsolve as tlin
from vio_tpu_torch.solver import pcg as tpcg

torch.set_num_threads(1)


def _spd(P, seed, dtype):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((P, P))
    A = (M @ M.T + P * np.eye(P)).astype(dtype)
    b = rng.standard_normal(P).astype(dtype)
    return A, b


@pytest.mark.parametrize("P", [17, 171, 300])
def test_gj_reference_matches_pallas_interpret(P):
    """float32 elimination, both sides: rtol = atol = 2e-4 is
    tests/test_ops.py's own bound for f32 elimination.  P = 300 is above
    the kernel's register regime, so the plain version is the blocked one."""
    _against_pallas(tlin.gj_solve_reference, P)


def _against_pallas(solve, P):
    A, b = _spd(P, 3 + P, np.float32)
    N = max(jlin._round_up(P, 128), 256)
    A_pad = jnp.zeros((N, N), jnp.float32).at[:P, :P].set(A)
    b_pad = jnp.zeros((N, 128), jnp.float32).at[:P, :].set(b[:, None])
    x_jax = np.asarray(jlin._gj_solve_pallas(A_pad, b_pad, P, interpret=True))[:P, 0]
    x = solve(torch.from_numpy(A), torch.from_numpy(b))
    assert x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("version,P", [
    ("unblocked", 300), ("blocked", 171), ("blocked", 64), ("blocked", 40), ("blocked", 1)])
def test_gj_plain_versions_match_pallas_interpret(version, P):
    """Either plain version at sizes the other one serves by default:
    whole panels (64), a ragged last panel (40, 171), less than one (1)."""
    _against_pallas(getattr(tlin, f"gj_solve_{version}_reference"), P)


def test_reference_dispatch_follows_the_kernel_regimes(monkeypatch):
    """gj_solve_reference is the unblocked version up to REGISTER_MAX_P
    and the blocked one above; the sizes are gj_solve.cu's own."""
    src = (_build.CSRC / "gj_solve.cu").read_text()
    assert int(re.search(r"kRegMaxP<float> = (\d+)", src)[1]) == tlin.REGISTER_MAX_P[torch.float32]
    assert int(re.search(r"kRegMaxP<double> = (\d+)", src)[1]) == tlin.REGISTER_MAX_P[torch.float64]
    assert int(re.search(r"kNB = (\d+)", src)[1]) == tlin.PANEL
    used = []
    monkeypatch.setattr(tlin, "gj_solve_unblocked_reference",
                        lambda A, b: used.append("unblocked"))
    monkeypatch.setattr(tlin, "gj_solve_blocked_reference",
                        lambda A, b: used.append("blocked"))
    for dtype, edge in tlin.REGISTER_MAX_P.items():
        tlin.gj_solve_reference(torch.eye(edge, dtype=dtype), torch.ones(edge, dtype=dtype))
        tlin.gj_solve_reference(torch.eye(edge + 1, dtype=dtype), torch.ones(edge + 1, dtype=dtype))
    assert used == ["unblocked", "blocked"] * 2


@pytest.mark.parametrize("P", [40, 171])
def test_spd_solve_f64_matches_jax(P):
    """float64: the port's elimination against vio_tpu.spd_solve (LU on
    the CPU) agree to round-off of a well-conditioned system."""
    A, b = _spd(P, 5 + P, np.float64)
    x_jax = np.asarray(jlin.spd_solve(jnp.asarray(A), jnp.asarray(b)))
    x = tlin.spd_solve(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=0, atol=1e-9)


@pytest.mark.parametrize("version", ["unblocked", "blocked"])
def test_gj_plain_versions_f64_match_jax(version):
    """Both plain versions in float64 against vio_tpu.spd_solve, as above."""
    A, b = _spd(200, 9, np.float64)
    x_jax = np.asarray(jlin.spd_solve(jnp.asarray(A), jnp.asarray(b)))
    x = getattr(tlin, f"gj_solve_{version}_reference")(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=0, atol=1e-9)


def test_ill_conditioned_matches_jax():
    """A system of the kind the LM loop solves when the window is poorly
    constrained: eigenvalues log-spaced over 1e5, damped with
    λ = 1e-5·max|diag|, P = 171, float64.  Elimination without pivoting
    against jnp.linalg.solve (pivoted LU): two backward-stable solves of
    one system differ by at most ~cond·eps relative to the solution, and
    that is the bound; the backward error is held to P·eps."""
    P = 171
    rng = np.random.default_rng(7)
    Q, _ = np.linalg.qr(rng.standard_normal((P, P)))
    A = (Q * np.logspace(0, -5, P)) @ Q.T
    A = 0.5 * (A + A.T)
    A += 1e-5 * np.abs(np.diag(A)).max() * np.eye(P)
    b = rng.standard_normal(P)
    cond = np.linalg.cond(A)
    assert 1e4 < cond < 1e5
    x_jax = np.asarray(jnp.linalg.solve(jnp.asarray(A), jnp.asarray(b)))
    eps = np.finfo(np.float64).eps
    for solve in (tlin.spd_solve, tlin.gj_solve_unblocked_reference,
                  tlin.gj_solve_blocked_reference):
        x = solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
        assert np.abs(x - x_jax).max() <= cond * eps * np.abs(x_jax).max()
        eta = np.linalg.norm(A @ x - b) / (
            np.linalg.norm(A) * np.linalg.norm(x) + np.linalg.norm(b))
        assert eta <= P * eps


def test_cpu_solve_never_builds_or_launches(monkeypatch):
    """A CPU tensor takes the plain version: no build, no launch."""
    def _no_build():
        raise AssertionError("a CPU solve must not build the CUDA library")

    monkeypatch.setattr(_build, "load", _no_build)
    monkeypatch.setattr(_build, "build", _no_build)
    monkeypatch.setattr(tlin.gj_solve, "launches", 0)
    A, b = _spd(171, 1, np.float64)
    x = tlin.spd_solve(torch.from_numpy(A), torch.from_numpy(b))
    assert tlin.gj_solve.launches == 0
    np.testing.assert_allclose(A @ x.numpy(), b, atol=1e-9)


def test_gj_solve_rejects_cpu_tensors():
    """The kernel wrapper takes CUDA tensors only: it never runs the plain
    version in the kernel's place."""
    A, b = _spd(17, 2, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tlin.gj_solve(torch.from_numpy(A), torch.from_numpy(b))


def test_pcg_matches_jax():
    """Jacobi-PCG, the spd_solve route above P=1024, at a small size."""
    A, b = _spd(60, 7, np.float64)
    x_jax, k_jax = jpcg.pcg_solve(jnp.asarray(A), jnp.asarray(b))
    x, k = tpcg.pcg_solve(torch.from_numpy(A), torch.from_numpy(b))
    assert k == int(k_jax)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_jax), rtol=1e-9, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [1, 2, 17, 33, 127, 128, 171, 176, 177, 300, 1023, 1024])
def test_gj_kernel_matches_reference_on_card(P, dtype):
    """The CUDA kernel against its plain version on the card, at both
    sides of each type's register/blocked boundary (127|128 in float64,
    176|177 in float32); the f32 bound is test_ops.py's, plus the
    relative residual."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    npd = np.float32 if dtype == torch.float32 else np.float64
    A, b = _spd(P, 11 + P, npd)
    At = torch.from_numpy(A).cuda()
    bt = torch.from_numpy(b).cuda()
    x = tlin.gj_solve(At, bt)
    torch.cuda.synchronize()
    x_ref = tlin.gj_solve_reference(At, bt)
    tol = 2e-4 if dtype == torch.float32 else 1e-10
    torch.testing.assert_close(x, x_ref, rtol=tol, atol=tol)
    res = torch.linalg.norm(At @ x - bt) / torch.linalg.norm(bt)
    assert float(res) <= (1e-4 if dtype == torch.float32 else 1e-12)
