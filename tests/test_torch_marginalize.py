"""The port's marginalization entry points (vio_tpu_torch/solver/
marginalize.py: ``marginalize_old``, ``marginalize_new`` on the device and
``marginalize_old_host``) against the JAX package's, on
vio_tpu.testing.make_window_problem in float64, carried across with
vio_tpu_torch.convert.

Tolerances are relative to each array's largest entry, as
tests/test_torch_window_lm.py holds the assembly (which agrees to 4e-16
here).  The chain's pseudo-inverse of the evicted block amplifies that
round-off: two host-float64 numpy chains fed assemblies equal to 4e-16
end 2e-8 apart, and the JAX package's own device and host chains 1.8e-8
(scripts/torch_round_off_spread.py marginalize).  So rtol 1e-7, atol 1e-10.  H_prior and
b_prior are compared elementwise.  ``eigh``'s eigenvectors carry
arbitrary signs (and bases inside repeated eigenvalues) in each library,
so the sqrt form (Jt_prior_inv, err_prior) is compared by invariants.
JtᵀJt is the pseudo-inverse of the prior, and these priors' spectra run
down to eigenvalues at round-off on both sides of the 1e-8 cut: the JAX
package's own device and host chains give JtᵀJt 25-81 % apart.  So the
invariants are taken through H_prior, which weights each direction by its
eigenvalue: H·JtᵀJt·H (= H_prior) and H·Jtᵀ·err (= -b_prior on H's
range), at rtol 1e-7; and errᵀerr, the prior's chi², at rtol 1e-5 (the
JAX chains: 3e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import testing
from vio_tpu.solver import marginalize as jmarg
from vio_tpu_torch import convert
from vio_tpu_torch import testing as ttesting
from vio_tpu_torch.solver import marginalize as tmarg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _as_dict(nt):
    out = {}
    for k, v in zip(nt._fields, nt):
        out[k] = _as_dict(v) if hasattr(v, "_fields") else np.asarray(v)
    return out


def _close(actual, desired, rtol=1e-7, atol=1e-10, name=""):
    actual = np.asarray(actual)
    desired = np.asarray(desired)
    assert actual.shape == desired.shape, name
    err = np.abs(actual - desired).max(initial=0.0)
    bound = atol + rtol * np.abs(desired).max(initial=0.0)
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


def _same_prior(port, ref):
    """(H_prior, b_prior, err_prior, Jt_prior_inv) of both packages."""
    (Hp, bp, ep, Jp), (Hr, br, er, Jr) = ([np.asarray(x) for x in out]
                                          for out in (port, ref))
    _close(Hp, Hr, name="H_prior")
    _close(bp, br, name="b_prior")
    _close(Hp @ Jp.T @ Jp @ Hp, Hr @ Jr.T @ Jr @ Hr, name="H·JtᵀJt·H")
    _close(Hp @ (Jp.T @ ep), Hr @ (Jr.T @ er), name="H·Jtᵀerr")
    _close(ep @ ep, er @ er, rtol=1e-5, name="errᵀerr")


@pytest.fixture(scope="module", params=[(4, 32, 4), (10, 64, 8)],
                ids=["W4_F32", "W10_F64"])
def problem(request):
    W, F, M = request.param
    states, f, _ = testing.make_window_problem(
        window_size=W, max_features=F, imu_per_interval=M, dtype=jnp.float64,
        perturb=0.0)
    ts = convert.window_states_from_numpy(_as_dict(states), **CPU64)
    tf = convert.window_factors_from_numpy(_as_dict(f), **CPU64)
    return states, f, ts, tf


def test_marginalize_old_prior_structure():
    """tests/test_window.py::test_marginalize_old_prior_structure on the
    port's own problem builder."""
    states, f, _ = ttesting.make_window_problem(
        window_size=4, max_features=32, perturb=0.0, **CPU64)
    Hp = tmarg.marginalize_old(states, f)[0].numpy()
    P = Hp.shape[0]
    assert np.allclose(Hp, Hp.T, atol=1e-8)
    w = np.linalg.eigvalsh(Hp)
    assert w.min() > -1e-6 * max(w.max(), 1.0)
    assert np.abs(Hp[P - 15:, :]).max() < 1e-12
    # marginalizing frame 0 must couple the remaining frames to each other
    assert np.abs(Hp[6:12, 21:27]).max() > 1e-6


def test_marginalize_old_matches_jax(problem):
    states, f, ts, tf = problem
    _same_prior(tmarg.marginalize_old(ts, tf), jmarg.marginalize_old(states, f))


def test_marginalize_old_host_matches_jax(problem):
    """The host-float64 chain on the port's assembly, against the JAX
    package's, and against the port's own device chain."""
    states, f, ts, tf = problem
    out = tmarg.marginalize_old_host(ts, tf)
    assert all(isinstance(x, np.ndarray) and x.dtype == np.float64 for x in out)
    _same_prior(out, jmarg.marginalize_old_host(states, f))
    _same_prior(out, tmarg.marginalize_old(ts, tf))


def test_marginalize_new_matches_jax(problem):
    """Frame W-1 out of a prior that couples every frame: the prior of a
    marginalize_old, folded in as the problem's own."""
    states, f, ts, tf = problem
    Hp, bp, _, _ = jmarg.marginalize_old(states, f)
    f = f._replace(H_prior=Hp, b_prior=bp)
    tf = tf._replace(H_prior=torch.as_tensor(np.array(Hp)),
                     b_prior=torch.as_tensor(np.array(bp)))
    out = tmarg.marginalize_new(tf)
    _same_prior(out, jmarg.marginalize_new(f))
    _same_prior(out, tmarg.marginalize_new_host(np.asarray(Hp), np.asarray(bp)))
    assert out[0].device.type == "cpu" and out[0].dtype == torch.float64


def test_marginalize_old_follows_its_inputs_in_float32(problem):
    """float32 states give a float32 prior on their device.  It is no
    approximation of the float64 one: in float32 the eliminated block's
    round-off eigenvalues (~1 at entries of 1e7) pass the 1e-8 cut and are
    inverted, in the JAX package alike (its float32 chain is 60-180 % off
    the float64 host chain in H_prior on these problems), which is why
    the estimator keeps the chain on the host in float64."""
    _, _, ts, tf = problem
    ts32 = ts._replace(**{k: v.float() for k, v in ts._asdict().items()})
    tf32 = convert.window_factors_from_numpy(
        {k: convert.to_numpy(v) for k, v in tf._asdict().items()},
        device="cpu", dtype=torch.float32)
    out = tmarg.marginalize_old(ts32, tf32) + tmarg.marginalize_new(tf32)
    assert all(x.dtype == torch.float32 and x.device.type == "cpu" for x in out)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    Hp = out[0]
    assert float((Hp - Hp.T).abs().max()) <= 1e-6 * float(Hp.abs().max())
