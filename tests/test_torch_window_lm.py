"""The port's window assembly and LM solve (vio_tpu_torch/solver/window.py,
lm.py, marginalize.py) against the JAX package's, on
vio_tpu.testing.make_window_problem in float64, carried across with
vio_tpu_torch.convert.

Tolerances are relative to each array's largest entry (``_close``), as
tests/test_solver.py compares the two assembly paths: the Hessian's
entries are sums of terms up to ~1e8 with cancellation, so an entry
carries the round-off of its summands, not of itself.  Assembly: rtol
1e-9, atol 1e-10 (float64, another summation order).  The LM solve must
take the same branch decisions, so its iteration count is exact and only
round-off separates the states (rtol 1e-7, atol 1e-9)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import config as jconfig
from vio_tpu import testing
from vio_tpu.solver import lm as jlm
from vio_tpu.solver import marginalize as jmarg
from vio_tpu.solver import window as jW
from vio_tpu_torch import convert
from vio_tpu_torch.solver import lm as tlm
from vio_tpu_torch.solver import marginalize as tmarg
from vio_tpu_torch.solver import window as tW

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)

NORMAL_FIELDS = ("Hpp", "bp", "Hpm", "Hmm", "bm", "chi2")


def _as_dict(nt):
    out = {}
    for k, v in zip(nt._fields, nt):
        out[k] = _as_dict(v) if hasattr(v, "_fields") else np.asarray(v)
    return out


@pytest.fixture(scope="module")
def problem():
    states, f, _ = testing.make_window_problem(
        window_size=10, max_features=64, imu_per_interval=8, dtype=jnp.float64)
    ts = convert.window_states_from_numpy(_as_dict(states), **CPU64)
    tf = convert.window_factors_from_numpy(_as_dict(f), **CPU64)
    return states, f, ts, tf


def _close(actual, desired, rtol, atol, name=""):
    actual = np.asarray(actual)
    desired = np.asarray(desired)
    assert actual.shape == desired.shape, name
    err = np.abs(actual - desired).max(initial=0.0)
    bound = atol + rtol * np.abs(desired).max(initial=0.0)
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


def _assert_normal(n_t, n_j):
    for name in NORMAL_FIELDS:
        _close(getattr(n_t, name).numpy(), getattr(n_j, name),
               rtol=1e-9, atol=1e-10, name=name)


@pytest.mark.parametrize("n_obs", [None, 512, 256], ids=["grid", "n_obs512", "overflow256"])
def test_assemble_matches_jax(problem, n_obs):
    """Both assembly paths; n_obs=256 is below the live count (640), so
    both packages keep the same prefix of live cells."""
    states, f, ts, tf = problem
    n_j = jW.assemble(states, f, fix_ext=True, loss_delta=1.0, n_obs=n_obs)
    n_t = tW.assemble(ts, tf, fix_ext=True, loss_delta=1.0, n_obs=n_obs)
    _assert_normal(n_t, n_j)


def test_compacted_assembly_matches_grid(problem):
    """The port's compaction is a pure re-layout of the grid's factors."""
    _, _, ts, tf = problem
    n0 = tW.assemble(ts, tf)
    n1 = tW.assemble(ts, tf, n_obs=768)
    for name in NORMAL_FIELDS:
        a = getattr(n0, name).numpy()
        b = getattr(n1, name).numpy()
        assert np.abs(a - b).max() / max(np.abs(a).max(), 1.0) < 1e-9, name


def test_live_index_keeps_prefix():
    flat = torch.tensor([0, 1, 1, 0, 1, 1, 0, 1], dtype=torch.bool)
    idx, cnt = tW.live_index(flat, 3)
    assert idx.tolist() == [1, 2, 4] and int(cnt) == 5
    idx, cnt = tW.live_index(flat, 7)
    assert idx.tolist() == [1, 2, 4, 5, 7, 0, 0] and int(cnt) == 5


def test_robust_chi2_and_reproj_errors_match_jax(problem):
    states, f, ts, tf = problem
    _close(float(tW.robust_chi2(ts, tf)), float(jW.robust_chi2(states, f)),
           rtol=1e-9, atol=1e-10, name="chi2")
    _close(tW.feature_reproj_errors(ts, tf).numpy(),
           jW.feature_reproj_errors(states, f), rtol=1e-9, atol=1e-12,
           name="feat_errs")


@pytest.mark.parametrize("n_obs", [None, 768], ids=["grid", "n_obs768"])
def test_solve_window_matches_jax(problem, n_obs):
    states, f, ts, tf = problem
    sj, bj, ej, stj = jlm.solve_window(states, f, max_iter=10, n_obs=n_obs)
    st, bt, et, stt = tlm.solve_window(ts, tf, max_iter=10, n_obs=n_obs)
    assert stt["iterations"] == int(stj["iterations"])
    for name in tW.WindowStates._fields:
        _close(getattr(st, name).numpy(), getattr(sj, name),
               rtol=1e-7, atol=1e-9, name=name)
    for key in ("chi2", "chi2_init", "lam"):
        _close(float(stt[key]), float(stj[key]), rtol=1e-7, atol=1e-9, name=key)
    _close(bt.numpy(), bj, rtol=1e-7, atol=1e-9, name="b_prior")
    _close(et.numpy(), ej, rtol=1e-7, atol=1e-9, name="err_prior")


def test_marginalize_host_chain_matches_jax(problem):
    """The host float64 prior chain, fed the same marg blocks."""
    states, f, _, _ = problem
    n = jW.assemble(states, f, fix_ext=False)
    Hpp = np.asarray(n.Hpp)
    bp = np.asarray(n.bp)
    for a, b in zip(tmarg.finalize_old_from_blocks(Hpp, bp),
                    jmarg.finalize_old_from_blocks(Hpp, bp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tmarg.marginalize_new_host(Hpp, bp),
                    jmarg.marginalize_new_host(Hpp, bp)):
        np.testing.assert_array_equal(a, b)


def test_convert_round_trip(problem):
    _, f, ts, tf = problem
    back = convert.to_numpy(tf)
    ref = _as_dict(f)
    for k, v in ref.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                np.testing.assert_array_equal(back[k][kk], vv)
        else:
            np.testing.assert_array_equal(back[k], v)
    assert tf.start.dtype == torch.int64 and tf.obs_mask.dtype == torch.bool
    cfg = jconfig.euroc_config()
    back = dataclasses.asdict(convert.config_from_dict(dataclasses.asdict(cfg)))
    assert {k: back[k] for k in dataclasses.asdict(cfg)} == dataclasses.asdict(cfg)
    # the port's own fields (loop closing) keep their defaults
    default = dataclasses.asdict(convert.VioConfig())
    assert all(back[k] == default[k] for k in set(back) - set(dataclasses.asdict(cfg)))
    with pytest.raises(KeyError):
        convert.window_states_from_numpy({"Ps": np.zeros((2, 3))}, **CPU64)
