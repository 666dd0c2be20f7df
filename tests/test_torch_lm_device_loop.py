"""The λ-loop as device-state transitions (vio_tpu_torch/solver/lm.py
``_attempt``) and the frame's loop program (solver/frame_step.py), on the
CPU in float64.

The CPU runs eagerly the same functions the card captures and replays, so
these tests hold what a replay computes:
- the masked-attempt ``solve_window`` against ``vio_tpu.solver.lm``'s, on
  ``vio_tpu.testing.make_window_problem`` (the bench's perturbed problem
  too, and the same at twice its perturbation, where float64 rejects
  attempts), with the same iteration count and
  the states, λ, chi², b_prior and err_prior within
  tests/test_torch_window_lm.py's bounds (rtol 1e-7, atol 1e-9, relative
  to each array's largest entry).  On the bench's problem the final chi²
  (0.0095) is what is left of a start of 3.4e9, and it carries the
  round-off of that start: it is held within eps·chi2_init, as
  tests/test_torch_distributed.py holds its chi²; λ, a product of
  gain-ratio factors read from those chi² differences, within rtol 1e-6
  (found 1.6e-7); and the gyroscope biases, which the solve reads from
  rotations that agree to 8e-10, within atol 1e-8 rad/s (found 1.5e-9 at
  n_obs 768).  The port before the masked loop gave the same bits;
- bit-equality on the bench's problem in float32 (the card's type: 16
  attempts, 6 of them rejected): between chunk sizes, with attempts made
  after the loop has stopped, and between IMU buffers padded to the
  estimator's bucket and not;
- the graph key of ``frame_step.frame_key``.  That the programs read
  nothing back to the host is tests/test_torch_loop_executors.py's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vio_tpu import testing as jt
from vio_tpu.solver import lm as jlm
from vio_tpu_torch import bench, convert, estimator, runner, sim
from vio_tpu_torch.solver import frame_step as fs
from vio_tpu_torch.solver import lm as tlm

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
BENCH = dict(window_size=10, max_features=256, imu_per_interval=16)


def _as_dict(nt):
    return {k: _as_dict(v) if hasattr(v, "_fields") else np.asarray(v)
            for k, v in zip(nt._fields, nt)}


def _close(actual, desired, name, rtol=1e-7, atol=1e-9):
    actual, desired = np.asarray(actual), np.asarray(desired)
    assert actual.shape == desired.shape, name
    err = np.abs(actual - desired).max(initial=0.0)
    bound = atol + rtol * np.abs(desired).max(initial=0.0)
    assert err <= bound, f"{name}: max |diff| {err:.3e} > {bound:.3e}"


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert np.array_equal(x, y, equal_nan=True), f"leaf {i} differs"


@pytest.fixture(scope="module")
def problems():
    """For both packages: the bench's window (F=256) with its seed-0
    perturbation of Ps (σ 0.01 m), the same at σ 0.02 m, where float64
    rejects attempts too (6 iterations in 15 attempts, then ten rejects in
    a row stop it), and test_torch_window_lm.py's unperturbed F=64 window."""
    out = {}
    for name, kw, sigma in (("bench", BENCH, 0.01), ("rejects", BENCH, 0.02),
                            ("small", dict(window_size=10, max_features=64,
                                           imu_per_interval=8), 0.0)):
        sj, fj, _ = jt.make_window_problem(**kw, dtype=jnp.float64)
        if sigma:
            pert = np.random.default_rng(0).normal(0.0, sigma, sj.Ps.shape)
            sj = sj._replace(Ps=sj.Ps + pert)
        st = convert.window_states_from_numpy(_as_dict(sj), **CPU64)
        ft = convert.window_factors_from_numpy(_as_dict(fj), **CPU64)
        out[name] = (sj, fj, st, ft)
    return out


@pytest.mark.parametrize("name,n_obs", [(p, n) for p in ("bench", "rejects", "small")
                                        for n in (None, 768)])
def test_masked_solve_window_matches_jax(problems, name, n_obs):
    """768 is below the bench window's 840 live cells: both packages keep
    the same prefix of them."""
    sj, fj, st, ft = problems[name]
    out_j, b_j, e_j, s_j = jlm.solve_window(sj, fj, max_iter=10, n_obs=n_obs)
    out_t, b_t, e_t, s_t = tlm.solve_window(st, ft, max_iter=10, n_obs=n_obs)
    assert isinstance(s_t["iterations"], torch.Tensor) and s_t["iterations"].dim() == 0
    assert int(s_t["iterations"]) == int(s_j["iterations"])
    if name == "rejects":
        assert s_t["attempts"] > int(s_t["iterations"])
    for k in out_j._fields:
        atol = 1e-8 if (name, k) == ("bench", "Bgs") else 1e-9
        _close(getattr(out_t, k).numpy(), getattr(out_j, k), k, atol=atol)
    _close(b_t.numpy(), b_j, "b_prior")
    _close(e_t.numpy(), e_j, "err_prior")
    _close(s_t["chi2_init"].numpy(), s_j["chi2_init"], "chi2_init")
    if name == "bench":
        eps = float(torch.finfo(torch.float64).eps)
        _close(s_t["chi2"].numpy(), s_j["chi2"], "chi2", rtol=0.0,
               atol=eps * float(s_j["chi2_init"]))
        _close(s_t["lam"].numpy(), s_j["lam"], "lam", rtol=1e-6)
    else:
        for k in ("lam", "chi2"):
            _close(s_t[k].numpy(), s_j[k], k)


@pytest.fixture(scope="module")
def bench32():
    """The bench's problem in float32, as the card solves it: 10
    iterations in 16 attempts, 6 of them rejected."""
    st, f, pert, n_obs, _ = bench.window_problem(256, device="cpu", dtype=torch.float32)
    return st._replace(Ps=st.Ps + pert), f, n_obs


def test_bench_problem_rejects_attempts(bench32):
    """One host read per attempt at chunk 1."""
    st, ft, n_obs = bench32
    *_, stats = tlm.solve_window(st, ft, max_iter=10, n_obs=n_obs)
    assert int(stats["iterations"]) == 10
    assert stats["attempts"] == stats["reads"] == 16


@pytest.mark.parametrize("chunk", [2, 4, 7])
def test_chunk_sizes_give_the_same_bits(bench32, chunk):
    st, ft, n_obs = bench32
    ref = tlm.solve_window(st, ft, max_iter=10, n_obs=n_obs, chunk=1)
    got = tlm.solve_window(st, ft, max_iter=10, n_obs=n_obs, chunk=chunk)
    _bit_equal(got[:3], ref[:3])
    for k in ("chi2", "iterations", "lam", "chi2_init"):
        _bit_equal(got[3][k], ref[3][k])
    assert got[3]["attempts"] == chunk * got[3]["reads"] >= ref[3]["attempts"] == 16
    assert got[3]["reads"] == -(-16 // chunk)


def test_attempts_after_stop_change_no_bit(problems, bench32):
    """Past max_iter (float32 bench problem), and past ten rejects that
    set ``stop`` (the σ 0.02 problem)."""
    st, ft, n_obs = bench32
    _, _, st2, ft2 = problems["rejects"]
    for st, ft, n_obs, stopped in ((st, ft, n_obs, False), (st2, ft2, 768, True)):
        s, p, _ = tlm.start(st, ft, max_iter=10, n_obs=n_obs)
        while bool(tlm.live(s, 10)):
            s = tlm.attempts(s, p, 1)
        assert bool(s.stop) == stopped
        _bit_equal(tlm.attempts(s, p, 3), s)


@pytest.fixture(scope="module")
def frames():
    """Frame-step arguments of the first post-init frames of the
    simulator's stream, recorded from the estimator on the CPU."""
    rec = []
    orig = fs.frame_step

    def recording(*args, **kw):
        rec.append((args, dict(kw)))
        return orig(*args, **kw)

    fs.frame_step = recording
    try:
        runner.run_sim(sim.generate(noise=False), n_frames=20, device="cpu")
    finally:
        fs.frame_step = orig
    assert len(rec) >= 6
    return rec[:6]


def _fetch(args, kw, **extra):
    return fs.fetch(fs.frame_step(*args, **{**kw, **extra}))


def test_imu_bucket_padding_changes_no_bit(frames):
    """The estimator pads IMU buffers to its capacity bucket; the masked
    steps past a buffer's end are exact no-ops: the buffers cut to the
    longest one, as packed, and padded by 32 more give the same bits."""
    for args, kw in frames[:3]:
        dts, accs, gyrs, mask = args[1:5]
        M = dts.shape[1]
        longest = int(mask.sum(axis=1).max())
        assert M % estimator.IMU_BUCKET == 0 and longest <= M < longest + estimator.IMU_BUCKET

        def pad(a, n):
            width = [(0, 0), (0, n)] + [(0, 0)] * (a.ndim - 2)
            return np.pad(a, width)

        trimmed = (args[0], dts[:, :longest], accs[:, :longest], gyrs[:, :longest],
                   mask[:, :longest], *args[5:])
        padded = (args[0], *(pad(a, 32) for a in (dts, accs, gyrs, mask)), *args[5:])
        ref = _fetch(args, kw)
        _bit_equal(_fetch(trimmed, kw), ref)
        _bit_equal(_fetch(padded, kw), ref)


def test_frame_key_holds_what_jit_holds_static(frames):
    keys = [fs.frame_key(*a[:2], **k) for a, k in frames]
    i, j = next((i, j) for i in range(len(keys)) for j in range(i + 1, len(keys))
                if frames[i][0][1].shape == frames[j][0][1].shape
                and frames[i][1] == frames[j][1])
    (a0, k0), key0, key1 = frames[i], keys[i], keys[j]
    assert key0 == key1 and hash(key0) == hash(key1)
    assert (key0.W1, key0.F, key0.M) == (11, 256, a0[1].shape[1])
    assert key0.device == torch.device("cpu") and key0.dtype == torch.float64
    for change in (dict(max_iter=9), dict(fix_ext=not k0["fix_ext"]),
                   dict(loss_delta=2.0), dict(n_obs=(k0["n_obs"] or 0) + 512),
                   dict(marg_old=not k0["marg_old"]),
                   dict(exact_noise=not k0["exact_noise"]), dict(dtype=torch.float32)):
        assert fs.frame_key(*a0[:2], **{**k0, **change}) != key0, change
    wider = np.zeros(a0[1].shape[:1] + (a0[1].shape[1] + estimator.IMU_BUCKET,))
    assert fs.frame_key(a0[0], wider, **k0) != key0
