"""The IMU factors' block of the window's normal equations:
``window.imu_factor`` sends CUDA tensors to the hand-written kernel
(``window.imu_factor_kernel``, ``csrc/imu_factor.cu``) and CPU tensors to
its plain version (``window.imu_factor_reference``).

On the CPU: the route is the plain version bit for bit with the kernel's
counters at 0, the wrapper refuses what it cannot launch before any
build, and ``assemble`` gives the bits of the function as it was before
the kernel (its IMU block frozen below).  The ``gpu`` tests hold the
kernel to the plain version on the card, a captured graph's replay to the
eager launch, and a whole graphed frame step to the same frame with the
plain IMU block.  The file imports neither JAX nor ``vio_tpu``, so it runs
as it is on a machine with a card.
"""
from __future__ import annotations

import pytest
import torch

from vio_tpu_torch import runner, sim, testing
from vio_tpu_torch.config import sim_config
from vio_tpu_torch.solver import frame_step as fs
from vio_tpu_torch.solver import graph
from vio_tpu_torch.solver import window as W

VALID = ("all", "first", "scattered")


def _problem(W_: int, dtype, valid: str, seed: int, device="cpu"):
    """A W_-interval window on the simulator's trajectory with biases off
    their linearisation points, ``imu_valid`` all true, first-only (the
    marginalization's) or scattered, Ω as the solve inverts it, and Hpp,
    bp, chi as the reprojection factors could leave them."""
    st, f, _ = testing.make_window_problem(window_size=W_, max_features=16, device=device,
                                           dtype=dtype, seed=seed, perturb=0.05)
    g = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=g, dtype=torch.float64)).to(
            device=device, dtype=dtype)

    st = st._replace(Bas=randn(W_ + 1, 3, scale=0.02), Bgs=randn(W_ + 1, 3, scale=0.002))
    if valid == "first":
        mask = torch.arange(W_) == 0
    elif valid == "scattered":
        mask = torch.rand(W_, generator=g) < 0.5
        mask[W_ // 2] = True
    else:
        mask = torch.ones(W_, dtype=torch.bool)
    f = f._replace(imu_valid=mask.to(device))
    P = W.num_pose_params(W_)
    A = randn(P, P)
    return st, f, W._imu_infos(f), A @ A.T, randn(P), randn(scale=3.0).abs()


@pytest.mark.parametrize("valid", VALID)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_cpu_route_is_the_plain_version(dtype, valid):
    """CPU tensors go to the plain version, bit for bit, and the kernel's
    counters stay at 0."""
    W.imu_factor_kernel.launches = W.imu_factor_kernel.captured = 0
    st, f, infos, H, b, chi = _problem(4, dtype, valid, seed=1)
    out = W.imu_factor(st, f, infos, H, b, chi)
    ref = W.imu_factor_reference(st, f, infos, H, b, chi)
    for a, r in zip(out, ref):
        assert torch.equal(a, r)
    assert W.imu_factor_kernel.launches == W.imu_factor_kernel.captured == 0


def _kernel_args(st, f, infos, H, b, chi):
    return [f.imu_terms, f.g, st.Ps, st.Qs, st.Vs, st.Bas, st.Bgs, f.imu_valid,
            infos.contiguous(), H, b, chi]


def _breaks():
    """What the wrapper refuses, each by the check that names it."""
    def dtype_mixed(a):
        a[2] = a[2].float()
        return a

    def half(a):
        a[1:7] = [t.half() for t in a[1:7]]
        a[0] = type(a[0])(*(t.half() for t in a[0]))
        a[8:] = [t.half() for t in a[8:]]
        return a

    def mask_float(a):
        a[7] = a[7].double()
        return a

    def no_interval(a):
        t = a[0]
        a[0] = type(t)(*(x[:0] for x in t))
        a[2:7] = [x[:1] for x in a[2:7]]
        a[7], a[8] = a[7][:0], a[8][:0]
        a[9], a[10] = a[9][:21, :21], a[10][:21]
        return a

    def wrong_P(a):
        a[9] = a[9][:-1, :-1]
        return a

    def wrong_quat(a):
        a[3] = a[3][:, :3]
        return a

    def strided(a):
        a[9] = a[9].T
        return a

    def on_cpu(a):
        return a

    return [("float32 or float64", dtype_mixed), ("float32 or float64", half),
            ("bool", mask_float), ("shapes", no_interval), ("shapes", wrong_P), ("shapes", wrong_quat),
            ("contiguous", strided), ("CUDA", on_cpu)]


@pytest.mark.parametrize("match,brk", _breaks(),
                         ids=["mixed-dtypes", "float16", "float-mask", "W0", "wrong-P",
                              "quaternion-shape", "non-contiguous", "cpu-tensors"])
def test_kernel_wrapper_refuses_what_it_cannot_launch(match, brk):
    """Types, shapes and layout are checked before the device and before
    any build; CPU tensors that pass them are refused as not CUDA."""
    st, f, infos, H, b, chi = _problem(3, torch.float64, "all", seed=2)
    n = W.imu_factor_kernel.launches
    with pytest.raises(ValueError, match=match):
        W.imu_factor_kernel(*brk(_kernel_args(st, f, infos, H, b, chi)))
    assert W.imu_factor_kernel.launches == n


def _parent_imu_block(states, f, infos, Hpp, bp, chi):
    """``window.assemble``'s IMU block as it stood before the kernel, line
    for line (its ``eyeW`` and ``kw`` as ``assemble`` made them)."""
    W1 = states.Ps.shape[0]
    dtype = states.Ps.dtype
    kw = dict(dtype=dtype, device=states.Ps.device)
    eyeW = torch.eye(W1, **kw)

    imu_args = W._imu_args(states, f)
    ir = W.factors.imu_residual(*imu_args)
    Jpi_m, Jsbi_m, Jpj_m, Jsbj_m = W.factors.imu_jacobians(*imu_args)

    W_ = W1 - 1
    imu_m = f.imu_valid.to(dtype)
    Ji = torch.cat([Jpi_m, Jsbi_m], dim=-1)                         # (W, 15, 15)
    Jj = torch.cat([Jpj_m, Jsbj_m], dim=-1)
    Jfr = (torch.einsum("wab,wk->wakb", Ji, eyeW[:W_]) +
           torch.einsum("wab,wk->wakb", Jj, eyeW[1:])).reshape(W_, 15, W1 * 15)
    Jimu = torch.cat([torch.zeros((W_, 15, 6), **kw), Jfr], dim=-1)
    Jimu = Jimu * imu_m[:, None, None]

    WJi = torch.einsum("wrs,wsp->wrp", infos, Jimu)
    Hpp = Hpp + torch.einsum("wrp,wrq->pq", Jimu, WJi)
    info_ir = torch.einsum("wrs,ws->wr", infos, ir) * imu_m[:, None]
    bp = bp - torch.einsum("wrp,wr->p", Jimu, info_ir)
    imu_chi = torch.einsum("wr,wr->w", ir, info_ir)
    chi = chi + torch.sum(torch.where(f.imu_valid, imu_chi, torch.zeros_like(imu_chi)))
    return Hpp, bp, chi


@pytest.mark.parametrize("n_obs", [None, 96], ids=["grid", "compacted"])
@pytest.mark.parametrize("valid", ["all", "first"])
def test_assemble_on_cpu_is_the_parent_function(monkeypatch, n_obs, valid):
    """``assemble`` on the CPU gives, bit for bit, what it gave with the
    IMU block inline, with Ω given (the LM's) and computed (the
    marginalization's)."""
    st, f, infos, *_ = _problem(10, torch.float64, valid, seed=3)
    outs = []
    for block in (None, _parent_imu_block):
        if block is not None:
            monkeypatch.setattr(W, "imu_factor", block)
        outs.append([W.assemble(st, f, fix_ext=False, n_obs=n_obs, imu_infos=infos),
                     W.assemble(st, f, fix_ext=True, n_obs=n_obs)])
    for now, then in zip(*outs):
        for name, a, b in zip(W.Normal._fields, now, then):
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

# The kernel against the plain version, each output to a share of its
# largest entry.  float64: both sum the same products in other orders and
# the kernel's FMAs round once, so the outputs differ by a few ulp of the
# largest products (an entry is a sum of 15-30 products of sums of 15);
# 1e-12 leaves ~10³ of room over the ~1e-16 of a host emulation of the
# source.  float32: the same in float32 (eps 6e-8), and bp and chi come
# from residuals that cancel, so 1e-5 (~100 eps).
CARD_RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# A graphed frame step with the kernel against one with the plain block:
# the same LM iterations, and each state leaf, over the frames, no further
# from the plain block's than FRAME_ROUND_OFF times the distance between
# the plain block's run on the CPU and on the card, both float64: the
# frames stop at the iteration cap, where round-off of the normal
# equations moves the states by ~1e-8-1e-6 (m, rad).  On an H100 the
# kernel's distance is 0.2-1.4 times the CPU's (two sim seeds, 20 frames).
FRAME_ROUND_OFF, FRAME_ATOL = 4.0, 1e-15
W_CASES = (1, 2, 4, 10)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("valid", VALID)
@pytest.mark.parametrize("W_", W_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_kernel_matches_plain_on_card(dtype, W_, valid):
    _need_card()
    st, f, infos, H, b, chi = _problem(W_, dtype, valid, seed=10 + W_, device="cuda")
    ref = W.imu_factor_reference(st, f, infos, H, b, chi)
    n = W.imu_factor_kernel.launches
    out = W.imu_factor(st, f, infos, H.clone(), b.clone(), chi.clone())
    torch.cuda.synchronize()
    assert W.imu_factor_kernel.launches == n + 1
    for name, a, r in zip(("Hpp", "bp", "chi"), out, ref):
        d = float((a - r).abs().max())
        bound = CARD_RTOL[dtype] * float(r.abs().max())
        assert d <= bound, f"{name}: {d:.3e} > {bound:.3e}"


@pytest.mark.gpu
def test_kernel_graph_replay_is_the_eager_launch():
    """A capture records one launch (``captured``, not ``launches``), and
    its replay gives the eager launch's bits."""
    _need_card()
    st, f, infos, H, b, chi = _problem(10, torch.float64, "scattered", seed=5, device="cuda")
    eager = [t.clone() for t in (H, b, chi)]
    W.imu_factor(st, f, infos, *eager)
    launches, captured = W.imu_factor_kernel.launches, W.imu_factor_kernel.captured
    out = [t.clone() for t in (H, b, chi)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=side):
        W.imu_factor(st, f, infos, *out)
    assert W.imu_factor_kernel.captured == captured + 1
    assert W.imu_factor_kernel.launches == launches
    g.replay()
    torch.cuda.synchronize()
    for a, e in zip(out, eager):
        assert torch.equal(a, e)


def _plain_everywhere(states, f, infos, Hpp, bp, chi):
    return W.imu_factor_reference(states, f, infos, Hpp, bp, chi)


@pytest.mark.gpu
def test_graphed_frame_step_matches_the_plain_block(monkeypatch):
    """Frames of the benchmark cell's configuration (W = 10, F = 256,
    float64, the noisy simulator), recorded on the CPU, through
    ``frame_step_graphed`` on the card with the kernel and again with the
    plain IMU block: the same iterations, and float64 round-off apart."""
    _need_card()
    rec = []
    orig = fs.frame_step

    def recording(*args, **kw):
        out = orig(*args, **kw)
        rec.append((args, dict(kw), fs.fetch(out)))
        return out

    monkeypatch.setattr(fs, "frame_step", recording)
    runner.run_sim(sim.generate(noise=True, seed=4), sim_config(), n_frames=32, device="cpu")
    monkeypatch.setattr(fs, "frame_step", orig)
    frames = rec[-8:]
    assert len(frames) == 8
    card = dict(device=torch.device("cuda"), dtype=torch.float64)

    def run_all():
        graph.clear()
        return [fs.frame_step_graphed(*a, **{**kw, **card}) for a, kw, _ in frames]

    n = W.imu_factor_kernel.launches
    kernel = run_all()
    assert W.imu_factor_kernel.launches > n
    monkeypatch.setattr(W, "imu_factor", _plain_everywhere)
    n = W.imu_factor_kernel.launches
    plain = run_all()
    assert W.imu_factor_kernel.launches == n
    graph.clear()
    for name in W.WindowStates._fields:
        d_kernel = d_cpu = 0.0
        for (_, _, cpu), k, p in zip(frames, kernel, plain):
            assert k.iterations == p.iterations == int(cpu.iterations)
            a, b, c = (getattr(o.states, name) for o in (k, p, cpu))
            d_kernel = max(d_kernel, float(abs(a - b).max()))
            d_cpu = max(d_cpu, float(abs(c - b).max()))
        bound = FRAME_ATOL + FRAME_ROUND_OFF * d_cpu
        assert d_kernel <= bound, f"{name}: {d_kernel:.3e} > {bound:.3e}"
