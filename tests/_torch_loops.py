"""What the port's loop tests share, with no JAX (the ``gpu`` tests run on
a card without it): the guard that a captured function reads nothing back
to the host, an executor's constructor that keeps what it makes, and the
five loop programs of ``vio_tpu_torch`` (the frame step, the window LM,
global BA, Jacobi-PCG, the pose graph), each run on a given executor."""
import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from vio_tpu_torch import bench, runner, sim, testing
from vio_tpu_torch.device import move
from vio_tpu_torch.loop import posegraph
from vio_tpu_torch.parallel import global_ba
from vio_tpu_torch.solver import frame_step, lm, pcg


class _NoHostReads(TorchFunctionMode):
    """Refuses what a CUDA graph capture refuses: reading a tensor back to
    the host, and making a tensor from host data."""
    READS = {"item", "tolist", "numpy", "cpu", "__bool__", "__int__", "__float__",
             "__index__", "nonzero"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS or func in (torch.tensor, torch.as_tensor):
            raise AssertionError(f"host read or upload inside the graph: {name}")
        return func(*args, **(kwargs or {}))


def _guarded(fn):
    def run(*args):
        with _NoHostReads():
            return fn(*args)
    return run


class Made:
    """An executor's constructor (``graph.EagerLoop``, ``graph.loop_graph``)
    that keeps each executor it makes in ``made``; with ``guard`` the
    program's head, chunk and tail run under ``_NoHostReads``."""

    def __init__(self, loop, guard: bool = False):
        self.loop, self.guard, self.made = loop, guard, []

    def __call__(self, key, specs, head, chunk, tail, device, kept=None, k=None):
        if self.guard:
            head, chunk, tail = map(_guarded, (head, chunk, tail))
        g = self.loop(key, specs, head, chunk, tail, device, kept, k)
        self.made.append(g)
        return g


def record_frame(n_frames: int = 16):
    """``frame_step``'s arguments at the first keyframe step (the oldest
    frame marginalized) of the simulator's stream, recorded from the
    estimator on the CPU: (states and arrays, keywords)."""
    rec = []
    orig = frame_step.frame_step

    def recording(*args, **kw):
        rec.append((args, dict(kw)))
        return orig(*args, **kw)

    frame_step.frame_step = recording
    try:
        runner.run_sim(sim.generate(noise=False), n_frames=n_frames, device="cpu")
    finally:
        frame_step.frame_step = orig
    return next((a, k) for a, k in rec if k["marg_old"])


def run_frame(loop, device, dtype, frame):
    """The frame step's loop on ``loop``: its outputs, no stats."""
    args, kw = frame
    g = frame_step._loop(loop, args[0], args[1:], {**kw, "device": device, "dtype": dtype})
    return g.run(), None


def run_window(loop, device, dtype, frame):
    """The bench's perturbed window (256 feature slots) on ``loop``."""
    st, f, pert, n_obs, _ = bench.window_problem(256, device=device, dtype=dtype)
    new, b, e, st_ = lm.solve_with(loop, st._replace(Ps=st.Ps + pert), f, max_iter=10,
                                   n_obs=n_obs)
    return ([*new, b, e, st_["chi2"], st_["chi2_init"], st_["iterations"], st_["lam"]],
            (st_["attempts"], st_["reads"]))


def run_global_ba(loop, device, dtype, frame):
    """A 12-keyframe problem far enough off that attempts are rejected and
    the loop stops well before its cap of 60."""
    gt, _ = testing.make_global_problem(N=12, M=120, obs_per_lm=6, device="cpu",
                                        dtype=torch.float64)
    p = move(testing.perturb_global(gt, pose_sigma=0.2, rot_sigma=0.05), device, dtype)
    out, st = global_ba.solve_with(loop, p, 60, 2, 50.0)
    return ([out.Ps, out.Qs, out.inv_dep, st["chi2"], st["chi2_init"], st["iterations"],
             st["lam"]], (st["attempts"], st["reads"]))


def spd(P: int, cond: float, seed: int = 0):
    """A seeded SPD system (float64 numpy) with eigenvalues log-spaced over
    ``cond`` and an uneven diagonal."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((P, P)))
    D = np.diag(rng.uniform(0.5, 2.0, P))
    H = D @ (Q * np.logspace(0, np.log10(cond), P)) @ Q.T @ D
    return 0.5 * (H + H.T), rng.standard_normal(P)


def run_pcg(loop, device, dtype, frame):
    """P = 200 at κ 1e3·16: ended by the tolerance in float64 (1e-8), by
    the cap of 2P iterations where float32 cannot reach 1e-8."""
    H, b = (torch.as_tensor(a, dtype=dtype, device=device) for a in spd(200, 1e3))
    x, k = pcg.solve_with(loop, H, b, 0, 1e-8)
    return [x, k], None


def run_posegraph(loop, device, dtype, frame):
    """The drifting 40-pose circuit with its weighted loops."""
    _, _, args, w = testing.posegraph_circuit(40)
    arrays = posegraph.padded(*args, edge_weights=w)
    Ps, qs, st = posegraph._solve(loop, arrays, True, 40, device, dtype)
    return ([Ps, qs, st["chi2"], st["iterations"], st["log"].chi2, st["log"].lam],
            (st["attempts"], st["reads"]))


PROGRAMS = {"frame_step": run_frame, "window_lm": run_window, "global_ba": run_global_ba,
            "pcg": run_pcg, "posegraph": run_posegraph}


def leaves(tree) -> list:
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bit_equal(a, b) -> None:
    """Two pytrees of tensors, arrays or numbers, leaf by leaf, to the bit
    (NaN equal to NaN)."""
    a, b = leaves(list(a)), leaves(list(b))
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = _host(x), _host(y)
        assert x.shape == y.shape and x.dtype == y.dtype, i
        assert np.array_equal(x, y, equal_nan=True), f"leaf {i} differs"
