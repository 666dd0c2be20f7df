"""Global BA's and Jacobi-PCG's loops as the CUDA graphs hold them
(vio_tpu_torch/parallel/global_ba.py ``graph_fns``/``solve_graphed``,
vio_tpu_torch/solver/pcg.py ``graph_fns``/``pcg_solve_graphed``), run
eagerly on the CPU with the host read of the loop's condition between
them, as a replay has.

Held: the graph functions make no host read; they equal the eager loop
(``global_ba.solve``, ``pcg.pcg_solve_eager``) to the bit, and the JAX
package's jitted ``solve`` and ``pcg_solve`` to its own tolerances (the
same iterations; poses within 1e-8 m and chi²₀ within 1e-12 relative, as
tests/test_torch_global_ba.py holds the eager solve; x within 1e-9 of
its largest entry); an attempt or CG iteration made after the loop has
ended changes no bit, so no chunk size changes the result; the graphed
and the eager route return one stats schema; the keys hold what
``jax.jit`` holds static; the graph cache keeps its pools to its budget.
The ``gpu`` tests run each graphed route against its eager twin on the
card and skip here."""
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from vio_tpu import testing as jt
from vio_tpu.parallel import global_ba as jg
from vio_tpu.solver import pcg as jpcg
from vio_tpu_torch import convert
from vio_tpu_torch import testing as tt
from vio_tpu_torch.device import move
from vio_tpu_torch.parallel import global_ba as tg
from vio_tpu_torch.solver import graph, pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)
# a start far enough off that attempts are rejected in both types, and the
# loop stops (Δχ² or λ) well before MAX_ITER
FAR = dict(pose_sigma=0.2, rot_sigma=0.05)
MAX_ITER = 60


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


class _EagerLoop:
    """``graph.LoopGraph``'s interface with no capture, for CPU tensors:
    the head, chunk and tail run eagerly under ``_NoHostReads``, with a
    host read of the condition after the head and after each chunk, as the
    replays have; the kept tensors are copied into ``keep`` and the tail's
    outputs come back as float64 host arrays."""

    def __init__(self, key, specs, head, chunk, tail, device, kept=None, k=None):
        self.fns, self.kept_fn = (head, chunk, tail), kept
        self.chunk = graph.CHUNK if k is None else k
        self.inputs = self
        self.views = [torch.empty(shape, dtype=dt, device=device) for shape, dt in specs]
        self.attempts = self.reads = 0
        self.carry = None

    def load(self, tensors, start: int = 0) -> None:
        for v, t in zip(self.views[start:], tensors):
            v.copy_(t)

    def upload(self, arrays) -> None:
        for v, a in zip(self.views, arrays):
            v.copy_(torch.as_tensor(np.asarray(a)))

    def run(self, keep=()):
        head, step, tail = self.fns
        self.attempts, self.reads = self.chunk, 1
        with _NoHostReads():
            s, aux, live = head(self.views, self.chunk)
        while bool(live):
            self.attempts += self.chunk
            self.reads += 1
            with _NoHostReads():
                s, live = step(s, aux, self.chunk)
        with _NoHostReads():
            out = tail(s, aux)
        self.carry = s
        for dst, src in zip(keep, self.kept_fn(s, aux) if self.kept_fn else []):
            dst.copy_(src)
        return [t.to(torch.float64).numpy() for t in out]


@pytest.fixture
def eager_graphs(monkeypatch):
    """Route the graphed entry points through ``_EagerLoop`` on the CPU:
    the graph functions, the key's inputs and the returned results as
    ``solve_graphed`` and ``pcg_solve_graphed`` build them."""
    monkeypatch.setattr(graph, "loop_graph", _EagerLoop)
    monkeypatch.setattr(graph, "require_cuda", lambda device, what: None)
    return monkeypatch


def _bit_equal(a, b):
    """Two pytrees of tensors (or numbers), leaf by leaf, to the bit."""
    a, b = graph._leaves(list(a)), graph._leaves(list(b))
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x, y), f"leaf {i} differs"


def _both(N, M, obs, **perturb):
    """One perturbed problem in both packages: (gt_t, noisy_t, noisy_j)."""
    gt_j, _ = jt.make_global_problem(N=N, M=M, obs_per_lm=obs)
    noisy_j = jt.perturb_global(gt_j, **perturb)
    gt_t, _ = tt.make_global_problem(N=N, M=M, obs_per_lm=obs, **CPU64)
    noisy_t = convert.global_ba_from_numpy(
        {k: np.asarray(v) for k, v in zip(noisy_j._fields, noisy_j)}, **CPU64)
    return gt_t, noisy_t, noisy_j


def _result(out, st):
    """A solve's result and stats as one list of leaves."""
    return [out.Ps, out.Qs, out.inv_dep, st["chi2"], st["chi2_init"],
            torch.tensor(st["iterations"]), st["lam"]]


def _far(dtype):
    gt, _ = tt.make_global_problem(N=12, M=120, obs_per_lm=6, **CPU64)
    return move(tt.perturb_global(gt, **FAR), "cpu", dtype)


@pytest.mark.parametrize("fix_frames,loss_delta", [(2, 1.0), (1, 50.0)])
def test_graph_functions_are_the_eager_solve_and_match_jax(eager_graphs, fix_frames,
                                                           loss_delta):
    _, pt, pj = _both(12, 120, 6)
    got = _result(*tg.solve_graphed(pt, 25, fix_frames, loss_delta))
    out, st = tg.solve(pt, max_iter=25, fix_frames=fix_frames, loss_delta=loss_delta, **CPU64)
    _bit_equal(got, _result(out, st))
    oj, sj = jg.solve(pj, max_iter=25, fix_frames=fix_frames, loss_delta=loss_delta)
    assert int(got[5]) == int(sj["iterations"]) > 1
    assert np.abs(got[0].numpy() - np.asarray(oj.Ps)).max() <= 1e-8
    assert np.abs(got[1].numpy() - np.asarray(oj.Qs)).max() <= 1e-8
    c0, c0j = float(got[4]), float(sj["chi2_init"])
    assert abs(c0 - c0j) <= 1e-12 * abs(c0j)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_attempts_after_the_end_change_no_bit(dtype):
    """Run to the loop's end, then attempt again: after the stop flag and
    after the iteration cap, nothing moves.  The run had rejected
    attempts, so both arms of the select are exercised."""
    s, q, _ = tg.start(_far(dtype), MAX_ITER, 2, 50.0)
    rejected = 0
    while bool(tg.live(s, MAX_ITER)):
        ni = s.ni
        s = tg._attempt(s, q)
        rejected += int(bool(s.ni > ni))
    assert rejected > 0 and bool(s.stop) and int(s.it) < MAX_ITER
    _bit_equal(tg.attempts(s, q, 3), s)
    capped, q_cap, _ = tg.start(_far(dtype), 4, 2, 50.0)
    capped = tg.attempts(capped, q_cap, 4)
    assert not bool(capped.stop) and int(capped.it) == 4
    _bit_equal(tg.attempts(capped, q_cap, 2), capped)


@pytest.mark.parametrize("chunk", [2, 5])
def test_chunk_size_changes_no_bit(eager_graphs, chunk):
    """The graphs' solve at ``graph.CHUNK`` = chunk against 1 and against
    the eager loop (one read an attempt): the same bits; the chunk's
    attempts past the end are made and counted, the reads are one a
    chunk."""
    p = _far(torch.float64)
    ref, st_ref = tg.solve_eager(p, max_iter=MAX_ITER, fix_frames=2, loss_delta=50.0, **CPU64)
    assert st_ref["attempts"] == st_ref["reads"] == st_ref["iterations"] < MAX_ITER
    for k in (1, chunk):
        eager_graphs.setattr(graph, "CHUNK", k)
        out, st = tg.solve_graphed(p, MAX_ITER, 2, 50.0)
        _bit_equal(_result(out, st), _result(ref, st_ref))
        assert st["attempts"] == k * st["reads"] == k * -(-st["iterations"] // k)


def test_both_routes_return_one_stats_schema(eager_graphs):
    """``solve_graphed`` (through ``_EagerLoop``) and the eager loop return
    the same keys with values of the same types: tensors of the problem's
    dtype and device, or ints."""
    p = _far(torch.float32)
    _, st_g = tg.solve_graphed(p, 10, 2, 50.0)
    _, st_e = tg.solve_eager(p, max_iter=10, fix_frames=2, loss_delta=50.0, device="cpu",
                             dtype=torch.float32)
    assert st_g.keys() == st_e.keys() >= {"chi2", "chi2_init", "iterations", "lam",
                                          "attempts", "reads", "allreduces",
                                          "allreduce_bytes"}
    for k in st_e:
        g, e = st_g[k], st_e[k]
        assert type(g) is type(e), k
        if isinstance(e, torch.Tensor):
            assert (g.dtype, g.shape, g.device) == (e.dtype, e.shape, e.device), k
    assert st_g["allreduces"] == st_g["allreduce_bytes"] == 0 == st_e["allreduces"]


def test_keys_hold_what_jit_holds_static():
    p = _far(torch.float64)
    key = tg.graph_key(p, 10, 2, 50.0)
    assert key == tg.graph_key(p, 10, 2, 50) and hash(key) == hash(
        tg.graph_key(p._replace(Ps=p.Ps.clone()), 10, 2, 50.0))
    wider, _ = tt.make_global_problem(N=12, M=240, obs_per_lm=6, **CPU64)
    for other in (tg.graph_key(p, 11, 2, 50.0), tg.graph_key(p, 10, 1, 50.0),
                  tg.graph_key(p, 10, 2, 1.0), tg.graph_key(wider, 10, 2, 50.0),
                  tg.graph_key(move(p, "cpu", torch.float32), 10, 2, 50.0),
                  tg.graph_key(move(p, "meta", torch.float64), 10, 2, 50.0)):
        assert other != key
    H, b, _ = _spd(60, 1e3)
    k = pcg.graph_key(H, b, 0)
    assert k == pcg.graph_key(H.clone(), b.clone(), 0)
    for other in (pcg.graph_key(H, b, 5), pcg.graph_key(H.float(), b.float(), 0),
                  pcg.graph_key(H.to("meta"), b.to("meta"), 0),
                  pcg.graph_key(*_spd(61, 1e3)[:2], 0)):
        assert other != k
    # the graphed routes refuse the CPU rather than run eagerly there
    with pytest.raises(ValueError, match="CUDA"):
        tg.solve_graphed(p, 10, 2, 50.0)
    with pytest.raises(ValueError, match="CUDA"):
        pcg.pcg_solve_graphed(H, b)


class _Held:
    def __init__(self, pool_bytes):
        self.pool_bytes = pool_bytes


def test_graph_cache_keeps_its_pools_to_the_budget(monkeypatch):
    """Past ``POOL_BUDGET`` the least recently used keys go, never the one
    just captured; a use makes a key the most recently used."""
    monkeypatch.setattr(graph, "_CACHE", {})
    monkeypatch.setattr(graph, "STATS", graph.Counter())
    monkeypatch.setattr(graph, "POOL_BUDGET", 100)
    held = {name: graph._cached(name, lambda: _Held(30)) for name in "abc"}
    graph._evict(held["c"])
    assert graph.cached_keys() == ["a", "b", "c"]
    graph._cached("a", lambda: None)                 # a use: "b" is now the oldest
    d = graph._cached("d", lambda: _Held(30))
    graph._evict(d)
    assert graph.cached_keys() == ["c", "a", "d"] and graph.STATS["evicted"] == 1
    big = graph._cached("big", lambda: _Held(500))  # alone above the budget: kept
    graph._evict(big)
    assert graph.cached_keys() == ["big"] and graph.STATS["keys"] == 1
    assert graph.STATS["evicted"] == 4


def _spd(P, cond, seed=0):
    """A seeded SPD system with eigenvalues log-spaced over ``cond`` and an
    uneven diagonal (so the Jacobi preconditioner does something):
    H, b as float64 tensors and as numpy."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((P, P)))
    D = np.diag(rng.uniform(0.5, 2.0, P))
    H = D @ (Q * np.logspace(0, np.log10(cond), P)) @ Q.T @ D
    H = 0.5 * (H + H.T)
    b = rng.standard_normal(P)
    return torch.as_tensor(H), torch.as_tensor(b), (H, b)


def _pcg_graph(H, b, max_iter, rtol, chunk):
    """The graphs' PCG at ``chunk`` iterations a read, run eagerly: (the
    carry, x as returned, the iterations)."""
    g = _EagerLoop(None, pcg.graph_key(H, b, max_iter)[2], *pcg.graph_fns(max_iter), "cpu",
                   kept=lambda c, sy: [c.x], k=chunk)
    g.upload([rtol])
    g.load([H, b], start=1)
    x = torch.empty_like(b)
    (k,) = g.run(keep=[x])
    return g.carry, x, int(k)


@pytest.mark.parametrize("P", [60, 200])
@pytest.mark.parametrize("end,max_iter", [("tolerance", 0), ("cap", 7)])
def test_pcg_graph_functions_match_jax(eager_graphs, P, end, max_iter):
    """κ(H) ≤ 1e2·16 (the diagonal's spread): the loop ends at the
    tolerance after 61 and 86 iterations, in both packages.  At 1e3·16 CG
    in float64 runs well past P iterations, where its count follows
    round-off in either package (P = 60: 113 here, 117 in vio_tpu, x 6e-9
    apart)."""
    H, b, (Hn, bn) = _spd(P, 1e2)
    rtol = 1e-8
    x, k = pcg.pcg_solve_graphed(H, b, max_iter, rtol)
    c, _, _ = _pcg_graph(H, b, max_iter, rtol, pcg.CHUNK)
    _bit_equal([x, c.k], [c.x, torch.tensor(k)])
    xj, kj = jpcg.pcg_solve(Hn, bn, max_iter=max_iter, rtol=rtol)
    assert k == int(kj)
    if end == "cap":
        assert k == max_iter
    else:
        assert k < 2 * P and float(torch.linalg.norm(c.r)) <= rtol * float(torch.linalg.norm(b))
    xj = np.asarray(xj)
    assert np.abs(x.numpy() - xj).max() <= 1e-9 * np.abs(xj).max()
    x_eager, k_eager = pcg.pcg_solve_eager(H, b, max_iter, rtol)
    assert k_eager == k
    _bit_equal([x_eager], [x])
    x_route, k_route = pcg.pcg_solve(H, b, max_iter, rtol)    # the CPU's route
    assert k_route == k
    _bit_equal([x_route], [x])


def test_pcg_after_the_end_and_chunks_change_no_bit():
    H, b, _ = _spd(200, 1e3)
    c, sy = pcg.start(H, b, 1e-8)
    while bool(pcg.live(c, sy)):
        c = pcg._iteration(c, sy)
    assert 0 < int(c.k) < sy.iters
    _bit_equal(pcg.iterations(c, sy, 3), c)
    ref, _, k = _pcg_graph(H, b, 0, 1e-8, 1)
    _bit_equal(ref, c)
    for chunk in (8, 32, 128):
        got, x, kc = _pcg_graph(H, b, 0, 1e-8, chunk)
        assert kc == k
        _bit_equal(got, ref)
        _bit_equal([x], [ref.x])
    x, kc = pcg.pcg_solve_eager(H, b, 0, 1e-8)
    assert kc == k
    _bit_equal([x], [ref.x])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_graphed_global_ba_against_its_eager_twin_on_the_card():
    """float64, the bench's 100-keyframe problem: the graphs' solve and the
    eager loop on the card take the same attempts and end within 1e-9 m;
    the result lives on the card, the graphs read the condition once per
    chunk, and both return one stats schema."""
    _card()
    gt, _ = tt.make_global_problem(N=100, M=400, obs_per_lm=8, dtype=torch.float64)
    noisy = tt.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)
    kw = dict(max_iter=25, fix_frames=2, loss_delta=50.0, dtype=torch.float64)
    before = dict(graph.STATS)
    out, st = tg.solve(noisy, **kw)
    ref, st_ref = tg.solve_eager(noisy, **kw)
    assert out.Ps.is_cuda and st["iterations"] == st_ref["iterations"]
    assert st.keys() == st_ref.keys() and st["chi2"].is_cuda
    assert graph.STATS["global_ba_graphed"] - before.get("global_ba_graphed", 0) == 1
    assert st["reads"] == -(-st["iterations"] // graph.CHUNK)
    assert float((out.Ps - ref.Ps).abs().max()) <= 1e-9
    assert float(torch.linalg.norm(out.Ps - gt.Ps, dim=1).max()) < 1e-4


@pytest.mark.gpu
def test_graphed_pcg_against_its_eager_twin_on_the_card():
    _card()
    for P, dtype, rtol in ((600, torch.float64, 1e-8), (1200, torch.float32, 1e-3)):
        H, b, _ = _spd(P, 1e3)
        H, b = H.to("cuda", dtype), b.to("cuda", dtype)
        x, k = pcg.pcg_solve(H, b, rtol=rtol)
        x_ref, k_ref = pcg.pcg_solve_eager(H, b, rtol=rtol)
        assert x.is_cuda and k == k_ref
        for v in (x, x_ref):
            res = torch.linalg.norm(H.double() @ v.double() - b.double())
            assert float(res) <= rtol * float(torch.linalg.norm(b.double()))
