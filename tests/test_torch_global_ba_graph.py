"""Global BA's and Jacobi-PCG's loop programs (vio_tpu_torch/parallel/
global_ba.py and vio_tpu_torch/solver/pcg.py ``graph_fns``), which the
card captures and replays, run by the CPU's executor, the eager loop
(``graph.EagerLoop``), with the host read of the loop's condition between
head, chunks and tail, as a replay has.

Held: PCG's program against the JAX package's jitted ``pcg_solve`` to
its own tolerances (the same iterations; x within 1e-9 of its largest
entry); an attempt or CG iteration made after the loop has ended changes
no bit, so no chunk size changes the result; the keys hold what
``jax.jit`` holds static, and a ``LoopGraph`` refuses the CPU; the graph
cache keeps its pools to its budget.  tests/test_torch_loop_executors.py
holds each program's captured graphs to the eager loop on the card."""
import numpy as np
import pytest
import torch

from vio_tpu.solver import pcg as jpcg
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


def _bit_equal(a, b):
    """Two pytrees of tensors (or numbers), leaf by leaf, to the bit."""
    a, b = graph._leaves(list(a)), graph._leaves(list(b))
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and x.shape == y.shape, i
        assert torch.equal(x, y), f"leaf {i} differs"


def _result(out, st):
    """A solve's result and stats as one list of leaves."""
    return [out.Ps, out.Qs, out.inv_dep, st["chi2"], st["chi2_init"],
            torch.tensor(st["iterations"]), st["lam"]]


def _far(dtype):
    gt, _ = tt.make_global_problem(N=12, M=120, obs_per_lm=6, **CPU64)
    return move(tt.perturb_global(gt, **FAR), "cpu", dtype)


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
def test_chunk_size_changes_no_bit(monkeypatch, chunk):
    """``solve`` at ``graph.CHUNK`` = chunk against 1 (one read an
    attempt): the same bits; the chunk's attempts past the end are made
    and counted, the reads are one a chunk."""
    p = _far(torch.float64)
    ref, st_ref = tg.solve(p, max_iter=MAX_ITER, fix_frames=2, loss_delta=50.0, **CPU64)
    assert st_ref["attempts"] == st_ref["reads"] == st_ref["iterations"] < MAX_ITER
    monkeypatch.setattr(graph, "CHUNK", chunk)
    out, st = tg.solve(p, max_iter=MAX_ITER, fix_frames=2, loss_delta=50.0, **CPU64)
    _bit_equal(_result(out, st), _result(ref, st_ref))
    assert st["attempts"] == chunk * st["reads"] == chunk * -(-st["iterations"] // chunk)


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
    # a LoopGraph refuses the CPU rather than run eagerly there
    with pytest.raises(ValueError, match="CUDA"):
        graph.loop_graph(key, list(key[4]), *tg.graph_fns(10, 2, 50.0), p.Ps.device)
    with pytest.raises(ValueError, match="CUDA"):
        graph.loop_graph(k, list(k[2]), *pcg.graph_fns(0), H.device)


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
    """PCG's program at ``chunk`` iterations a read on the eager loop: (the
    carry, x as returned, the iterations)."""
    carry = []

    def kept(c, sy):
        carry.append(c)
        return [c.x]

    g = graph.EagerLoop(None, pcg.graph_key(H, b, max_iter)[2], *pcg.graph_fns(max_iter),
                        "cpu", kept=kept, k=chunk)
    g.inputs.upload([rtol])
    g.inputs.load([H, b], start=1)
    x = torch.empty_like(b)
    (k,) = g.run(keep=[x])
    return carry[0], x, int(k)


@pytest.mark.parametrize("P", [60, 200])
@pytest.mark.parametrize("end,max_iter", [("tolerance", 0), ("cap", 7)])
def test_pcg_graph_functions_match_jax(P, end, max_iter):
    """κ(H) ≤ 1e2·16 (the diagonal's spread): the loop ends at the
    tolerance after 61 and 86 iterations, in both packages.  At 1e3·16 CG
    in float64 runs well past P iterations, where its count follows
    round-off in either package (P = 60: 113 here, 117 in vio_tpu, x 6e-9
    apart)."""
    H, b, (Hn, bn) = _spd(P, 1e2)
    rtol = 1e-8
    x, k = pcg.pcg_solve(H, b, max_iter, rtol)
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
    x, kc = pcg.pcg_solve(H, b, 0, 1e-8)
    assert kc == k
    _bit_equal([x], [ref.x])
