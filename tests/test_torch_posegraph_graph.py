"""The pose graph's LM on the device (vio_tpu_torch/loop/posegraph.py on
vio_tpu_torch/solver/generic.py's branch-free Nielsen attempt), on the
CPU in float64 against ``vio_tpu.loop.posegraph.optimize``, whose LM is
the host loop of ``vio_tpu/solver/generic.py``.

Held: the padded, branch-free route takes the same iterations as
``vio_tpu``, its chi²/λ log within 1e-10 relative and its poses within
1e-8, weighted and unweighted, with the first pose fixed or free, at the
iteration cap (1 and 2) and from a start at the optimum, where every
attempt is rejected; padded equals unpadded within 1e-10; an attempt
after the loop has ended changes no bit; the keys hold what is static
and are shared within a bucket, and a closer's graph, at most two edges
a pose, is keyed by its poses alone; ``prepare`` captures nothing on the
CPU; a ``LoopGraph`` refuses the CPU; the card's damped solve (the
library's Cholesky) and the CPU's are held to each other and to the plain
pose graph of benchmark/reference/posegraph.py, and no size is refused;
``spd_solve`` still sends P > 1024 to PCG.  The ``gpu`` tests run the
graphs against the eager twin and the CPU route at 700 and 1,000 poses,
and the kernel at its ceiling, on the card; they skip here
(tests/test_torch_loop_executors.py holds the graphs to the eager loop
on the card, bit for bit)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_loop import _circuit
from vio_tpu.loop import posegraph as jposegraph
from vio_tpu_torch import testing
from vio_tpu_torch.ops import linsolve
from vio_tpu_torch.loop import posegraph
from vio_tpu_torch.solver import generic, graph

torch.set_num_threads(1)
CPU = dict(device="cpu", dtype=torch.float64)


def _circuit_args(n=40):
    _, _, args, w = testing.posegraph_circuit(n)
    return args, w


def _square():
    """A square circuit whose start is its optimum, to the bit: integer
    positions, identity rotations, edges that agree exactly, so chi², b
    and every step are 0 and every attempt is rejected (ρ = 0)."""
    P = np.array([[0.0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]])
    q = np.tile([0.0, 0, 0, 1], (4, 1))
    ei, ej = np.array([0, 1, 2, 0]), np.array([1, 2, 3, 3])
    return (P, q, ei, ej, P[ej] - P[ei], np.tile([0.0, 0, 0, 1], (4, 1)))


def _hold_to_jax(got, ref, iterations=None):
    (Po, qo, st), (Pj, qj, stj) = got, ref
    assert st["iterations"] == stj["iterations"]
    if iterations is not None:
        assert st["iterations"] == iterations
    np.testing.assert_allclose(Po, Pj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(qo, qj, rtol=0, atol=1e-8)
    for name in ("chi2", "lam"):
        a = np.array(getattr(st["log"], name))
        b = np.array(getattr(stj["log"], name))
        assert a.shape == b.shape == (st["iterations"] + 1,), name
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0, err_msg=name)
    assert st["chi2"] == st["log"].chi2[-1]


def test_circuit_is_test_torch_loops():
    """``testing.posegraph_circuit`` builds tests/test_torch_loop.py's
    drifting circuit."""
    P, R, Pd, Rd = _circuit()
    Pt, Rt, args, w = testing.posegraph_circuit()
    np.testing.assert_array_equal(P, Pt)
    np.testing.assert_array_equal(R, Rt)
    np.testing.assert_array_equal(args[0], Pd)
    assert len(args[2]) == len(w) == 42 and w[-1] == 5.0


@pytest.mark.parametrize("weighted,fix_first,max_iter,iterations", [
    (True, True, 40, None), (False, False, 5, None), (True, True, 1, 1), (True, True, 2, 2)],
    ids=["weighted", "unweighted-free", "cap1", "cap2"])
def test_branch_free_route_matches_jax(weighted, fix_first, max_iter, iterations):
    args, w = _circuit_args()
    w = w if weighted else None
    got = posegraph.optimize(*args, edge_weights=w, fix_first=fix_first, max_iter=max_iter,
                             **CPU)
    ref = jposegraph.optimize(*args, edge_weights=w, fix_first=fix_first, max_iter=max_iter)
    _hold_to_jax(got, ref, iterations)
    st = got[2]
    assert st["attempts"] == st["reads"] >= st["iterations"] and st["key"] is None
    if fix_first:
        np.testing.assert_array_equal(got[0][0], args[0][0])
    if max_iter == 40:
        assert st["iterations"] >= 2


def test_start_at_the_optimum_ends_on_ten_rejections():
    """Each iteration is ten rejected attempts (λ grows by ν = 2, 4, ...,
    2¹⁰); the second ends the loop on Δχ² = 0."""
    args = _square()
    got = posegraph.optimize(*args, max_iter=40, **CPU)
    ref = jposegraph.optimize(*args, max_iter=40)
    _hold_to_jax(got, ref, iterations=2)
    assert got[2]["attempts"] == 2 * generic.MAX_REJECTS
    np.testing.assert_array_equal(got[0], args[0])
    lam = got[2]["log"].lam
    assert lam[1] == lam[0] * 2.0 ** 55 and got[2]["log"].chi2 == [0.0] * 3


@pytest.mark.parametrize("weighted", [True, False], ids=["weighted", "unweighted"])
def test_padded_equals_unpadded(monkeypatch, weighted):
    args, w = _circuit_args()
    w = w if weighted else None
    Pp, qp, stp = posegraph.optimize(*args, edge_weights=w, max_iter=40, **CPU)
    assert posegraph.padded(*args)[0].shape[0] == 64
    monkeypatch.setattr(posegraph, "POSE_BUCKET", 1)
    monkeypatch.setattr(posegraph, "EDGE_BUCKET", 1)
    monkeypatch.setattr(posegraph, "EDGES_PER_POSE", 0)
    assert posegraph.padded(*args)[0].shape[0] == 40
    assert posegraph.padded(*args)[2].shape[0] == len(args[2])
    Pu, qu, stu = posegraph.optimize(*args, edge_weights=w, max_iter=40, **CPU)
    assert stp["iterations"] == stu["iterations"] >= 2
    np.testing.assert_allclose(Pp, Pu, rtol=0, atol=1e-10)
    np.testing.assert_allclose(qp, qu, rtol=0, atol=1e-10)
    np.testing.assert_allclose(stp["log"].chi2, stu["log"].chi2, rtol=1e-10, atol=0)
    np.testing.assert_allclose(stp["log"].lam, stu["log"].lam, rtol=1e-10, atol=0)


def _to_the_end(q, x0):
    """Attempts until the loop's condition, read after each one, is
    false: the final state and the attempts made."""
    s, n = generic.start(q, x0), 0
    while not n or bool(generic.live(s, q.max_iter)):
        s, n = generic.attempt(s, q), n + 1
    return s, n


def test_attempts_after_the_end_change_no_bit():
    """Run to the loop's end (after rejections and after the stop flag),
    then attempt again: nothing moves; likewise at the iteration cap."""
    arrays = posegraph.padded(*_square())
    g = posegraph.PoseGraph(*(torch.as_tensor(a) for a in arrays))
    q, x0, _ = posegraph.problem(g, 40)
    s, n = _to_the_end(q, x0)
    assert bool(s.stop) and n == 20
    again = generic.attempts(s, q, 3)
    for a, b in zip(again, s):
        assert torch.equal(a, b)
    args, w = _circuit_args()
    arrays = posegraph.padded(*args, edge_weights=w)
    g = posegraph.PoseGraph(*(torch.as_tensor(a) for a in arrays))
    q, x0, _ = posegraph.problem(g, 2)
    s, n = _to_the_end(q, x0)
    assert int(s.it) == 2 and not bool(s.stop)
    for a, b in zip(generic.attempts(s, q, 2), s):
        assert torch.equal(a, b)


def test_keys_are_shared_within_a_bucket():
    """Circuits of 40 and 60 poses share a key (64 padded poses, 128
    padded edges); one of 70 does not; nor do other static arguments."""
    def key(n, **kw):
        args, w = _circuit_args(n)
        a = posegraph.padded(*args, edge_weights=w)
        k = dict(dtype=torch.float64, fix_first=True, max_iter=40,
                 stop_delta_chi=posegraph.STOP_DELTA_CHI, device="cpu")
        k.update(kw)
        return posegraph.graph_key(len(a[0]), len(a[2]), **k)
    assert key(40) == key(60) != key(70)
    for kw in (dict(dtype=torch.float32), dict(fix_first=False), dict(max_iter=41),
               dict(stop_delta_chi=1e-6), dict(device="meta")):
        assert key(40, **kw) != key(40)
    with pytest.raises(ValueError, match="CUDA"):     # a LoopGraph refuses the CPU
        posegraph._solve(graph.loop_graph, posegraph.padded(*_square()), True, 40, **CPU)


@pytest.mark.parametrize("n", [40, 64, 65])
def test_a_closers_graph_is_keyed_by_its_poses_alone(n):
    """A graph of n poses with its n - 1 odometry edges and any number of
    loops up to one a pose pads its edges to EDGES_PER_POSE (2) times its
    padded poses: one key from no loop to a loop on every pose."""
    n_pad = posegraph._bucket(n, posegraph.POSE_BUCKET)
    shapes = set()
    for loops in (0, 1, n // 2, n):
        chain = np.arange(n - 1)
        ei = np.concatenate([chain, np.zeros(loops, np.int64)])
        ej = np.concatenate([chain + 1, np.full(loops, n - 1)])
        q = np.tile([0.0, 0.0, 0.0, 1.0], (len(ei), 1))
        a = posegraph.padded(np.zeros((n, 3)), np.tile([0.0, 0.0, 0.0, 1.0], (n, 1)), ei, ej,
                             np.zeros((len(ei), 3)), q)
        assert a[6][:len(ei)].all() and not a[6][len(ei):].any()
        shapes.add((len(a[0]), len(a[2])))
    assert shapes == {(n_pad, 2 * n_pad)}


def test_prepare_captures_nothing_on_the_cpu():
    """``prepare`` is the card's: on the CPU it captures no graph, solves
    nothing and counts nothing."""
    s0, c0 = dict(posegraph.STATS), graph.STATS["captures"]
    assert posegraph.prepare(100, max_iter=40, **CPU) == 0
    assert dict(posegraph.STATS) == s0 and graph.STATS["captures"] == c0


def test_the_card_takes_a_graph_of_any_size():
    """672 and 673 poses, padded to 672 and 704 (4032 and 4224 unknowns,
    on both sides of gj_solve's ceiling, which once bounded the pose
    graph): nothing checks a graph's size, and the card's damped solve,
    the library's Cholesky, solves the larger graph's damped normal
    equations as the CPU's ``torch.linalg.solve`` does."""
    assert not hasattr(posegraph, "_check_size")
    assert not hasattr(linsolve, "damped_route")
    for n, n_pad in ((672, 672), (673, 704)):
        args, w = _circuit_args(n)
        arrays = posegraph.padded(*args, w, True)
        assert 6 * len(arrays[0]) == 6 * n_pad
    assert 6 * n_pad > linsolve.KERNEL_MAX_P
    g = posegraph.PoseGraph(*(torch.as_tensor(a, dtype=graph.spec_of(a, torch.float64)[1])
                              for a in arrays))
    q, x0, _ = posegraph.problem(g, 40)
    H, b, _ = q.normal_fn(x0)
    lam = 1e-5 * torch.diagonal(H).abs().max()
    x_cpu = generic.damped_solve(H, b, lam)
    A = H.clone()
    A.diagonal().add_(lam)
    x_card = linsolve.cholesky_solve(A, b)
    assert torch.isfinite(x_card).all() and float(x_cpu.abs().max()) > 0
    assert float((x_card - x_cpu).abs().max()) <= 1e-9 * float(x_cpu.abs().max())


@pytest.mark.parametrize("n", [40, 70])
def test_the_cards_solve_and_the_cpus_solve_the_same_graph_as_the_plain_reference(
        monkeypatch, n):
    """The card's damped solve (``linsolve.cholesky_solve``, run on the
    CPU as it is) in place of the CPU's ``torch.linalg.solve``: the same
    iterations, the poses within 1e-10 of each other, and each judged
    sound by the benchmark's plain pose graph
    (benchmark/reference/posegraph.py) at the cell's limits' order: cost
    left and pose gap far under 1e-6, pose 0 held."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmark.reference import posegraph as ref
    args, w = _circuit_args(n)
    out = {"linalg.solve": posegraph.optimize(*args, edge_weights=w, max_iter=40, **CPU)}
    calls = []

    def card(A, b):
        calls.append(A.shape[0])
        return linsolve.cholesky_solve(A, b)

    monkeypatch.setattr(torch.linalg, "solve", card)
    out["cholesky"] = posegraph.optimize(*args, edge_weights=w, max_iter=40, **CPU)
    monkeypatch.undo()
    assert calls and set(calls) == {6 * posegraph._bucket(n, posegraph.POSE_BUCKET)}
    (Pl, ql, sl), (Pc, qc, sc) = out.values()
    assert sl["iterations"] == sc["iterations"] > 0 and len(calls) == sc["attempts"]
    assert np.abs(Pl - Pc).max() <= 1e-10 and np.abs(ql - qc).max() <= 1e-10
    for Ps, qs, st in out.values():
        rec = dict(inputs=dict(Ps0=args[0], qs0=args[1], ei=args[2], ej=args[3], dP=args[4],
                               dq=args[5], w=np.asarray(w), fix_first=True, max_iter=40),
                   outputs=dict(Ps=Ps, qs=qs, iterations=st["iterations"]))
        j = ref.judge(rec)
        assert j["cost_gap_in"] > 0
        assert abs(j["cost_gap_out"] / j["cost_gap_in"]) < 1e-10
        assert j["pose_gap"] < 1e-9 and j["fix_gap"] < 1e-15


def test_the_pose_graph_counts_its_solves_attempts_and_sizes():
    """``posegraph.STATS`` and ``ATTEMPTS_BY_P`` gain each solve's
    unpadded poses, attempts and iterations, by its padded P."""
    args, w = _circuit_args(40)
    s0, p0 = dict(posegraph.STATS), posegraph.ATTEMPTS_BY_P[384]
    _, _, st = posegraph.optimize(*args, edge_weights=w, max_iter=40, **CPU)
    gained = {k: posegraph.STATS[k] - s0.get(k, 0) for k in posegraph.STATS}
    assert gained["solves"] == 1 and gained["poses"] == 40
    assert gained["attempts"] == st["attempts"] and gained["iterations"] == st["iterations"]
    assert posegraph.ATTEMPTS_BY_P[384] - p0 == st["attempts"]


def test_spd_solve_keeps_its_pcg_switch_and_the_kernel_its_new_ceiling(monkeypatch):
    """``spd_solve`` sends P > DIRECT_MAX_P (1024) to PCG, as vio_tpu does;
    the kernel's guard (gj_solve.cu's kMaxP) is the wrapper's
    KERNEL_MAX_P, 4096, and the wrapper refuses a larger system."""
    src = (Path(linsolve.__file__).parent.parent / "csrc" / "gj_solve.cu").read_text()
    assert int(re.search(r"constexpr int kMaxP = (\d+);", src)[1]) == linsolve.KERNEL_MAX_P
    assert "P > kMaxP" in src
    assert linsolve.KERNEL_MAX_P == 4096 and linsolve.DIRECT_MAX_P == 1024
    from vio_tpu_torch.solver import pcg
    calls = []
    monkeypatch.setattr(pcg, "pcg_solve", lambda A, b: (calls.append(A.shape[0]) or b, 0))
    monkeypatch.setattr(linsolve, "gj_solve_unblocked_reference",
                        lambda A, b: calls.append(-A.shape[0]) or b)
    for P in (1024, 1025, 4096):
        linsolve.spd_solve(torch.eye(P, dtype=torch.float64), torch.ones(P, dtype=torch.float64))
    assert calls == [-1024, 1025, 4096]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
def test_gj_solve_takes_its_new_ceiling_on_the_card():
    _card()
    for dtype in (torch.float32, torch.float64):
        P = linsolve.KERNEL_MAX_P
        gen = torch.Generator().manual_seed(0)
        M = torch.randn((P, P), generator=gen, dtype=torch.float64)
        A = (M @ M.T / P + torch.eye(P, dtype=torch.float64)).to("cuda", dtype)
        b = torch.randn(P, generator=gen, dtype=torch.float64).to("cuda", dtype)
        x = linsolve.gj_solve(A, b)
        res = torch.linalg.norm(A.double() @ x.double() - b.double()) / torch.linalg.norm(
            b.double())
        assert float(res) < (1e-3 if dtype == torch.float32 else 1e-10)
        big = torch.eye(P + 1, dtype=dtype, device="cuda")
        with pytest.raises(ValueError, match="shapes"):
            linsolve.gj_solve(big, big[0])


@pytest.mark.gpu
@pytest.mark.parametrize("n", [700, 1000])
def test_the_card_solves_pose_graphs_past_the_kernels_sizes(n):
    """float64, drifting circuits of 700 and 1,000 poses (P = 4224 and
    6144 padded, once above gj_solve's ceiling): the graphs take the
    library's Cholesky, and end as the eager twin and the CPU do."""
    _card()
    args, w = _circuit_args(n)
    kw = dict(edge_weights=w, max_iter=40, dtype=torch.float64)
    c0 = linsolve.cholesky_solve.launches
    Pg, qg, stg = posegraph.optimize(*args, device="cuda", **kw)
    assert linsolve.cholesky_solve.launches - c0 == stg["attempts"]
    Pe, qe, ste = posegraph.optimize_eager(*args, device="cuda", **kw)
    Pc, qc, stc = posegraph.optimize(*args, device="cpu", **kw)
    assert stg["iterations"] == ste["iterations"] == stc["iterations"]
    assert np.abs(Pg - Pe).max() <= 1e-9
    assert np.abs(Pg - Pc).max() <= 1e-8 and np.abs(qg - qc).max() <= 1e-8


@pytest.mark.gpu
def test_prepare_captures_the_key_that_a_later_solve_replays():
    """float64, a circuit of 150 poses: ``prepare(150)`` captures the
    three graphs of its key and counts them, not a solve; the solve after
    it captures nothing, and a second ``prepare`` captures nothing."""
    _card()
    args, w = _circuit_args(150)
    kw = dict(max_iter=40, device="cuda", dtype=torch.float64)
    s0 = dict(posegraph.STATS)
    made = posegraph.prepare(150, **kw)
    assert made in (0, 3)
    assert posegraph.STATS["captures"] - s0.get("captures", 0) == made
    assert posegraph.STATS["solves"] == s0.get("solves", 0)
    c0 = graph.STATS["captures"]
    _, _, st = posegraph.optimize(*args, edge_weights=w, **kw)
    assert graph.STATS["captures"] == c0 and st["iterations"] > 0
    assert posegraph.prepare(150, **kw) == 0
