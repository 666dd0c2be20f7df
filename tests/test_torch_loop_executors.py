"""The port's five device loops (the frame step, the window LM, global BA,
Jacobi-PCG, the pose graph), each one program that either of
vio_tpu_torch/solver/graph.py's executors runs: ``LoopGraph``, the card's
captured graphs, and ``EagerLoop``, op by op.

On the CPU, in float32 and float64, the eager loop runs each program's
head, chunk and tail with no host read inside them (a capture would refuse
one), gives the same bits at chunk 1 and chunk 3 (attempts after the
loop's end change nothing), and counts its attempts and reads as a
``LoopGraph`` counts its replays' (the attempts k times the reads, one
read a chunk), which the solvers' stats report.  The ``gpu`` test holds
the captured graphs, at their capture and at a replay, to the eager loop
on the card, bit for bit, with the same counts; it skips here.  On the
card ``index_add_``'s atomics make two runs of global BA or of the pose
graph differ in their last bits whatever the executor, so that test runs
under ``torch.use_deterministic_algorithms``.  The file imports no JAX:
on the card, ``python3 -m pytest --noconftest -m gpu
tests/test_torch_loop_executors.py``."""
import pytest
import torch

from _torch_loops import PROGRAMS, Made, bit_equal, record_frame
from vio_tpu_torch.solver import graph, pcg

torch.set_num_threads(1)
DTYPES = [torch.float32, torch.float64]


@pytest.fixture(scope="module")
def frame():
    return record_frame()


def _chunked(monkeypatch, k: int) -> None:
    monkeypatch.setattr(graph, "CHUNK", k)
    monkeypatch.setattr(pcg, "CHUNK", k)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_the_eager_loop_runs_each_program_as_its_graphs_would(monkeypatch, frame, name,
                                                              dtype):
    run, outs, made = PROGRAMS[name], {}, {}
    for k in (1, 3):
        _chunked(monkeypatch, k)
        made[k] = Made(graph.EagerLoop, guard=True)
        outs[k] = run(made[k], "cpu", dtype, frame)
    bit_equal(outs[1][0], outs[3][0])
    (g1,), (g3,) = made[1].made, made[3].made
    assert (g1.chunk, g3.chunk) == (1, 3) and g1.reads > 1
    for k, g in ((1, g1), (3, g3)):
        assert g.attempts == k * g.reads
        assert outs[k][1] in (None, (g.attempts, g.reads))
    assert g3.reads == -(-g1.reads // 3)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(PROGRAMS))
def test_the_captured_graphs_are_the_eager_loop_on_the_card(frame, name):
    """float32 and float64: the eager loop, then the key's capture and a
    replay of it, on the same inputs."""
    _card()
    run = PROGRAMS[name]
    graph.clear()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for dtype in DTYPES:
            eager, graphed = Made(graph.EagerLoop), Made(graph.loop_graph)
            ref = run(eager, "cuda", dtype, frame)
            c0 = graph.STATS["captures"]
            got = [run(graphed, "cuda", dtype, frame) for _ in range(2)]
            assert graph.STATS["captures"] - c0 == 3
            (e,), (g, again) = eager.made, graphed.made
            assert g is again and isinstance(g, graph.LoopGraph)
            for out in got:
                bit_equal(out[0], ref[0])
                assert out[1] == ref[1]
            assert (g.attempts, g.reads) == (e.attempts, e.reads)
    finally:
        torch.use_deterministic_algorithms(False)
        graph.clear()
