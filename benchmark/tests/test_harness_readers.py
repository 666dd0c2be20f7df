"""The readers of the program's spans and counters on hand-built runs:
what they read from the estimator's records, and None where the records
or the device hold nothing for them (the parent's estimator, the CPU)."""
import importlib
from types import SimpleNamespace

import pytest

CARD = [dict(pack_ms=2.0, upload_ms=0.5, step_ms=30.0, wait_ms=20.0, reads=9),
        dict(pack_ms=2.2, upload_ms=0.7, step_ms=34.0, wait_ms=24.0, reads=11,
             capture_ms=150.0)]
CPU = [dict(pack_ms=2.0, step_ms=30.0, reads=0), dict(pack_ms=2.2, step_ms=34.0, reads=0)]
PARENT = [dict(solve_ms=32.5, marg_ms=3.0, iterations=9)] * 2


def _run(tel, host_frames=None, window_captures=0):
    """A run whose window's frames before the traced slice are ``tel``'s
    (``host_frames`` of them, failed frames without a record included),
    followed by a traced frame with a record of its own."""
    n = len(tel) if host_frames is None else host_frames
    return SimpleNamespace(host_frames=n, host_telemetry=lambda: tel,
                           telemetry=tel + [dict(pack_ms=9.0, wait_ms=99.0, reads=50)],
                           counts=dict(captures=window_captures))


def _read(name, run):
    return importlib.import_module(f"benchmark.metrics.{name}").read(run)


def test_frame_step_readers_on_the_card_records():
    assert _read("frame_pack_ms", _run(CARD)) == pytest.approx(2.7)
    assert _read("frame_wait_ms", _run(CARD)) == pytest.approx(22.0)
    assert _read("lm_host_reads_per_frame", _run(CARD)) == pytest.approx(10.0)


def test_frame_step_readers_count_frames_without_a_record():
    """As the other telemetry readers do, a frame over the window's frames
    before the slice, a failed frame's (no record) among them."""
    run = _run(CARD, host_frames=4)
    assert _read("frame_pack_ms", run) == pytest.approx(1.35)
    assert _read("frame_wait_ms", run) == pytest.approx(11.0)
    assert _read("lm_host_reads_per_frame", run) == pytest.approx(5.0)


@pytest.mark.parametrize("tel", [CPU, PARENT, []], ids=["cpu", "parent", "none"])
def test_frame_step_readers_read_nothing_without_a_graph(tel):
    for name in ("frame_pack_ms", "frame_wait_ms", "lm_host_reads_per_frame"):
        assert _read(name, _run(tel)) is None, name


@pytest.fixture
def stats(monkeypatch):
    from vio_tpu_torch.solver import graph
    monkeypatch.setattr(graph, "STATS", type(graph.STATS)())
    return graph.STATS


def test_capture_setup_s_leaves_out_the_windows_captures(stats):
    stats.update(captures=3, capture_s=12.5)
    assert _read("capture_setup_s", _run(PARENT)) == pytest.approx(12.5)
    # the window captured once, for 150 ms: its record says so
    assert _read("capture_setup_s", _run(CARD, window_captures=1)) == pytest.approx(12.35)


def test_capture_setup_s_reads_nothing_it_cannot_split(stats):
    assert _read("capture_setup_s", _run(CPU)) is None          # nothing captured
    stats.update(captures=3, capture_s=12.5)
    # the window captured and no record says how long
    assert _read("capture_setup_s", _run(PARENT, window_captures=1)) is None
