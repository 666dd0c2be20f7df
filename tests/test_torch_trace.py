"""The port's spans (vio_tpu_torch/trace.py) on the CPU: the telemetry
fields they give each solved frame, their ranges on a recording
profiler's trace, their cost with no profiler, and their per-thread
totals."""
import statistics
import threading
import time

import pytest
import torch

from vio_tpu_torch import runner, sim, trace

torch.set_num_threads(1)

N_FRAMES = 20           # initialises at frame 10: ten solved frames
PROFILED = (3, 5)       # post-init frames [3, 5) run under the profiler
EST_SPANS = ("frame", "features", "triangulate", "pack", "step", "unpack",
             "outliers", "prior", "slide")
CHILDREN = EST_SPANS[1:]


class _Counting:
    """torch.profiler.record_function, counted by whether a profiler was
    recording when it was made."""

    def __init__(self, real):
        self.real = real
        self.on = self.off = 0

    def __call__(self, name):
        if torch._C._autograd._profiler_enabled():
            self.on += 1
        else:
            self.off += 1
        return self.real(name)


@pytest.fixture(scope="module")
def run():
    """A float64 run_sim past initialisation, two of its frames under a
    CPU profiler, with another thread opening spans all through it."""
    from torch.profiler import ProfilerActivity, profile
    counting = _Counting(torch.profiler.record_function)
    state = dict(prof=None, events=None)
    stop = threading.Event()
    other = {}

    def spin():
        while not stop.is_set():
            with trace.span("graph.wait"):
                time.sleep(1e-4)
            with trace.span("est.pack"):
                pass
        other.update(trace.since({}))

    def on_frame(est, t, feats):
        n = len(est.telemetry)
        if n == PROFILED[0] and state["prof"] is None:
            state["prof"] = profile(activities=[ProfilerActivity.CPU])
            state["prof"].__enter__()
        elif n == PROFILED[1] and state["events"] is None:
            state["prof"].__exit__(None, None, None)
            state["events"] = list(state["prof"].events())

    th = threading.Thread(target=spin, daemon=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", counting)
        th.start()
        try:
            est, _ = runner.run_sim(sim.generate(noise=False), n_frames=N_FRAMES,
                                    on_frame=on_frame, device="cpu")
        finally:
            stop.set()
            th.join(timeout=60)
    assert not th.is_alive()
    assert state["events"] is not None, "the run did not reach the profiled frames"
    return dict(records=est.telemetry, events=state["events"], counting=counting,
                other=other)


def test_every_solved_frame_carries_its_spans(run):
    recs = run["records"]
    assert len(recs) >= 8
    for r in recs:
        for name in EST_SPANS:
            assert r[f"{name}_ms"] >= 0.0, (name, r)
        assert r["reads"] == 0                   # the CPU runs no LoopGraph
        assert abs(r["solve_ms"] - (r["pack_ms"] + r["step_ms"])) <= 1.5e-3, r
        assert r["marg_ms"] == r["prior_ms"]
        assert not {"upload_ms", "replay_ms", "wait_ms", "capture_ms"} & set(r)


def test_children_cover_the_frame(run):
    """After initialisation the frame's own spans cover its span, as a
    median over the frames."""
    cover = [sum(r[f"{c}_ms"] for c in CHILDREN) / r["frame_ms"]
             for r in run["records"][1:]]
    assert statistics.median(cover) >= 0.95, cover
    assert max(cover) <= 1.0 + 1e-6


def test_profiler_trace_nests_est_ranges_in_the_frame(run):
    ev = [e for e in run["events"] if e.name.startswith(trace.PREFIX)]
    frames = [e for e in ev if e.name == "vio.est.frame"]
    assert len(frames) == PROFILED[1] - PROFILED[0]
    inner = [e for e in ev if e.name.startswith("vio.est.") and e.name != "vio.est.frame"]
    assert {e.name for e in inner} == {f"vio.est.{c}" for c in CHILDREN}
    for e in inner:
        s, t = e.time_range.start, e.time_range.end
        assert any(f.time_range.start <= s and t <= f.time_range.end for f in frames), e.name
    # the other thread's spans are no ranges of the estimator's thread
    threads = {e.thread for e in frames}
    assert not [e for e in ev if e.thread in threads and e.name.startswith("vio.graph.")]


def test_no_profiler_no_record_function(run):
    c = run["counting"]
    assert c.off == 0
    assert c.on > 0                              # the profiled frames' ranges


def test_other_threads_spans_stay_out_of_the_record(run):
    """The other thread opened ``graph.wait`` and ``est.pack`` all through
    the run: in its own totals, not in the estimator's records."""
    other = run["other"]
    assert other["graph.wait"] > 0 and other["est.pack"] > 0
    for r in run["records"]:
        assert "wait_ms" not in r and r["reads"] == 0


def test_since_gives_what_the_thread_added():
    m = trace.mark()
    with trace.span("test.outer"):
        with trace.span("test.inner"):
            time.sleep(2e-3)
    secs = trace.since(m)
    assert set(secs) == {"test.outer", "test.inner"}
    assert secs["test.outer"] >= secs["test.inner"] >= 2e-3
    assert trace.since(trace.mark()) == {}


def test_a_frame_that_raises_leaves_no_record(monkeypatch):
    """A frame whose solve set its record and then raised leaves nothing
    behind: the next frame's record is its own, or none."""
    from vio_tpu_torch import config
    from vio_tpu_torch.estimator import Estimator
    est = Estimator(config.sim_config(), device="cpu")
    stale = dict(t=-1.0)

    def raises(feats, t):
        est._record = stale
        raise RuntimeError("the solve failed")

    monkeypatch.setattr(est, "_process_image", raises)
    with pytest.raises(RuntimeError):
        est.process_image({}, 0.0)
    monkeypatch.setattr(est, "_process_image", lambda feats, t: None)
    est.process_image({}, 0.1)
    assert est.telemetry == []


# ---- scripts/torch_frame_spans.py: the idle split and the frame numbers ----

def _script():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", "torch_frame_spans.py")
    spec = importlib.util.spec_from_file_location("torch_frame_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(name, cat, ts, dur):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


# a 100 µs slice: kernels at [10, 20), [30, 40), [86, 90) and a copy at
# [60, 80); vio.est.frame over [6, 92), vio.est.step [22, 70) inside it,
# vio.graph.wait [45, 65) inside that; the harness's bench.process_image
# over [6, 92)
EVENTS = [
    _x("bench.slice", "user_annotation", 0, 100),
    _x("bench.process_image", "user_annotation", 6, 86),
    _x("vio.est.frame", "user_annotation", 6, 86),
    _x("vio.est.step", "user_annotation", 22, 48),
    _x("vio.graph.wait", "user_annotation", 45, 20),
    _x("k1", "kernel", 10, 10),
    _x("k2", "kernel", 30, 10),
    _x("Memcpy DtoH", "gpu_memcpy", 60, 20),
    _x("k3", "kernel", 86, 4),
    _x("cpu_op", "cpu_op", 0, 100),
]


def test_program_gaps_name_the_innermost_vio_range():
    gaps = _script().program_gaps(EVENTS)
    # idle [0, 10): [0, 6) outside every range, [6, 10) in est.frame alone;
    # [20, 30): [20, 22) est.frame, [22, 30) est.step; [40, 60): [40, 45)
    # est.step, [45, 60) graph.wait; [80, 86) est.frame; [90, 100): [90,
    # 92) est.frame, [92, 100) outside
    assert gaps == pytest.approx({"outside": 14e-6, "est.frame": 14e-6,
                                  "est.step": 13e-6, "graph.wait": 15e-6})


def test_program_gaps_split_the_harness_idle_gaps():
    """The same events through the harness's own reduction: its idle gaps,
    named by its own ranges, hold the same idle seconds."""
    from benchmark.harness.trace import summary
    s = summary(EVENTS)
    gaps = _script().program_gaps(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6) and s["busy_s"] == pytest.approx(44e-6)
    assert dict(s["idle_gaps"]) == pytest.approx({"process_image": 36e-6, "harness": 20e-6})
    assert sum(gaps.values()) == pytest.approx(s["window_s"] - s["busy_s"])


def test_program_gaps_without_vio_ranges_are_outside():
    plain = [e for e in EVENTS if not e["name"].startswith("vio.")]
    assert _script().program_gaps(plain) == pytest.approx({"outside": 56e-6})
