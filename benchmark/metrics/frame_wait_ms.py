"""The host blocked on the card inside the frame step (telemetry
``wait_ms``: the program's span ``graph.wait``, around each read of the LM
loop's condition and the outputs' readback), ms a frame, over the window's
frames before the traced slice.  None where no frame waits on a graph: an
estimator without the spans, or the CPU's eager step."""


def read(run):
    tel = run.host_telemetry()
    if not any("wait_ms" in t for t in tel):
        return None
    return sum(t.get("wait_ms", 0.0) for t in tel) / run.host_frames
