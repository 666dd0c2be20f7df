"""The loop closer's work a frame (telemetry ``loop_ms``: the program's
span ``est.loop``, the keyframe handed to the closer with its query,
verification and pose-graph solve), ms a frame, over the window's
frames before the traced slice.  None where no frame holds it: an
estimator without loop closing."""


def read(run):
    tel = run.host_telemetry()
    if not any("loop_ms" in t for t in tel):
        return None
    return sum(t.get("loop_ms", 0.0) for t in tel) / run.host_frames
