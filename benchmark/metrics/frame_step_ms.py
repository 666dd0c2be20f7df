"""The per-frame device call (telemetry ``solve_ms``: pack, the graphed
frame step, fetch), ms a frame, over the window's frames before the traced
slice."""


def read(run):
    tel = run.host_telemetry()
    return sum(t["solve_ms"] for t in tel) / run.host_frames if tel else None
