"""The host float64 prior chain (telemetry ``marg_ms``), ms a frame, over
the window's frames before the traced slice."""


def read(run):
    tel = run.host_telemetry()
    return sum(t["marg_ms"] for t in tel) / run.host_frames if tel else None
