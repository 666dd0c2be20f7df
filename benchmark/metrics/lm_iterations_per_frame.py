"""The window LM's iterations (telemetry ``iterations``) a frame, over the
window's frames before the traced slice."""


def read(run):
    tel = run.host_telemetry()
    return sum(t["iterations"] for t in tel) / run.host_frames if tel else None
