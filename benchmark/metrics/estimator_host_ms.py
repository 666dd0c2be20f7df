"""The estimator's host work a frame: the span around ``process_image``
less the telemetry's ``solve_ms`` (pack, graphed frame step, fetch) and
``marg_ms`` (the host prior chain), ms a frame, over the window's frames
before the traced slice."""


def read(run):
    s = run.spans.get("process_image")
    if s is None or not run.host_frames:
        return None
    dev = sum(t["solve_ms"] + t["marg_ms"] for t in run.host_telemetry())
    return (1e3 * s - dev) / run.host_frames
