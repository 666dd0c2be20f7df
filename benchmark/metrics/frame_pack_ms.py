"""The host's pack and upload of the graphed frame step's inputs
(telemetry ``pack_ms`` + ``upload_ms``: the program's spans ``est.pack``
and ``graph.upload``), ms a frame, over the window's frames before the
traced slice.  None where no frame uploads through a graph's slab: an
estimator without the spans, or the CPU's eager step."""


def read(run):
    tel = run.host_telemetry()
    if not any("upload_ms" in t for t in tel):
        return None
    return sum(t.get("pack_ms", 0.0) + t.get("upload_ms", 0.0) for t in tel) / run.host_frames
