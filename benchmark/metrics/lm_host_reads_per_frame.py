"""The graphed LM loop's host reads of its condition (telemetry
``reads``: the frame's ``LoopGraph.reads``) a frame, over the window's
frames before the traced slice.  None where no frame read one: an
estimator without the field, or the CPU's eager step, which runs no
graph (its records hold 0)."""


def read(run):
    tel = run.host_telemetry()
    if not any(t.get("reads") for t in tel):
        return None
    return sum(t["reads"] for t in tel) / run.host_frames
