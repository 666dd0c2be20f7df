"""The loop closer's pose-graph solve after an accepted loop (telemetry
``loop_solve_ms``: the program's span ``loop.solve``), ms a solve, over
the solves of the window's frames before the traced slice (a frame
takes one keyframe, so one solve at most).  None where none solved."""


def read(run):
    ms = [t["loop_solve_ms"] for t in run.host_telemetry() if "loop_solve_ms" in t]
    return sum(ms) / len(ms) if ms else None
