"""Seconds of the pose graph's captures inside the window
(``posegraph.STATS["capture_s"]``: the graph cache's warm-up and capture
of a new padded size).  None where the program does not count them."""


def read(run):
    return run.counts.get("pg_capture_s")
