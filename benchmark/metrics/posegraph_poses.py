"""The mean size of the window's pose-graph solves: unpadded poses (the
keyframes in the graph) a solve (``posegraph.STATS``: poses over
solves).  None where the window solved none."""


def read(run):
    n = run.counts.get("pg_solves")
    return run.counts["pg_poses"] / n if n else None
