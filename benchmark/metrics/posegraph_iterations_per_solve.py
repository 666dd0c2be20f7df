"""The pose graph's LM iterations a solve (``posegraph.STATS``:
iterations over solves), over the window's solves.  None where the
window solved none."""


def read(run):
    n = run.counts.get("pg_solves")
    return run.counts["pg_iterations"] / n if n else None
