"""The graph cache's warm-up and capture seconds inside the set-up: the
process's ``graph.STATS["capture_s"]`` (the program's span
``graph.capture``) less the window's captures (telemetry ``capture_ms``).
One run a process, as ``benchmark/run.py`` makes it.  None where nothing
was captured (the CPU), or where the window captured and its records do
not say how long."""


def read(run):
    from vio_tpu_torch.solver import graph
    if not graph.STATS["captures"]:
        return None
    in_window = [t["capture_ms"] for t in run.telemetry if "capture_ms" in t]
    if run.counts.get("captures") and not in_window:
        return None
    return graph.STATS["capture_s"] - 1e-3 * sum(in_window)
