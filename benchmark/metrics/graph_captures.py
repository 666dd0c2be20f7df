"""CUDA-graph captures (``graph.STATS["captures"]``) inside the window:
shapes that the warm-up did not reach."""


def read(run):
    return float(run.counts["captures"]) if "captures" in run.counts else None
