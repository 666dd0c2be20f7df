"""Judge of the loop closer's pose graph: each sampled solve against the
plain pose graph (``reference/posegraph.py``).  ``posegraph_cost_left``
is the median over the solves of the share of the reducible cost that
the solve left; ``posegraph_pose_gap`` and ``posegraph_fix_gap`` are
each the widest over the solves."""
from __future__ import annotations

import numpy as np

from benchmark.reference import posegraph
from benchmark.reference.judges import widest

RECORDS = "posegraph"


def judge(run, records: list, control: dict) -> tuple[dict, list]:
    items = [posegraph.judge(r, run.reference_device) for r in records]
    left = [j["cost_gap_out"] / j["cost_gap_in"] for j in items if j["cost_gap_in"] > 0]
    return dict(posegraph_cost_left=float(np.median(left)) if left else None,
                posegraph_pose_gap=widest([j["pose_gap"] for j in items]),
                posegraph_fix_gap=widest([j["fix_gap"] for j in items])), items
