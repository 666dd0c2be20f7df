"""Judge of the window solve: each sampled frame step against the plain
window reference (``reference/window.py``).  ``window_cost_left`` is the
median over the frames of the share of the reducible cost that the
solve left; the marginalization block's gaps, the prior's shift and the
re-fix are each the widest over the frames."""
from __future__ import annotations

import numpy as np

from benchmark.reference import window
from benchmark.reference.judges import widest

RECORDS = "frame_steps"
GAPS = ("marg_H_gap", "marg_b_gap", "prior_shift_gap", "refix_gap")


def judge(run, records: list, control: dict) -> tuple[dict, list]:
    items = [window.judge(r, run.reference_device) for r in records]
    numbers = {k: widest([j[k] for j in items]) for k in GAPS}
    left = [j["cost_gap_out"] / j["cost_gap_in"] for j in items if j["cost_gap_in"] > 0]
    numbers["window_cost_left"] = float(np.median(left)) if left else None
    return numbers, items
