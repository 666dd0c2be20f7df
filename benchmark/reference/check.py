"""The comparison that decides ``correct``.

After the window has closed and the program's device state is freed,
the frame steps that the window sampled (``workloads/<cell>.json``:
``check.sample_frames``, drawn from the seed) are judged by the plain
reference of the window solve (``window.judge``), and the prior that
the estimator's host chain handed the step after each sampled one by
the plain chain (``prior.judge``).  ``window_cost_left`` is the median
over the sampled frames of the share of the reducible cost that the
solve left; every other number is the widest over what was judged.
Each is held to its limit in the workload's
``check.limits``.  The reference runs on the card where the run does,
in float64.

A run of the cell's control (``readings.py --control-seeds``) runs the
program's own narrower estimator (the driver switches it on) and puts
the plain prior chain, in the dtype the workload's ``control`` names, in
the place of the prior that the program handed on; the same judges
judge it.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import prior, window


def _widest(vals):
    vals = [v for v in vals if v is not None]
    return max(vals) if vals else None


def evaluate(run) -> dict:
    w = run.cell.workload
    limits = w["check"]["limits"]
    ctrl = w.get("control", {}) if run.control else {}
    dev = "cpu" if run.device == "cpu" else "cuda"
    lam = float(run.cell.config["settings"]["prior_forgetting"])
    chain_dt = ctrl.get("prior_chain_dtype")
    judged = []
    for r in run.records:
        j = window.judge(r, dev)
        j["prior_chain_gap"] = prior.judge(r, lam, dev, getattr(torch, chain_dt) if chain_dt
                                           else None)
        judged.append(j)
    run.judged = judged
    values = {k: _widest([j[k] for j in judged])
              for k in ("marg_H_gap", "marg_b_gap", "prior_shift_gap", "prior_chain_gap",
                        "refix_gap")}
    left = [j["cost_gap_out"] / j["cost_gap_in"] for j in judged if j["cost_gap_in"] > 0]
    values["window_cost_left"] = float(np.median(left)) if left else None
    return {k: dict(value=values.get(k), limit=v) for k, v in limits.items()}
