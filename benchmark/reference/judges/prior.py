"""Judge of the host prior chain: the prior that the estimator handed the
step after each sampled one against the plain chain
(``reference/prior.py``), widest over the frames.  In a run of the
control, the plain chain in the control's ``prior_chain_dtype`` stands
in for the program's prior."""
from __future__ import annotations

import torch

from benchmark.reference import prior
from benchmark.reference.judges import widest

RECORDS = "frame_steps"


def judge(run, records: list, control: dict) -> tuple[dict, list]:
    lam = float(run.cell.config["settings"]["prior_forgetting"])
    dt = control.get("prior_chain_dtype")
    dt = getattr(torch, dt) if dt else None
    items = [dict(prior_chain_gap=prior.judge(r, lam, run.reference_device, dt)) for r in records]
    return dict(prior_chain_gap=widest([j["prior_chain_gap"] for j in items])), items
