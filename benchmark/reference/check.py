"""The comparison that decides ``correct``.

After the window has closed and the program's device state is freed,
what the window's recorders sampled (drawn from the seed) is judged by
the judges that the workload names (``workloads/<cell>.json``:
``check.judges``, modules of ``reference/judges/``; where the key is
absent, ``window`` and ``prior``).  A judge module has ``RECORDS``, the
name of the recorder whose records it reads (``Run.recorded``), and one
entry, ``judge(run, records, control) -> (numbers, items)``: its named
numbers for the run, reduced over the records, and one dict of numbers
a record for the run's account.  It sees no other recorder's records.

Each number is held to its limit in the workload's ``check.limits``: a
limit that no judge gives reads None, and a number that a judge gives
with no limit stops the run.  The references run on the card where the
run does, in float64.

A run of the cell's control (``readings.py --control-seeds``) runs the
program's own narrower path (the cell's module in ``drivers/`` switches
it on, from the workload's ``control``); the same entries reach every judge as
``control``, and a judge puts its plain reference in a dtype named there
in the program's place (``prior``: ``prior_chain_dtype``).
"""
from __future__ import annotations

import importlib

DEFAULT_JUDGES = ("window", "prior")


def evaluate(run) -> dict:
    w = run.cell.workload
    limits = w["check"]["limits"]
    control = w.get("control", {}) if run.control else {}
    values, judged = {}, []
    for name in w["check"].get("judges", DEFAULT_JUDGES):
        judge = importlib.import_module(f"benchmark.reference.judges.{name}")
        numbers, items = judge.judge(run, run.recorded.get(judge.RECORDS, []), control)
        for k, v in numbers.items():
            if k not in limits:
                raise SystemExit(f"judge {name} gives {k}, which has no limit in "
                                 f"workloads/{run.cell.name}.json check.limits: "
                                 f"{sorted(limits)}")
            if k in values:
                raise SystemExit(f"judge {name} gives {k}, which another judge gave")
            values[k] = v
        judged += [(name, j) for j in items]
    run.judged = judged
    return {k: dict(value=values.get(k), limit=v) for k, v in limits.items()}
