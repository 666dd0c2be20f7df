"""Judge of the loop closer's accepted loops: each loop edge that the
window's keyframes accepted against the simulator's true relative pose,
from the closed-form trajectory at the two keyframes' times
(``harness/stream.py``'s ``motion_model``: the body's pose, which the
program's estimator and the truth share up to a gauge that a relative
pose does not see).

- ``loop_edge_m``: the median over the window's loop edges of
  |dP − R_oldᵀ (p_new − p_old)|, in metres;
- ``loop_edge_deg``: the median of the angle of (R_oldᵀ R_new)ᵀ R_edge,
  in degrees;
- ``loop_edge_odometry_share``: the share of the window's loop edges
  that are the edge the same keyframes' odometry poses give (``LoopEdges``
  records both), to ``SAME_M`` and ``SAME_RAD``: a closer that skips
  verification and takes the odometry's edge reads 1, a verifying one 0
  (its PnP edge lies centimetres off the drifting odometry).  The edge
  errors cannot part the two: on this cell the odometry's own edges read
  medians of 0.05-0.12 m, inside the verified edges' spread;
- ``loop_miss_share``: the share of the window's keyframes that accepted
  no loop.  A program that skips retrieval, or drops what it finds,
  reads 1 here and cannot pass as faster.

The edge numbers read None where the window accepted no loop, and the
share reads None where the window took no keyframe.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import stream

RECORDS = "loops"
SAME_M = 1e-6       # an accepted edge this close to the odometry's is the odometry's
SAME_RAD = 1e-6


def _quat_to_mat(q):
    """(x, y, z, w) unit quaternion → rotation matrix."""
    x, y, z, w = q / np.linalg.norm(q)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def _angle_deg(qa, qb) -> float:
    """The angle between two rotations given as (x, y, z, w) quaternions."""
    cos = (np.trace(_quat_to_mat(np.asarray(qa, np.float64)).T
                    @ _quat_to_mat(np.asarray(qb, np.float64))) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


def edge_errors(rec: dict) -> dict:
    """One keyframe's loop edge against the truth: its position error (m)
    and angle error (deg)."""
    loop = rec["loop"]
    truth = stream.motion_model(np.array([loop["t_old"], rec["t"]]))
    (p_o, p_n), (R_o, R_n) = truth["p_wb"], truth["R_wb"]
    dP_true = R_o.T @ (p_n - p_o)
    cos = (np.trace((R_o.T @ R_n).T @ _quat_to_mat(np.asarray(loop["dq"], np.float64))) - 1) / 2
    return dict(edge_m=float(np.linalg.norm(np.asarray(loop["dP"]) - dP_true)),
                edge_deg=float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))))


def is_odometry(rec: dict) -> bool:
    """Whether a keyframe's accepted edge is its odometry's edge."""
    loop, odo = rec["loop"], rec["odometry"]
    return bool(np.linalg.norm(np.asarray(loop["dP"]) - np.asarray(odo["dP"])) <= SAME_M
                and np.radians(_angle_deg(loop["dq"], odo["dq"])) <= SAME_RAD)


def judge(run, records: list, control: dict) -> tuple[dict, list]:
    items = []
    for r in records:
        if r["loop"] is not None:
            item = edge_errors(r)
            if "odometry" in r:
                item["odometry"] = is_odometry(r)
            items.append(item)
    same = [j["odometry"] for j in items if "odometry" in j]
    numbers = dict(
        loop_edge_m=float(np.median([j["edge_m"] for j in items])) if items else None,
        loop_edge_deg=float(np.median([j["edge_deg"] for j in items])) if items else None,
        loop_edge_odometry_share=(sum(same) / len(same)
                                  if same and len(same) == len(items) else None),
        loop_miss_share=1.0 - len(items) / len(records) if records else None)
    return numbers, items
