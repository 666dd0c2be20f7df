"""The least work of the problems the per-layer rooflines count, whatever
implements them, against the card's published peaks (``peaks.json``).

- The window's SPD solve (``gj_solve``): a Cholesky factorisation and
  two triangular solves, P³/3 + 2P² operations for one right-hand side;
  A and b read once and x written once.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
ELEM = {"float32": 4, "float64": 8}


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of the operations over the type's peak rate and the
    bytes over the memory's, in seconds."""
    return max(flops / PEAKS["flop_s"][dtype], nbytes / PEAKS["bytes_s"])


def spd_solve_s(P: int, dtype: str) -> float:
    return least_s(P ** 3 / 3 + 2 * P * P, (P * P + 2 * P) * ELEM[dtype], dtype)

