"""The comparison that decides ``correct`` for a training cell.

Three numbers, each against its limit in ``perfbench/limits/<cell>.json``:

* ``loss_gap``: the largest relative gap of a step's mean token loss,
  ``|loss - loss_ref| / loss_ref``, over the checked steps;
* ``grad_norm_gap``: the worst leaf's gap of first-gradient norms,
  ``| |g| - |g_ref| | / max(|g_ref|, median leaf |g_ref|)``;
* ``change_norm_gap``: the same of each leaf's change over the checked
  steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf Adam moves by round-off alone
  is left out by that rule, never by name).

``harness/report.py`` holds each against its limit: a number above it,
or one that is not finite, fails the run.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

QUIET_LEAF = 1e-3


def _worst_leaf(mine: Dict[str, float], ref: Dict[str, float],
                leaves) -> Tuple[float, str]:
    floor = statistics.median(ref[n] for n in leaves)
    worst, at = 0.0, ""
    for n in leaves:
        gap = abs(mine[n] - ref[n]) / max(ref[n], floor)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, at = gap, n
    return worst, at


def compare(mine: dict, ref: dict) -> Dict[str, dict]:
    """The numbers, each with where it was read."""
    if set(mine["grad_norm"]) != set(ref["grad_norm"]):
        raise ValueError("the program's leaves are not the reference's")
    steps = len(ref["loss"])
    if len(mine["loss"]) != steps:
        raise ValueError("the program ran another number of steps")
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(mine["loss"], ref["loss"])]
    loss_gap = max(losses)
    names = sorted(ref["grad_norm"])
    g_med = statistics.median(ref["grad_norm"][n] for n in names)
    moving = [n for n in names if ref["grad_norm"][n] >= QUIET_LEAF * g_med]
    grad, grad_at = _worst_leaf(mine["grad_norm"], ref["grad_norm"], names)
    change, change_at = _worst_leaf(mine["change_norm"], ref["change_norm"],
                                    moving)
    return {"loss_gap": {"value": loss_gap,
                         "at": f"step {1 + losses.index(loss_gap)}"},
            "grad_norm_gap": {"value": grad, "at": grad_at},
            "change_norm_gap": {"value": change, "at": change_at,
                                "leaves": len(moving)}}

