"""The numbers that decide ``correct`` for a training cell, and the
verdict against the cell's limits.

Each side brings, for the steps it ran from the same weights, batches
and seed: each step's loss ``(l+ + l-) / 2`` and projected gradients
``gs_k = (l+ - l-) / (2 eps)``, and per leaf the norm of its change
after the first step over lr (the gradient as the update applied it)
and after the last step. The numbers are

* ``loss_gap``: over the steps, the larger of ``|loss_prog - loss_ref|``
  and ``eps * |gs_prog - gs_ref|`` over ``|loss_ref|``: with one
  direction, the larger gap of the two evaluations ``l+`` and ``l-``
  (an error the mean cancels shows in the difference);
* ``gs_gap``: the first step's gradient as the optimizer records it
  (``gs``, the replay log's number), ``eps * |gs_prog - gs_ref|`` over
  ``|loss_ref|``;
* ``grad_gap`` and ``change_gap``: over the leaves, the largest gap
  between the two sides' norms, ``|n_prog - n_ref|``, over the larger
  of the reference's norm of that leaf and of its median leaf;
  ``change_med_gap``: the median over the leaves of that gap after the
  last step;
* ``update_gap``: the larger of ``grad_gap`` and ``change_gap`` taken
  against the reference's update replayed with the program's own gs
  (``reference.train.replay``): the update judged apart from the
  gradient, which the two gaps above mix (where ``|gs|`` is near 0 they
  read the gradient's relative error, and a bf16 leaf's change jumps
  where ``lr |gs|`` crosses a power of two: see ``PERF.md``).

A cell compares the numbers its workload file gives limits for.
"""

from __future__ import annotations

import statistics
from typing import Dict, Tuple


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float]) -> list:
    med = statistics.median(ref.values())
    gaps = []
    for path, r in ref.items():
        den = max(abs(r), abs(med))
        gaps.append(abs(prog[path] - r) / den if den > 0 else (
            0.0 if prog[path] == r else float("inf")))
    return gaps


def loss_gap(prog: dict, ref: dict, eps: float) -> float:
    worst = 0.0
    for lp, lr_, gp, gr in zip(prog["losses"], ref["losses"], prog["gs"],
                               ref["gs"]):
        gap = max([abs(lp - lr_)] + [eps * abs(a - b)
                                     for a, b in zip(gp, gr)])
        worst = max(worst, gap / abs(lr_) if lr_ else gap)
    return worst


def gs_gap(prog: dict, ref: dict, eps: float) -> float:
    return eps * max(abs(a - b) for a, b in zip(prog["gs"][0],
                                                ref["gs"][0])) / abs(
        ref["losses"][0])


def training_numbers(prog: dict, ref: dict, eps: float,
                     upd: dict) -> Dict[str, float]:
    """``upd``: the reference's replay of the update with ``prog``'s gs."""
    return {"loss_gap": loss_gap(prog, ref, eps),
            "gs_gap": gs_gap(prog, ref, eps),
            "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"])),
            "change_gap": max(leaf_gaps(prog["change"], ref["change"])),
            "change_med_gap": statistics.median(
                leaf_gaps(prog["change"], ref["change"])),
            "update_gap": max(leaf_gaps(prog["grad"], upd["grad"])
                              + leaf_gaps(prog["change"], upd["change"]))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct when every number
    is finite and within its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers[name]
        good = v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
