"""The numbers that decide ``correct``, from the program's readings and the
reference's.

Training (the first three steps of the object the window then runs):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first step's gradient as the optimizer gets it, by
  the worst leaf: |program norm - reference norm| over the larger of the
  reference's norm of that leaf and of the median leaf;
* ``change_gap``: the change of each leaf over the three steps, the same
  way, leaving out leaves whose reference gradient is under a thousandth
  of the median leaf's (nought to rounding; they move by round-off alone);
* ``slot_gap``: the change of each optimizer slot over the three steps
  (``<leaf>:<slot>``: FTRL's ``accum`` n and ``linear`` z, Adagrad's
  ``accum``), the same way over the slots of the same leaves.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

NOUGHT = 1e-3


def _gap(a: float, b: float, scale: float) -> float:
    """|a - b| / scale; a gap that is not a number (a NaN on either side)
    counts as infinite."""
    gap = abs(a - b) / scale if scale > 0 else (0.0 if a == b
                                                 else float("inf"))
    return gap if gap == gap else float("inf")


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    keys = sorted(leaves if leaves is not None else ref)
    if not keys:
        return 0.0, ""
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        gap = _gap(prog[k], ref[k], max(ref[k], med))
        if gap > worst or not at:
            worst, at = gap, k
    return worst, at


def training_numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """-> {name: (number, where)} from two readings {"losses": [..],
    "grad_norms": {leaf: norm}, "change_norms": {leaf: norm},
    "slot_norms": {leaf:slot: norm}}."""
    for key in ("grad_norms", "slot_norms"):
        missing = sorted(set(ref[key]) ^ set(prog[key]))
        if missing:
            raise ValueError(f"the two sides' {key} differ: {missing}")
    losses = list(zip(prog["losses"], ref["losses"]))
    loss_gap, at = 0.0, ""
    for k, (p, r) in enumerate(losses):
        gap = _gap(p, r, max(abs(r), 1e-30))
        if gap >= loss_gap:
            loss_gap, at = gap, f"step {k + 1}"
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap, at = float("inf"), "steps missing"
    grads = ref["grad_norms"]
    med = statistics.median(grads.values())
    moving = [k for k, v in grads.items() if v >= NOUGHT * med]
    slots = [k for k in ref["slot_norms"] if k.split(":")[0] in moving]
    return {"loss_gap": (loss_gap, at),
            "grad_gap": worst_leaf(prog["grad_norms"], grads),
            "change_gap": worst_leaf(prog["change_norms"],
                                     ref["change_norms"], moving),
            "slot_gap": worst_leaf(prog["slot_norms"], ref["slot_norms"],
                                   slots)}


def verdict(numbers: Dict[str, Tuple[float, str]],
            limits: Dict[str, float]) -> bool:
    return all(numbers[k][0] <= limits[k] for k in limits)
