"""The comparison that decides ``correct``: the program's readings against
the reference's, as a few numbers, each held to its limit.

Readings are ``{"losses": [...], "grad": {leaf: norm}, "change": {leaf:
norm}}`` and, where a cell has it, ``"rows"`` (each row's write level
after the first step, by :func:`write_levels`).  Norms are compared by the worst leaf: the gap
between the program's norm and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger.  A leaf whose
reference gradient is under a thousandth of the median leaf's moves by
round-off alone and is left out of both.
"""

from __future__ import annotations

import math
import statistics

#: a leaf whose reference gradient is below this share of the median leaf's
#: is not compared
NEGLIGIBLE_GRAD = 1e-3
#: a row counts as written where its sum of squared gradients exceeds this
#: share of the median written row's: a row whose gradients cancel to
#: rounding (a few ulps of a residual, squared: ~1e-23 against a median of
#: ~1e-9) lies far below it, the smallest real write (~1e-16) far above
WRITTEN_SHARE = 1e-10


def write_levels(sum_sq):
    """Each row of a sum-of-squares plane as 0 (no write), 1 (a write of
    rounding's size: its gradients cancelled) or 2 (written), as int8."""
    nonzero = sum_sq[sum_sq > 0]
    floor = WRITTEN_SHARE * float(nonzero.median()) if nonzero.numel() else 0.0
    return (sum_sq > 0).char() + (sum_sq > floor).char()


def _largest(gaps) -> float:
    """The largest gap, or infinity where one is not a number (``max``
    would skip a NaN or keep it by its position)."""
    gaps = list(gaps)
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.inf


def _leaf_gaps(prog: dict, ref: dict, leaves: list) -> list:
    median = statistics.median(ref[n] for n in leaves)
    return [abs(prog[n] - ref[n]) / max(abs(ref[n]), median) for n in leaves]


def numbers(prog: dict, ref: dict) -> dict:
    """Every number one run can be held to: ``loss_gap`` (the largest
    relative gap of a step's loss), ``grad_gap`` (first step's gradient
    norms, worst leaf), ``change_gap`` (the parameters' change over the
    checked steps, worst leaf), ``change_gap_median`` (the median leaf's
    change gap) and, with write levels, ``slot_mismatch`` (rows one side
    wrote and the other did not touch at all).  A cell's limits name the
    ones it is held to."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError(f"{len(prog['losses'])} program losses against "
                         f"{len(ref['losses'])} reference losses")
    out = {"loss_gap": _largest(abs(p - r) / abs(r)
                                for p, r in zip(prog["losses"], ref["losses"]))}
    median = statistics.median(ref["grad"].values())
    leaves = [n for n, g in ref["grad"].items() if g >= NEGLIGIBLE_GRAD * median]
    out["grad_gap"] = _largest(_leaf_gaps(prog["grad"], ref["grad"], leaves))
    changes = _leaf_gaps(prog["change"], ref["change"], leaves)
    out["change_gap"] = _largest(changes)
    out["change_gap_median"] = (statistics.median(changes)
                                if all(math.isfinite(g) for g in changes) else math.inf)
    if "rows" in ref:
        out["slot_mismatch"] = float(((prog["rows"] - ref["rows"]).abs() == 2).sum())
    return out


def judge(values: dict, limits: dict) -> bool:
    """True when every number that has a limit is finite and within it."""
    missing = set(limits) - set(values)
    if missing:
        raise ValueError(f"no number for the limits {sorted(missing)}")
    return all(math.isfinite(values[k]) and values[k] <= limit for k, limit in limits.items())
