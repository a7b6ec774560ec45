"""The comparison that decides ``correct`` for a training cell: the
program's first steps against the reference's, as a few numbers, each
held to a limit of the cell's own (``limits/<cell>.json``).

Per step (the worst of the checked steps), relative to the reference:
``loss`` (to the loss's own size, the mean absolute value of its terms),
``grad_norm`` (the global gradient norm before the clip), ``entropy``
and ``iw_mean`` (the metric vector's mean entropy and importance
weight). Per leaf (the worst leaf), the gap between the two sides' norms
against the reference's norm of that leaf or of the median leaf,
whichever is larger: ``grad_leaf``, Adam's first moment after step 1
(the clipped gradients as the optimizer got them), and ``change_leaf``,
each leaf's change over the checked steps, leaving out leaves whose
reference gradient is under a thousandth of the median leaf's (their
gradient is nought but for rounding, as a key bias's under softmax, and
Adam moves them by round-off alone).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Tuple

ORDER = ("loss", "grad_norm", "entropy", "iw_mean", "grad_leaf",
         "change_leaf")
NOUGHT_SHARE = 1e-3


def _step_gap(p: List[dict], r: List[dict], key: str,
              scale_key: Optional[str] = None) -> float:
    gaps = []
    for a, b in zip(p, r):
        scale = abs(b[scale_key if scale_key else key])
        gaps.append(abs(a[key] - b[key]) / max(scale, 1e-12))
    return max(gaps)


def _leaf_gap(p: Dict[str, float], r: Dict[str, float],
              keys: List[str]) -> float:
    med = statistics.median(r[k] for k in keys)
    return max(abs(p[k] - r[k]) / max(r[k], med, 1e-30) for k in keys)


def nought_leaves(ref: dict) -> List[str]:
    """Leaves whose reference gradient is nought but for rounding."""
    med = statistics.median(ref["m1"].values())
    return sorted(k for k, v in ref["m1"].items() if v < NOUGHT_SHARE * med)


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    ps, rs = prog["steps"], ref["steps"]
    out = {"loss": _step_gap(ps, rs, "loss", "loss_scale"),
           "grad_norm": _step_gap(ps, rs, "grad_norm"),
           "entropy": _step_gap(ps, rs, "entropy"),
           "iw_mean": _step_gap(ps, rs, "iw_mean")}
    leaves = sorted(ref["m1"])
    out["grad_leaf"] = _leaf_gap(prog["m1"], ref["m1"], leaves)
    nought = nought_leaves(ref)
    moving = [k for k in leaves if k not in nought]
    out["change_leaf"] = _leaf_gap(prog["change"], ref["change"], moving)
    return {k: (v if math.isfinite(v) else float("inf"))
            for k, v in out.items()}


def judge(nums: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; the others are printed with a null limit and not held."""
    compared = {k: {"value": nums[k], "limit": limits.get(k)}
                for k in ORDER if k in nums}
    ok = all(v["value"] <= v["limit"] for v in compared.values()
             if v["limit"] is not None)
    held = any(v["limit"] is not None for v in compared.values())
    return ok and held, compared
