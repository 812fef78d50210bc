"""The numbers that decide ``correct``, each against its limit.

Training (the program's first steps against the reference's, from the same
weights, inputs and random draws):

* ``loss_gap``: the largest |loss - reference loss| / |reference loss| over
  the checked steps.
* ``grad_gap``: the first step's gradient as the optimizer got it, by leaf:
  the worst leaf's |norm - reference norm| over the larger of the
  reference's norm of that leaf and of the median leaf; ``grad_gap_median``
  the median leaf's.
* ``change_gap``, ``change_gap_median``: the same of each leaf's change over
  the checked steps. Leaves whose reference gradient is under a thousandth
  of the median leaf's (nought to rounding, such as a key's bias under
  softmax) move under Adam by round-off alone and are left out of them.
* ``image_gap``, ``text_gap``: the first step's image and text embeddings
  (the towers and projections before any update), the largest L2 distance
  between one and the reference's (both unit vectors).
A cell's limits file names the numbers it holds. The median-leaf numbers
stand in for the worst leaf's where rounding alone swings the worst leaf
as far as the control does (PERF.md section 4).

Embeddings (every answer of the window against the reference's of its
input): ``image_gap`` and ``text_gap``, as above.

A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List

import numpy as np

ROUNDING_FLOOR = 1e-3


IMAGES = ("image_embeddings", "image_view_embeddings")
TEXTS = ("text_embeddings", "text_embeddings2")


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> Dict[str, float]:
    """Each leaf's |norm - reference norm| over the larger of the reference's
    norm of that leaf and of the median leaf."""
    floor = statistics.median(ref[n] for n in names)
    return {n: abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], floor, 1e-30) for n in names}


def moved_leaves(ref: Dict) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding."""
    names = sorted(ref["grad"])
    floor = ROUNDING_FLOOR * statistics.median(ref["grad"][n] for n in names)
    return [n for n in names if ref["grad"][n] >= floor]


def embedding_gap(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return math.inf
    return float(np.linalg.norm(prog.astype(np.float64) - ref.astype(np.float64), axis=-1).max())


def training_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog``/``ref``: {"loss": [...], "grad": {leaf: norm}, "change": {leaf:
    norm}, "embeddings": {output: array}}."""
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    else:
        loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    grad = list(leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"])).values())
    change = list(leaf_gaps(prog["change"], ref["change"], moved_leaves(ref)).values())
    emb = lambda keys: max(embedding_gap(prog["embeddings"][k], ref["embeddings"][k])
                           for k in keys)
    return {"loss_gap": loss,
            "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
            "change_gap": max(change), "change_gap_median": statistics.median(change),
            "image_gap": emb(IMAGES), "text_gap": emb(TEXTS)}


def worst_leaves(prog: Dict, ref: Dict, k: int = 3) -> Dict[str, list]:
    """The ``k`` leaves with the largest gradient and change gaps, as (name,
    gap, norm, reference norm): what ``readings`` prints beside the numbers."""
    out = {}
    for key, names in (("grad", sorted(ref["grad"])), ("change", moved_leaves(ref))):
        gap = leaf_gaps(prog[key], ref[key], names)
        out[key] = [(n, gap[n], prog[key].get(n, math.inf), ref[key][n])
                    for n in sorted(gap, key=gap.get, reverse=True)[:k]]
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """{name: {"value", "limit"}} of every limited number; a number the run
    could not give counts as infinite."""
    return {name: {"value": values.get(name, math.inf), "limit": limit}
            for name, limit in limits.items()}


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
