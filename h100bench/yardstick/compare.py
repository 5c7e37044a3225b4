"""The numbers that decide ``correct``: what the timed path produced
against what the reference computes from the same inputs.

Training (the check steps): ``loss_gap``, the largest relative gap of a
step's loss; ``grad_gap``, the worst leaf's gap between the program's and
the reference's norm of the first gradient, over every leaf but the four
of the 3D embedding's Gaussian basis (``GRAD_SET_ASIDE``: their gradients
follow the bf16 rounding of the input distances and swing from seed to
seed; their worst gap is kept beside, in ``training_details``);
``change_gap``, the worst leaf's gap between the norms of its change after
the last check step, over the leaves whose reference gradient is at least
a thousandth of the median leaf's (the others move under Adam by
round-off alone). A leaf's gap is measured against the reference's norm
of that leaf or of the median leaf, whichever is larger.

Serving: the total-variation distance between the served and the
reference bin distribution of each valid atom pair of the judged requests;
``prob_gap``, its mean over the worst request's pairs; ``prob_gap_mean``,
its mean over all their pairs; ``prob_gap_rate0``, the first of these for
the same requests served with every dropout off (the serving driver).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

SMALL_LEAF = 1e-3
# the 3D embedding's Gaussian basis: means, stds, and the pair-type mul and
# bias, whose first gradients follow the bf16 rounding of the distances
GRAD_SET_ASIDE = ".m3d_embed.gbf."


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    """Each leaf's gap, against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    keys = list(keys)
    median = float(np.median([ref[k] for k in keys]))
    gaps = {}
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
        gaps[k] = gap if math.isfinite(gap) else float("inf")
    return gaps


def training(prog: dict, ref: dict) -> Dict[str, float]:
    loss = max(abs(p - r) / abs(r) if math.isfinite(p) else float("inf")
               for p, r in zip(prog["losses"], ref["losses"]))
    grads = ref["grad_norms"]
    median = float(np.median(list(grads.values())))
    moving = [k for k, g in grads.items() if g >= SMALL_LEAF * median]
    grad_gaps = _leaf_gaps(prog["grad_norms"], grads, grads)
    change_gaps = _leaf_gaps(prog["change_norms"], ref["change_norms"],
                             moving)
    return {"loss_gap": loss,
            "grad_gap": max(g for k, g in grad_gaps.items()
                            if GRAD_SET_ASIDE not in k),
            "change_gap": max(change_gaps.values())}


def _tv(served, ref, sizes):
    """item -> the total-variation distance of each valid atom pair."""
    out = {}
    for item, p in served.items():
        n = sizes[item]
        gap = (p[:n, :n].astype(np.float64)
               - ref[item][:n, :n].astype(np.float64))
        out[item] = 0.5 * np.abs(gap).sum(-1)
    return out


def serving(served: Dict[int, np.ndarray], ref: Dict[int, np.ndarray],
            sizes: Dict[int, int]) -> Dict[str, float]:
    tv = _tv(served, ref, sizes)
    if not tv or not all(np.isfinite(t).all() for t in tv.values()):
        return {"prob_gap": float("inf"), "prob_gap_mean": float("inf")}
    pairs = sum(t.size for t in tv.values())
    return {"prob_gap": max(float(t.mean()) for t in tv.values()),
            "prob_gap_mean": sum(float(t.sum()) for t in tv.values()) / pairs}


def serving_details(served, ref, sizes) -> dict:
    """The widest gap of any one pair, and the request it lies in."""
    tv = _tv(served, ref, sizes)
    item = max(tv, key=lambda i: float(tv[i].max()))
    return {"pair_max": float(tv[item].max()), "item": int(item),
            "atoms": int(sizes[item])}


def training_details(prog: dict, ref: dict) -> dict:
    """The worst leaf of each leaf gap, with its norms; for the first
    gradient also the worst of the leaves set aside, and the median and
    90th percentile of the others' gaps."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        gaps = _leaf_gaps(prog[key], ref[key], ref[key])
        worst = max(gaps, key=gaps.get)
        out[key] = {"leaf": worst, "gap": gaps[worst], "ref": ref[key][worst],
                    "prog": prog[key][worst]}
        if key == "grad_norms":
            aside = [k for k in gaps if GRAD_SET_ASIDE in k]
            kept = [gaps[k] for k in gaps if GRAD_SET_ASIDE not in k]
            out[key].update(
                set_aside=max((gaps[k] for k in aside), default=None),
                median=float(np.median(kept)),
                p90=float(np.percentile(kept, 90)))
    return out


def judge(numbers: Dict[str, float], limits: dict) -> bool:
    """Every number that has a limit is finite and within it."""
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        if limit is None:
            continue
        if not (math.isfinite(value) and value <= limit):
            return False
    return True
