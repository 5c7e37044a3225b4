"""Device time of the aggregate layer's epilogue in a profiled span, by
kernel name: the aggregate forward body's (``tagf::``,
``tgt_torch/csrc/triplet_aggregate_fwd.cu``) calls that store through the
output's strides into lin_O's pair-order buffer (the template tag
``PairStore``), and PyTorch's generic elementwise kernel
(``elementwise_kernel<128, 4``), which runs where operands are broadcast,
transposed or in layouts that disagree."""
from __future__ import annotations

from typing import Optional, Tuple

BODY = "tagf::"
PAIR_STORE = "PairStore"
STRIDED = "::elementwise_kernel<128, 4"


def _trace(rec, driver: str):
    t = rec.get("trace")
    if rec["mix"]["driver"] != driver or not t:
        return None
    return t


def body_seconds(rec, driver: str) -> Optional[Tuple[float, float]]:
    """(the pair-order store's device seconds, the whole body's), or None
    without a trace of the driver's items or without body time in it."""
    t = _trace(rec, driver)
    if t is None:
        return None
    body = pair = 0.0
    for name, s in t["kernels"].items():
        if BODY in name:
            body += s
            if PAIR_STORE in name:
                pair += s
    return (pair, body) if body > 0 else None


def strided_seconds(rec, driver: str) -> Optional[Tuple[float, int]]:
    """(the generic elementwise kernel's device seconds, the traced items'
    molecules), or None without a trace of the driver's items or without
    molecules in it."""
    t = _trace(rec, driver)
    if t is None:
        return None
    molecules = sum(len(i["sizes"]) for i in t["items"])
    if not molecules:
        return None
    return (sum(s for name, s in t["kernels"].items() if STRIDED in name),
            molecules)
