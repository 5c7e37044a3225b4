"""The arithmetic of the per-layer metrics, over a run's record: the
window's molecules and seconds, and the profiled span's reduction
(``harness.reduce_trace``) with the counters and shapes of each item
traced. Each reader returns None where it finds nothing to read."""
from __future__ import annotations

from typing import Optional, Sequence

from h100bench.yardstick import bounds, flops, peaks


def _driver(rec) -> str:
    return rec["mix"]["driver"]


def mfu(rec, driver: str) -> Optional[float]:
    """Model operations of the molecules the window completed over its
    seconds, as a share of the bf16 peak."""
    if _driver(rec) != driver:
        return None
    w, cfg = rec["window"], rec["cfg"]
    if not w["sizes"] or w["seconds"] <= 0:
        return None
    if driver == "train":
        ops = flops.train_flops(cfg, w["sizes"])
    else:
        ops = flops.serve_flops(cfg, w["sizes"], cfg["evaluation_samples"])
    return 100.0 * ops / w["seconds"] / peaks.BF16_FLOPS


def device_idle(rec, driver: str) -> Optional[float]:
    """1 - (the union of the device's operation intervals / the span)."""
    t = rec.get("trace")
    if _driver(rec) != driver or not t or t["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])


def launches_per_molecule(rec, driver: str) -> Optional[float]:
    t = rec.get("trace")
    if _driver(rec) != driver or not t:
        return None
    molecules = sum(len(i["sizes"]) for i in t["items"])
    return t["launches"] / molecules if molecules else None


def roofline(rec, core: str, counters: Sequence[str], *,
             call: Optional[str] = None,
             kernels: Sequence[str] = ()) -> Optional[float]:
    """The bound time of the core's calls in the span (counted by the
    wrapper's counters, at each item's bucket and rows) over their device
    time: with ``call``, that of every operation launched inside the core's
    marked entry point (``harness.marked_calls``), copies included; with
    ``kernels``, that of the kernels whose names hold one of them, the
    core's body alone."""
    t, cfg = rec.get("trace"), rec["cfg"]
    if not t:
        return None
    heads = cfg["triplet_heads"]
    d = cfg["edge_width"] // heads
    itemsize = 2 if cfg.get("mixed_precision") else 4
    bound = sum(sum(i["counters"].get(c, 0) for c in counters)
                * bounds.call_seconds(core, i["rows"], i["bucket"], d, heads,
                                      itemsize) for i in t["items"])
    if call is not None:
        device = t.get("calls", {}).get(call, 0.0)
    else:
        device = sum(s for name, s in t["kernels"].items()
                     if any(k in name for k in kernels))
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device
