"""The arithmetic of the per-layer metrics that read the program's own
spans over the profiled span: rows of ``name``, ``t0`` and ``t1`` (ns),
``thread``, ``id``, ``parent`` (the innermost span open on the same
thread) and attributes, as the program's span recorder keeps them. Each
function returns None where the rows hold nothing to read."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

Row = Dict


def _ms(row: Row) -> float:
    return (row["t1"] - row["t0"]) / 1e6


def _named(rows: List[Row], name: str) -> List[Row]:
    return [r for r in rows if r["name"] == name]


def outermost(rows: List[Row], name: str) -> List[Tuple[Row, List[Row]]]:
    """Each row named ``name`` with no ancestor of that name, with every
    row under it (itself included), in the order of the rows."""
    by_id = {r["id"]: r for r in rows}
    groups: Dict[int, Tuple[Row, List[Row]]] = {}
    for r in rows:
        top, up = None, r
        while up is not None:
            if up["name"] == name:
                top = up
            up = by_id.get(up["parent"])
        if top is not None:
            groups.setdefault(top["id"], (top, []))[1].append(r)
    return list(groups.values())


def _requests(rows: List[Row]) -> List[Tuple[float, float]]:
    """(duration ms, copy-back ms) of each request: an outermost
    ``serve.predict`` and the ``serve.copy_back`` spans under it."""
    return [(_ms(top), sum(_ms(r) for r in under
                           if r["name"] == "serve.copy_back"))
            for top, under in outermost(rows, "serve.predict")]


def serve_host_ms(rows: List[Row]) -> Optional[float]:
    """The mean over requests of the request's time less its wait for the
    card in the copy back."""
    reqs = _requests(rows)
    if not reqs:
        return None
    return sum(total - back for total, back in reqs) / len(reqs)


def serve_wait_ms(rows: List[Row]) -> Optional[float]:
    """The mean over requests of their copy back: the host waiting on the
    card."""
    reqs = _requests(rows)
    if not reqs:
        return None
    return sum(back for _, back in reqs) / len(reqs)


def serve_row_fill(rows: List[Row]) -> Optional[float]:
    """100 x the rows of real molecules over the rows run, each times its
    draws, over the forwards."""
    fwd = _named(rows, "serve.forward")
    run = sum(r.get("rows_run", 0) for r in fwd)
    if run <= 0:
        return None
    return 100.0 * sum(r.get("rows_real", 0) for r in fwd) / run


def train_update_share(rows: List[Row]) -> Optional[float]:
    """100 x the host time of the optimizer updates over that of the
    steps."""
    steps = sum(_ms(r) for r in _named(rows, "train.step"))
    if steps <= 0:
        return None
    return 100.0 * sum(_ms(r) for r in _named(rows, "train.update")) / steps


def data_ms_per_molecule(rows: List[Row]) -> Optional[float]:
    """The host ms of the structural transforms and the collations over
    the molecules transformed."""
    transforms = _named(rows, "data.transform")
    if not transforms:
        return None
    total = sum(_ms(r) for r in transforms + _named(rows, "data.collate"))
    return total / len(transforms)
