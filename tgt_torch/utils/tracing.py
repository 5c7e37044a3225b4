"""The port's span recorder: named host intervals of the serving, trainer
and data layers, recorded exactly while ``torch.profiler`` records
(``tgt_tpu`` has no counterpart).

    from tgt_torch.utils import tracing

    with tracing.span("serve.forward") as row:
        if row is not None:          # None while no profiler records
            row["rows_run"] = 160
        out = forward(feed, seeds)
    rows = tracing.recorded()        # a copy; reading clears nothing
    tracing.clear()

The switch is the profiler itself: a span records while a profiler runs
(``torch.profiler.profile``), so whoever traces the device traces the host
spans too, and there is no other switch. Off, a span reads one flag and
returns a shared do-nothing context: no row, no profiler range.

A row holds ``name``; ``t0`` and ``t1``, in ns on the clock the profiler
stamps its host events with (c10's ``getTime``: CLOCK_REALTIME on Linux,
which is ``time.time_ns()``), taken outside the span's profiler range so
that they bracket it; ``thread``; its ``id`` and its ``parent``'s (the
innermost span open on the same thread, or None); and the attributes, those
given to ``span`` and those the caller adds to the row it is given. A span
takes the ids in ``SHARED`` (``request``, ``step``) from its parent unless
it is given its own, so the spans of one request or step share them. The
newest ``MAX_ROWS`` rows are kept.

Off, keyword attributes would cost the call a dict: the port's call sites
pass none and set their attributes on the row, which is None while off.

On the main thread a span also runs inside
``torch.profiler.record_function("tgt_torch." + name)``, so that a trace
says which span the host was in. Spans of other threads (the data
loader's) are kept here only: a trace's host ranges carry their thread, but
a reading of the gaps by the range at their middle would credit a loader
span with the launching thread's time.

Exporters: ``tgt_torch.utils.profiling.trace`` writes the rows of its block
beside its Chrome trace, and ``python -m tgt_torch.profiling`` prints each
span's host time per step or forward.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import nullcontext
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_ROWS = 100_000
PREFIX = "tgt_torch."     # prefix of a span's profiler range
SHARED = ("request", "step")

_rows: deque = deque(maxlen=MAX_ROWS)
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_main = threading.main_thread().ident
_OFF = nullcontext()      # a span's shared do-nothing context while off


class _Span:
    __slots__ = ("name", "attrs", "row", "stack", "range")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> Dict:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        thread = threading.get_ident()
        parent = stack[-1] if stack else None
        row = {"name": self.name, "t0": time.time_ns(), "t1": None,
               "thread": thread, "id": next(_ids),
               "parent": None if parent is None else parent["id"]}
        if parent is not None:
            row.update((k, parent[k]) for k in SHARED if k in parent)
        row.update(self.attrs)
        self.row, self.stack, self.range = row, stack, None
        if thread == _main:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        stack.append(row)
        return row

    def __exit__(self, *exc) -> None:
        self.stack.pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.row["t1"] = time.time_ns()
        with _lock:
            _rows.append(self.row)


def span(name: str, **attrs):
    """A context manager around a block that yields its row while a
    profiler records, and None (recording nothing) while none does."""
    # set by torch while its profiler records
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def recorded() -> List[Dict]:
    """A copy of the rows kept, oldest first."""
    with _lock:
        return [dict(r) for r in _rows]


def clear() -> None:
    with _lock:
        _rows.clear()
