"""What every run shares: the benchmark's files found by name, the device
record, the spans the benchmark keeps around its calls into the program,
the profiled span and its reduction, and the per-layer metric readers.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name that ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<mix>.json`` (whose ``driver`` names
``drivers/<driver>.py``), ``limits/<cell>.json`` and
``metrics/<metric>.py``.
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT_DIR = ROOT / ".h100bench_out"
CACHE_DIR = ROOT / ".h100bench_cache"

MARK = "h100bench."        # prefix of the benchmark's marks in a trace
CALL = MARK + "call."      # prefix of a marked entry point's range
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "tgt_tpu")


class Bench:
    """BENCHMARK.json and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT, here: Path = HERE):
        self.root, self.here = Path(root), Path(here)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return json.loads((self.here / "configs" / f"{name}.json").read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.here / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.here / "limits" / f"{cell}.json").read_text())

    def driver(self, name: str):
        return load_module(self.here / "drivers" / f"{name}.py",
                           f"h100bench_driver_{name}")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell])]

    def _reader(self, name: str):
        return load_module(self.here / "metrics" / f"{name}.py",
                           "h100bench_metric_" + name.replace(".", "_"))

    def marked_calls(self, cell: str) -> List[str]:
        """The program's entry points that the cell's per-layer metrics
        read the device time of (each reader's ``CALLS``)."""
        return sorted({c for m in self.per_layer(cell)
                       for c in getattr(self._reader(m["name"]), "CALLS", ())})

    def read_metrics(self, cell: str, record: dict) -> Dict[str, dict]:
        """Each per-layer metric of the cell that its reader finds
        something to read for; a reader that finds nothing returns None and
        its metric is left out."""
        out = {}
        for m in self.per_layer(cell):
            value = self._reader(m["name"]).read(record)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """The modules of JAX or the JAX package that this process holds,
    compared by whole top-level names."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout. The
    program's own CUDA and C++ builds go to ``tgt_torch/_build/``, also
    inside it."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE_DIR / sub)


class Spans:
    """Spans of the benchmark's calls into the program's layers, kept in
    memory: name, start and end on the host clock, thread, attributes."""

    def __init__(self):
        self.rows: List[dict] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, **attrs):
        """A span, also marked for the profiler when one is on
        (``h100bench.<name>``), so that a trace names what the host was
        doing."""
        from torch.profiler import record_function
        t0 = time.perf_counter()
        row = {"name": name, "t0": t0, "thread": threading.get_ident(),
               **attrs}
        try:
            with record_function(MARK + name):
                yield row
        finally:
            row["t1"] = time.perf_counter()
            with self._lock:
                self.rows.append(row)

    def wrap(self, name: str, fn: Callable):
        """``fn`` with a span around every call."""
        def wrapped(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def write(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.rows, default=float))


@contextmanager
def marked_calls(entries):
    """For the block, each entry point ``"module:Class.method"`` (a static
    method, as an autograd Function's ``forward`` and ``backward`` are)
    runs inside a range named ``h100bench.call.Class.method``, so that a
    trace credits it with every operation it launches on the device."""
    from torch.profiler import record_function
    saved = []

    def marked(fn, name):
        def call(*args, **kwargs):
            with record_function(CALL + name):
                return fn(*args, **kwargs)
        return call

    try:
        for entry in entries:
            module, qual = entry.split(":")
            owner_name, attr = qual.rsplit(".", 1)
            owner = importlib.import_module(module)
            for part in owner_name.split("."):
                owner = getattr(owner, part)
            original = owner.__dict__[attr]
            if not isinstance(original, staticmethod):
                raise TypeError(f"{entry} is not a static method")
            saved.append((owner, attr, original))
            setattr(owner, attr, staticmethod(marked(original.__func__,
                                                     qual)))
        yield
    finally:
        for owner, attr, original in reversed(saved):
            setattr(owner, attr, original)


def call_seconds(device_events) -> Dict[str, float]:
    """Device seconds of the operations launched inside each marked entry
    point's calls, by ``Class.method``. The profiler marks each call's
    range on the device timeline, over its stream, from the start of the
    first operation the call launched to the end of the last; the
    operations of that stream inside the mark are the call's."""
    marks, ops = [], []
    for e in device_events:
        if e.name.startswith(CALL):
            marks.append(e)
        elif not (getattr(e, "is_user_annotation", False)
                  or e.name.startswith(MARK)):
            ops.append(e)
    ops.sort(key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in ops]
    out: Dict[str, float] = {}
    for m in marks:
        t0, t1 = m.time_range.start, m.time_range.end
        stream = getattr(m, "device_resource_id", None)
        us = 0.0
        for e in ops[bisect.bisect_left(starts, t0):
                     bisect.bisect_right(starts, t1)]:
            if e.time_range.end <= t1 and getattr(
                    e, "device_resource_id", None) == stream:
                us += e.time_range.end - e.time_range.start
        name = m.name[len(CALL):]
        out[name] = out.get(name, 0.0) + us / 1e6
    return out


def kernel_counters() -> Dict[str, tuple]:
    """The launch counters of the program's kernel wrappers, by name."""
    from tgt_torch.ops.kernels import triplet_aggregate as ta
    from tgt_torch.ops.kernels import triplet_attention as tl
    from tgt_torch.ops.kernels import triplet_dense as td
    out = {}
    for w, attrs in ((td.triplet_dense_fwd, ("launches", "dropout_launches")),
                     (td.triplet_dense_bwd, ("launches", "dropout_launches")),
                     (ta.triplet_aggregate_fwd, ("launches", "body_launches")),
                     (ta.triplet_aggregate_bwd, ("launches", "body_launches")),
                     (tl.triplet_attention_fwd, ("launches",)),
                     (tl.triplet_attention_bwd, ("launches",))):
        for a in attrs:
            out[f"{w.__name__}.{a}"] = (w, a)
    return out


def read_counters() -> Dict[str, int]:
    return {k: int(getattr(w, a)) for k, (w, a) in kernel_counters().items()}


def counter_delta(before: Dict[str, int], after: Dict[str, int]):
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def device_record(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return res.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


@contextmanager
def profiled(enabled: bool, device):
    """torch.profiler over the block, host and device, when ``enabled``
    and on the card; yields a holder whose ``prof`` is the profiler."""
    holder = {"prof": None}
    if not enabled or device.type != "cuda":
        yield holder
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(MARK + "traced_span"):
            yield holder
            torch.cuda.synchronize()
    holder["prof"] = prof


def reduce_trace(prof) -> Optional[dict]:
    """The traced span's device activity: its length, the seconds in which
    an operation ran on the device (the union of their intervals), kernel
    launches, device seconds per kernel name and per marked entry point
    (``marked_calls``), the operations that took most time, and the
    longest idle gaps, each named by the benchmark's span and the
    innermost host operation running at its middle."""
    from torch.autograd import DeviceType
    events = prof.events()
    span = [e for e in events if e.name == MARK + "traced_span"
            and e.device_type == DeviceType.CPU]
    if not span:
        return None
    t0, t1 = span[0].time_range.start, span[0].time_range.end
    device, host, on_device = [], [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            on_device.append(e)
            # annotations on the device timeline mark host ranges, not work
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(MARK)):
                device.append(e)
        elif e.device_type == DeviceType.CPU and e is not span[0]:
            host.append(e)
    intervals = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1))
                       for e in device)
    busy, gaps, cursor = 0.0, [], t0
    for s, f in intervals:
        if f <= s:
            continue
        if s > cursor:
            gaps.append((cursor, s))
        if f > cursor:
            busy += f - max(s, cursor)
            cursor = f
    if cursor < t1:
        gaps.append((cursor, t1))
    kernels: Dict[str, float] = {}
    launches = 0
    for e in device:
        dur = (e.time_range.end - e.time_range.start) / 1e6
        kernels[e.name] = kernels.get(e.name, 0.0) + dur
        if not e.name.startswith(("Memcpy", "Memset")):
            launches += 1
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)

    def host_op(mid):
        inner = outer = None
        for e in host:
            if not e.time_range.start <= mid <= e.time_range.end:
                continue
            length = e.time_range.elapsed_us()
            if e.name.startswith(MARK):
                if outer is None or length > outer.time_range.elapsed_us():
                    outer = e
            elif inner is None or length < inner.time_range.elapsed_us():
                inner = e
        return " / ".join([outer.name if outer else "outside the spans",
                           inner.name if inner else "Python"])

    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {"span_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "launches": launches, "kernels": kernels,
            "calls": call_seconds(on_device),
            "device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[host_op((a + b) / 2), (b - a) / 1e6]
                          for a, b in gaps[:10]]}


@contextmanager
def quiet():
    """The program's progress lines go to standard error, so that the
    result is the last line of standard output."""
    saved = sys.stdout
    sys.stdout = sys.stderr
    try:
        yield
    finally:
        sys.stdout = saved
