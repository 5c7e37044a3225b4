"""Profiling and tracing utilities (counterpart of tgt_tpu/utils/profiling.py).

- ``trace(logdir)``: ``torch.profiler`` around a block, with the CPU and,
  when there is a card, the CUDA activities; writes a Chrome trace into
  ``logdir`` (open it in chrome://tracing or Perfetto), and beside it the
  rows of the port's spans recorded in the block (``tgt_torch.utils.
  tracing``: the serving, trainer and data layers);
- ``StepTimer``: wall time per step with a warm-up discard and summary
  statistics;
- ``flops_estimate``: the floating-point operations of one call, counted
  by PyTorch's ``FlopCounterMode``;
- ``count_params`` and ``model_summary`` (the one of
  ``tgt_torch.training.harness``).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from tgt_torch.training.harness import model_summary
from tgt_torch.utils import tracing

__all__ = ["trace", "StepTimer", "flops_estimate", "count_params",
           "model_summary"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write its Chrome trace to
    ``logdir/trace_<pid>_<ns>.json`` and the spans recorded in it to
    ``logdir/spans_<pid>_<ns>.json`` (a JSON list of ``tracing`` rows)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    start = time.time_ns()      # the spans' clock
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    stamp = f"{os.getpid()}_{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{stamp}.json"))
    rows = [r for r in tracing.recorded() if r["t0"] >= start]
    with open(os.path.join(logdir, f"spans_{stamp}.json"), "w") as f:
        json.dump(rows, f)


class StepTimer:
    """Wall-clock step timer with warmup discard and summary stats. On
    exit it waits for the CUDA device when the process has initialised
    one, as a JAX caller blocks until its result is ready."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {"mean_s": float("nan"), "steps": 0}
        ts = sorted(self.times)
        return {
            "mean_s": sum(ts) / len(ts),
            "p50_s": ts[len(ts) // 2],
            "min_s": ts[0],
            "max_s": ts[-1],
            "steps": len(ts),
        }


def flops_estimate(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Floating-point operations of one call ``fn(*args, **kwargs)``,
    which runs once, counted by ``torch.utils.flop_counter.FlopCounterMode``.

    It counts PyTorch's matrix-product-class operators only (matmul,
    addmm, bmm, convolution, scaled_dot_product_attention and their
    backwards), at 2 per multiply-add, as XLA's cost analysis counts a
    dot. Like that analysis of a ``pallas_call`` without a cost estimate
    (tgt_tpu passes none), it does not see the package's hand-written
    kernels: the triplet cores add nothing. ``bytes_accessed`` is NaN:
    XLA also counts bytes, PyTorch has no such count."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return {"flops": float(counter.get_total_flops()),
            "bytes_accessed": float("nan")}


def count_params(params: Any) -> int:
    """Elements of a module's state_dict, or of a state_dict or nested
    dict of tensors or arrays (tgt_tpu's params tree)."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    if isinstance(params, Mapping):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(count_params(v) for v in params)
    if isinstance(params, torch.Tensor):
        return params.numel()
    return int(np.size(params))
