"""Selective rematerialisation: names on values, and the policies of
``remat_policy`` that say which of a checkpointed layer's values the
backward keeps instead of recomputing (counterpart of jax's
``checkpoint_name`` and of ``tgt_tpu/models/encoder.py:161-183``).

tgt_tpu's policies, and what the port saves for each:
- ``none``: nothing; the replay recomputes the whole layer.
- ``dots``: every matrix product (jax's ``dots_saveable``): the outputs of
  ``mm``, ``addmm``, ``bmm`` and ``baddbmm``, which ``linear`` and
  ``einsum`` lower to, kept by a selective-checkpoint policy
  (``torch.utils.checkpoint.create_selective_checkpoint_contexts``). The
  triplet kernels are not products here (as Pallas calls are not dots in
  jax), so the replay launches them again.
- ``tri_a``: the N^3 gated triplet attention weights of the plain path
  (``tgt_tpu/ops/triplet.py:363``); the kernel paths name nothing.
- ``proj``: the N^2 triplet projections q, k, v, bias and gate
  (``triplet.py:333-343``, ``ops/pallas/triplet_dense.py:744-749``).
- ``tri_va``: ``proj`` and the dense kernel's output
  (``triplet_dense.py:768``); on the plain path the same as ``proj``.

The named policies keep their values in a :class:`RematCache`, one per
checkpointed call, passed to the checkpointed function: its forward records
the named values in the order it makes them (:func:`checkpoint_name`,
:func:`saved_output`), and the replay takes them back in the same order.
The port runs eagerly, so a replay still runs every op upstream of a saved
value; it skips only what returns a saved value itself: the dense forward
kernel, whose output ``tri_va`` names (jax prunes it from the replay
because its only use is the saved value). A named value costs no copy: the
cache holds the forward's tensor.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, FrozenSet, List, Optional

import torch

REMAT_POLICIES = ("none", "dots", "tri_a", "proj", "tri_va")
POLICY_NAMES: Dict[str, FrozenSet[str]] = {
    "none": frozenset(), "dots": frozenset(),
    "tri_a": frozenset({"tri_a"}), "proj": frozenset({"tri_proj"}),
    "tri_va": frozenset({"tri_va", "tri_proj"})}

_state = threading.local()


class RematCache:
    """The named values of one checkpointed call: the first run of the
    function (the forward) records them, each later run (the backward's
    replay) takes them back in the same order."""

    def __init__(self, policy: str):
        self.names = POLICY_NAMES[policy]
        self.values: List[Optional[torch.Tensor]] = []
        self.runs = 0
        self.taken = 0

    @property
    def replaying(self) -> bool:
        return self.runs > 1

    def record(self, name: str, value: torch.Tensor) -> None:
        self.values.append(value.detach())

    def take(self) -> torch.Tensor:
        value, self.values[self.taken] = self.values[self.taken], None
        self.taken += 1
        return value


def cache_for(policy: str) -> Optional[RematCache]:
    """A fresh cache for one checkpointed call under ``policy``, or None
    where the policy names nothing."""
    return RematCache(policy) if POLICY_NAMES[policy] else None


@contextlib.contextmanager
def policy_scope(cache: Optional[RematCache]):
    """Run one run of a checkpointed function's body with ``cache`` (None:
    nothing is named) as the place of its named values."""
    before = getattr(_state, "cache", None)
    if cache is not None:
        cache.runs += 1
        cache.taken = 0
    _state.cache = cache
    try:
        yield
    finally:
        _state.cache = before


def _cache_naming(name: str) -> Optional[RematCache]:
    cache = getattr(_state, "cache", None)
    return cache if cache is not None and name in cache.names else None


class _Saved(torch.autograd.Function):
    """The replay's value of a named tensor: the forward's, with the
    gradient passed on to the tensor the replay computed."""

    @staticmethod
    def forward(ctx, x, saved):
        return saved.view_as(saved)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, named ``name``: in a layer whose policy saves the name, the
    forward records it and the replay gets the recorded tensor back."""
    cache = _cache_naming(name)
    if cache is None:
        return x
    if cache.replaying:
        return _Saved.apply(x, cache.take())
    cache.record(name, x)
    return x


def saved_output(name: str, compute: Callable[[], torch.Tensor]
                 ) -> torch.Tensor:
    """``compute()``, whose output is named ``name``: in a layer whose
    policy saves the name, the replay takes the forward's output instead of
    computing it again. For the forward of an autograd function, which
    makes its output without a gradient."""
    cache = _cache_naming(name)
    if cache is None:
        return compute()
    if cache.replaying:
        return cache.take()
    out = compute()
    cache.record(name, out)
    return out


@functools.cache
def _dot_ops():
    aten = torch.ops.aten
    return frozenset({aten.mm.default, aten.addmm.default, aten.bmm.default,
                      aten.baddbmm.default})


def _save(op, args) -> bool:
    """Whether the ``dots`` policy keeps the output of ``op`` on
    ``args``."""
    return op in _dot_ops()


@functools.cache
def context_fn(policy: str) -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for
    ``policy``: a selective-checkpoint policy for ``dots``, None for the
    others (their named values go through a :class:`RematCache`)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}")
    if policy != "dots":
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def keep(ctx, op, *args, **kwargs):
        if _save(op, args):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, keep)
