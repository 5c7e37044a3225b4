"""Activation registry, including the GLU family (counterpart of
tgt_tpu/ops/activations.py).

GLU variants split the last axis in half, gate the first half and multiply
the second (reference: lib/tgt/layers/activations.py:4-25). ``act_mul`` is
the width multiplier the FFN applies to its first projection (2 for GLU
variants, else 1). ``gelu`` is the exact erf form.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F


def _geglu(x: torch.Tensor) -> torch.Tensor:
    g, e = x.chunk(2, dim=-1)
    return e * F.gelu(g)


def _glu(x: torch.Tensor) -> torch.Tensor:
    g, e = x.chunk(2, dim=-1)
    return e * torch.sigmoid(g)


def _swiglu(x: torch.Tensor) -> torch.Tensor:
    g, e = x.chunk(2, dim=-1)
    return e * torch.sigmoid(g) * g


_GLU = {"geglu": _geglu, "glu": _glu, "swiglu": _swiglu}

_PLAIN = {
    "gelu": F.gelu,   # exact erf form (approximate='none')
    "relu": F.relu,
    "silu": F.silu,
    "elu": F.elu,
    "leaky_relu": F.leaky_relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softplus": F.softplus,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "hardswish": F.hardswish,
}


def get_activation(name: str) -> Tuple[Callable[[torch.Tensor], torch.Tensor], int]:
    """Return (fn, act_mul) for an activation name."""
    if name in _GLU:
        return _GLU[name], 2
    if name in _PLAIN:
        return _PLAIN[name], 1
    fn = getattr(F, name, None)
    if fn is None:
        raise ValueError(f"unknown activation: {name}")
    return fn, 1
