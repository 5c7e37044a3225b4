"""Pre-LN feed-forward block with GLU-family activations (counterpart of
tgt_tpu/ops/ffn.py).

Reference: lib/tgt/layers/layers.py:134-160 — LN -> W1 (width*mult*act_mul)
-> activation -> dropout -> W2, with ``inner = round(width * multiplier)``.

:class:`Transition` is AlphaFold 3's SwiGLU transition (Abramson et al.
2024, Supplementary Algorithm 11): LN -> two bias-free projections a, b to
``multiplier * width`` -> swish(a) * b -> a bias-free projection back, with
no dropout.
"""
from __future__ import annotations

import torch
from torch import nn

from tgt_torch.ops.activations import _swiglu, get_activation
from tgt_torch.ops.common import Generators, dropout, layernorm, linear


class FFN(nn.Module):
    def __init__(self, width: int, multiplier: float = 1.0,
                 activation: str = "gelu", device=None):
        super().__init__()
        _, act_mul = get_activation(activation)
        inner = round(width * multiplier)
        self.activation = activation
        self.ffn_ln = nn.LayerNorm(width, device=device)
        self.lin_W1 = nn.Linear(width, inner * act_mul, device=device)
        self.lin_W2 = nn.Linear(inner, width, device=device)

    def forward(self, x: torch.Tensor, *, act_dropout: float = 0.0,
                deterministic: bool = True,
                generator: Generators = None) -> torch.Tensor:
        act_fn, _ = get_activation(self.activation)
        y = layernorm(self.ffn_ln, x)
        y = act_fn(linear(self.lin_W1, y))
        y = dropout(y, act_dropout, deterministic, generator)
        return linear(self.lin_W2, y)


class Transition(nn.Module):
    """AlphaFold 3's transition: ``lin_W1`` holds a then b, so that the
    swish of its first half gates its second (``activations._swiglu``)."""

    def __init__(self, width: int, multiplier: int = 4, device=None):
        super().__init__()
        self.ffn_ln = nn.LayerNorm(width, device=device)
        self.lin_W1 = nn.Linear(width, 2 * multiplier * width, bias=False,
                                device=device)
        self.lin_W2 = nn.Linear(multiplier * width, width, bias=False,
                                device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = linear(self.lin_W1, layernorm(self.ffn_ln, x))
        return linear(self.lin_W2, _swiglu(y))
