"""Pre-LN feed-forward block with GLU-family activations (counterpart of
tgt_tpu/ops/ffn.py).

Reference: lib/tgt/layers/layers.py:134-160 — LN -> W1 (width*mult*act_mul)
-> activation -> dropout -> W2, with ``inner = round(width * multiplier)``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from tgt_torch.ops.activations import get_activation
from tgt_torch.ops.common import dropout, layernorm, linear


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
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        act_fn, _ = get_activation(self.activation)
        y = layernorm(self.ffn_ln, x)
        y = act_fn(linear(self.lin_W1, y))
        y = dropout(y, act_dropout, deterministic, generator)
        return linear(self.lin_W2, y)
