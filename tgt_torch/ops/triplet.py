"""Triplet interaction layers on the edge channel (counterpart of
tgt_tpu/ops/triplet.py).

Ported: gated and ungated triplet attention (``attention``,
``attention_ungated``), as ``_triplet_attention_impl`` in tgt_tpu
(reference lib/tgt/layers/triplet.py:179-322). For a pair (i, j) the "in"
direction attends over k through the edges (j, k), biased and gated by
(i, k); the "out" direction is the same computation on pair-transposed
K, V, bias, gate and mask.

The N^3 core (QK + bias, softmax over k, sigmoid gate, sum over k of a*V)
is ``ops/kernels/triplet_dense.triplet_dense`` with ``use_pallas='dense'``
(every published attention config): on the card the CUDA forward and
backward kernels joined by ``TripletDenseCore``, on the CPU their plain
versions. ``use_pallas=False`` takes the plain forward, differentiated by
autograd.

``lin_O`` is applied split: its (2W, W) weight, rows indexed (d, 2h), is
cut into the in-heads ``[:, :h]`` and out-heads ``[:, h:]`` and contracted
straight out of each direction's (b, j, i, d, h) output; one transpose of
axes 1 and 2 at the end restores (b, i, j, W).

The registry keeps all six reference variant names and accepts the
reference's ``tiangular_update`` typo; the variants not ported yet raise.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch import nn

from tgt_torch.ops.common import layernorm, linear
from tgt_torch.ops.kernels.triplet_dense import (triplet_dense,
                                                 triplet_dense_fwd_reference)


class TripletAttention(nn.Module):
    def __init__(self, edge_width: int, num_heads: int, gated: bool = True,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.gated = gated
        bias_dim = num_heads * 2 if gated else num_heads
        bias_name = "lin_EG" if gated else "lin_E"
        self.bias_name = bias_name
        self.tri_ln_e = nn.LayerNorm(edge_width, device=device)
        self.lin_QKV_in = nn.Linear(edge_width, edge_width * 3, device=device)
        self.add_module(f"{bias_name}_in",
                        nn.Linear(edge_width, bias_dim, device=device))
        self.lin_QKV_out = nn.Linear(edge_width, edge_width * 3, device=device)
        self.add_module(f"{bias_name}_out",
                        nn.Linear(edge_width, bias_dim, device=device))
        self.lin_O = nn.Linear(edge_width * 2, edge_width, device=device)

    def forward(self, e: torch.Tensor, mask: torch.Tensor, *,
                attention_dropout: float = 0.0, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                use_pallas=False) -> torch.Tensor:
        if attention_dropout > 0.0 and not deterministic:
            raise NotImplementedError(
                "triplet attention dropout is not ported yet (ROADMAP.md "
                "item 2c, the rate > 0 branch of the dense kernel)")
        if use_pallas == "dense":
            core = triplet_dense
        elif use_pallas is False or use_pallas is None:
            core = triplet_dense_fwd_reference
        else:
            raise NotImplementedError(
                f"use_pallas={use_pallas!r}: tgt_tpu's legacy fused kernel "
                f"is not ported yet (ROADMAP.md item 2f)")

        b, n, _, w = e.shape
        h = self.num_heads
        d = w // h
        scale = d ** -0.5
        e_ln = layernorm(self.tri_ln_e, e)
        # torch weight (W_out, 2W) -> tgt_tpu's (2W, W_out) -> (d, 2h, W_out)
        w_o = self.lin_O.weight.to(e.dtype).t().reshape(d, 2 * h, -1)

        def direction(which: str, w_dir: torch.Tensor,
                      transpose_pair: bool) -> torch.Tensor:
            qkv = linear(getattr(self, f"lin_QKV_{which}"), e_ln)
            q, k, v = (t.reshape(b, n, n, d, h) for t in qkv.chunk(3, dim=-1))
            q = q * scale
            eg = linear(getattr(self, f"{self.bias_name}_{which}"), e_ln)
            e_b, g_b = eg.chunk(2, dim=-1) if self.gated else (eg, None)
            m = mask
            if transpose_pair:
                k = k.transpose(1, 2)
                v = v.transpose(1, 2)
                e_b = e_b.transpose(1, 2)
                g_b = None if g_b is None else g_b.transpose(1, 2)
                m = mask.transpose(1, 2)
            bias = e_b + m
            gate = None if g_b is None else g_b + m
            va = core(q, k, v, bias, gate)                  # (b, j, i, d, h)
            return torch.einsum("bjidh,dhw->bjiw", va, w_dir)

        out_t = (direction("in", w_o[:, :h], False)
                 + direction("out", w_o[:, h:], True))
        return out_t.transpose(1, 2) + self.lin_O.bias.to(e.dtype)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

TRIPLET_VARIANTS = ("aggregate", "aggregate_ungated", "attention",
                    "attention_ungated", "triangular_update", "axial_attention")

# variant -> the ROADMAP.md item that ports it
_NOT_PORTED = {
    "aggregate": "1h (with kernels 2d/2e)",
    "aggregate_ungated": "1h (with kernels 2d/2e)",
    "triangular_update": "1h",
    "axial_attention": "1h",
}


def _canon(variant: str) -> str:
    # accept the reference's registry typo (lib/tgt/layers/triplet.py:15)
    if variant == "tiangular_update":
        return "triangular_update"
    if variant not in TRIPLET_VARIANTS:
        raise ValueError(f"invalid triplet variant: {variant}")
    return variant


def get_triplet_module(variant: str) -> Callable[..., nn.Module]:
    """Constructor ``(edge_width, num_heads, device=None) -> nn.Module`` of
    a triplet variant."""
    variant = _canon(variant)
    if variant in _NOT_PORTED:
        raise NotImplementedError(
            f"triplet variant {variant!r} is not ported yet (ROADMAP.md item "
            f"{_NOT_PORTED[variant]})")
    return functools.partial(TripletAttention, gated=variant == "attention")
