"""EGT pairwise attention and the QK-only EdgeUpdate (counterpart of
tgt_tpu/ops/attention.py).

Semantics of the reference EGT_Attention / EdgeUpdate
(lib/tgt/layers/layers.py:15-130):

  H_hat[b,l,m,h] = (Q[b,l,:,h] . K[b,m,:,h]) * d^-0.5 + E[b,l,m,h]
  A = softmax_m(H_hat + mask) * sigmoid(G + mask)            (gated softmax)
  node out = lin_O_h( einsum(A, V) [* log1p(sum_m gates)] )  (degree scaler)
  edge out = lin_O_e(H_hat)

The feature axis splits as (dot_dim, num_heads) with the head index fastest,
as the reference's ``.view(b, N, dot, heads)`` does. Source dropout adds
MASK_VALUE to whole source columns, a (b, 1, N, 1) draw (per row block
from a tuple of generators: ``ops/common.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tgt_torch.core.graph import MASK_VALUE
from tgt_torch.ops.common import Generators, layernorm, linear, rand


class EGTAttention(nn.Module):
    def __init__(self, node_width: int, edge_width: int, num_heads: int,
                 edge_update: bool = True, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.edge_update = edge_update
        self.mha_ln_h = nn.LayerNorm(node_width, device=device)
        self.mha_ln_e = nn.LayerNorm(edge_width, device=device)
        self.lin_QKV = nn.Linear(node_width, node_width * 3, device=device)
        self.lin_EG = nn.Linear(edge_width, num_heads * 2, device=device)
        self.lin_O_h = nn.Linear(node_width, node_width, device=device)
        if edge_update:
            self.lin_O_e = nn.Linear(num_heads, edge_width, device=device)

    def forward(self, h: torch.Tensor, e: torch.Tensor, mask: torch.Tensor,
                *, scale_degree: bool = True, source_dropout: float = 0.0,
                deterministic: bool = True,
                generator: Generators = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Gated pairwise attention -> (node_update, edge_update or None)."""
        b, n, node_width = h.shape
        heads = self.num_heads
        dot_dim = node_width // heads
        scale = dot_dim ** -0.5

        h_ln = layernorm(self.mha_ln_h, h)
        e_ln = layernorm(self.mha_ln_e, e)
        q, k, v = linear(self.lin_QKV, h_ln).chunk(3, dim=-1)
        e_bias, g_bias = linear(self.lin_EG, e_ln).chunk(2, dim=-1)

        if source_dropout > 0.0 and not deterministic:
            drop = rand((b, 1, n, 1), generator, h.device) < source_dropout
            mask = mask + drop.to(mask.dtype) * MASK_VALUE

        q = q.reshape(b, n, dot_dim, heads) * scale
        k = k.reshape(b, n, dot_dim, heads)
        v = v.reshape(b, n, dot_dim, heads)

        gates = torch.sigmoid(g_bias + mask)
        h_hat = torch.einsum("bldh,bmdh->blmh", q, k) + e_bias
        a = torch.softmax(h_hat + mask, dim=2) * gates
        v_att = torch.einsum("blmh,bmdh->bldh", a, v)
        if scale_degree:
            # (b, l, 1, h) broadcasts over v_att's dot_dim axis
            v_att = v_att * torch.log1p(gates.sum(dim=2, keepdim=True))

        h_out = linear(self.lin_O_h, v_att.reshape(b, n, node_width))
        e_out = linear(self.lin_O_e, h_hat) if self.edge_update else None
        return h_out, e_out


class EdgeUpdate(nn.Module):
    """QK-only edge update, the last layer of edge-ended stacks
    (reference: lib/tgt/layers/layers.py:87-130)."""

    def __init__(self, node_width: int, edge_width: int, num_heads: int,
                 device=None):
        super().__init__()
        self.num_heads = num_heads
        self.mha_ln_h = nn.LayerNorm(node_width, device=device)
        self.mha_ln_e = nn.LayerNorm(edge_width, device=device)
        self.lin_QK = nn.Linear(node_width, node_width * 2, device=device)
        self.lin_E = nn.Linear(edge_width, num_heads, device=device)
        self.lin_O_e = nn.Linear(num_heads, edge_width, device=device)

    def forward(self, h: torch.Tensor, e: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (h unchanged, e_out)."""
        b, n, node_width = h.shape
        heads = self.num_heads
        dot_dim = node_width // heads
        scale = dot_dim ** -0.5

        h_ln = layernorm(self.mha_ln_h, h)
        e_ln = layernorm(self.mha_ln_e, e)
        q, k = linear(self.lin_QK, h_ln).chunk(2, dim=-1)
        e_bias = linear(self.lin_E, e_ln)
        q = q.reshape(b, n, dot_dim, heads) * scale
        k = k.reshape(b, n, dot_dim, heads)
        h_hat = torch.einsum("bldh,bmdh->blmh", q, k) + e_bias
        return h, linear(self.lin_O_e, h_hat)
