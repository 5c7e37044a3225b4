"""AlphaFold 3's triangle updates of the pair representation and its single
attention with pair bias (Abramson et al., Nature 630:493, 2024,
Supplementary Algorithms 12-15 and 24), for the Pairformer
(``models/pairformer.py``) and the Evoformer (``models/evoformer.py``).
``tgt_tpu`` has no counterpart.

- :class:`TriangleMultiplication` (Algorithms 12, 13): gated projections
  a, b of the normalised pair, masked by the pair mask, contracted over
  the third node by :func:`triangle_contract` (one batched matrix product
  per channel through cuBLAS), normalised, projected and gated.

- :class:`TriangleAttention` (Algorithms 14, 15) runs on the dense triplet
  core, ``out[b, r, c] = sum_k softmax_k(q[c, r].k[r, k] + bias[c, k])
  v[r, k]`` (``ops/kernels/triplet_dense.py``), ungated, with AlphaFold's
  gate applied to its output. Around the starting node (``a_ijk =
  softmax_k(q_ij.k_ik + b_jk)``, values ``v_ik``) the core takes q
  pair-transposed and k, v and the bias as they are, and its output is
  (i, j); around the ending node (``softmax_k(q_ij.k_kj + b_ki)``, values
  ``v_kj``) it takes k, v and the bias pair-transposed, as
  ``TripletAttention``'s "out" direction does, and its output is (j, i).
  ``use_pallas='dense'`` takes ``triplet_dense`` (the CUDA kernels on the
  card, their plain versions on the CPU); otherwise the plain forward,
  differentiated by autograd. Keys past a structure's tokens get -1e9.
- :class:`AttentionPairBias` (Algorithm 24, without the conditioning of
  the diffusion module): multi-head attention over the tokens with an
  additive bias projected from the normalised pair and a sigmoid gate on
  its output, through ``F.scaled_dot_product_attention``.

Head layouts: the triangle attention's q, k, v and gate split their
``d * H`` channels as (d, h), the core's layout; the single attention's
``H * c`` channels as (h, c).

``bias=True`` gives AlphaFold 2's versions of both (Jumper et al., Nature
596:583, 2021, Supplementary Algorithms 11-14), whose projections carry
biases: the triangle multiplication's a, b, gates and output, the triangle
attention's gate and output. AlphaFold 3's are bias-free (the default).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tgt_torch.ops.common import layernorm, linear
from tgt_torch.ops.kernels.triplet_dense import (triplet_dense,
                                                 triplet_dense_fwd_reference)

MASK_VALUE = -1e9


def triangle_contract(a: torch.Tensor, b: torch.Tensor,
                      outgoing: bool) -> torch.Tensor:
    """(b, i, j, c): ``sum_k a_ik b_jk`` (outgoing edges) or ``sum_k a_ki
    b_kj`` (incoming), channel by channel, as one batched matrix product."""
    if outgoing:
        return torch.einsum("bikc,bjkc->bijc", a, b)
    return torch.einsum("bkic,bkjc->bijc", a, b)


class TriangleMultiplication(nn.Module):
    def __init__(self, pair_width: int, hidden: int, outgoing: bool,
                 bias: bool = False, device=None):
        super().__init__()
        self.outgoing = outgoing
        self.ln_in = nn.LayerNorm(pair_width, device=device)
        # a's gate, a, b's gate, b
        self.lin_ab = nn.Linear(pair_width, 4 * hidden, bias=bias,
                                device=device)
        self.lin_g = nn.Linear(pair_width, pair_width, bias=bias,
                               device=device)
        self.ln_out = nn.LayerNorm(hidden, device=device)
        self.lin_out = nn.Linear(hidden, pair_width, bias=bias,
                                 device=device)

    def forward(self, z: torch.Tensor, pair_mask: torch.Tensor
                ) -> torch.Tensor:
        """``pair_mask`` (b, n, n, 1) in z's dtype."""
        x = layernorm(self.ln_in, z)
        ag, a, bg, b = linear(self.lin_ab, x).chunk(4, dim=-1)
        a = torch.sigmoid(ag) * a * pair_mask
        b = torch.sigmoid(bg) * b * pair_mask
        p = triangle_contract(a, b, self.outgoing)
        g = torch.sigmoid(linear(self.lin_g, x))
        return g * linear(self.lin_out, layernorm(self.ln_out, p))


class TriangleAttention(nn.Module):
    def __init__(self, pair_width: int, num_heads: int, head_width: int,
                 starting: bool, bias: bool = False, device=None):
        super().__init__()
        self.starting = starting
        self.num_heads, self.head_width = num_heads, head_width
        inner = num_heads * head_width
        self.ln = nn.LayerNorm(pair_width, device=device)
        self.lin_QKV = nn.Linear(pair_width, 3 * inner, bias=False,
                                 device=device)
        self.lin_B = nn.Linear(pair_width, num_heads, bias=False,
                               device=device)
        self.lin_G = nn.Linear(pair_width, inner, bias=bias, device=device)
        self.lin_O = nn.Linear(inner, pair_width, bias=bias, device=device)

    def forward(self, z: torch.Tensor, key_bias: torch.Tensor, *,
                use_pallas=False) -> torch.Tensor:
        """``key_bias`` (b, 1, n, 1): 0 at a token, -1e9 past the
        structure's tokens, in z's dtype."""
        b, n, _, _ = z.shape
        h, d = self.num_heads, self.head_width
        x = layernorm(self.ln, z)
        q, k, v = (t.reshape(b, n, n, d, h)
                   for t in linear(self.lin_QKV, x).chunk(3, dim=-1))
        q = q * d ** -0.5
        bias = linear(self.lin_B, x)
        if self.starting:
            q = q.transpose(1, 2)
        else:
            k, v, bias = (t.transpose(1, 2) for t in (k, v, bias))
        bias = bias + key_bias
        if use_pallas == "dense":
            va = triplet_dense(q, k, v, bias.contiguous())
        else:
            va = triplet_dense_fwd_reference(q, k, v, bias)
        o = va if self.starting else va.transpose(1, 2)
        g = torch.sigmoid(linear(self.lin_G, x)).reshape(b, n, n, d, h)
        return linear(self.lin_O, (o * g).reshape(b, n, n, d * h))


class AttentionPairBias(nn.Module):
    def __init__(self, single_width: int, pair_width: int, num_heads: int,
                 head_width: int, device=None):
        super().__init__()
        self.num_heads, self.head_width = num_heads, head_width
        inner = num_heads * head_width
        self.ln_s = nn.LayerNorm(single_width, device=device)
        self.lin_Q = nn.Linear(single_width, inner, device=device)
        self.lin_KV = nn.Linear(single_width, 2 * inner, bias=False,
                                device=device)
        self.ln_z = nn.LayerNorm(pair_width, device=device)
        self.lin_B = nn.Linear(pair_width, num_heads, bias=False,
                               device=device)
        self.lin_G = nn.Linear(single_width, inner, bias=False, device=device)
        self.lin_O = nn.Linear(inner, single_width, bias=False, device=device)

    def forward(self, s: torch.Tensor, z: torch.Tensor,
                key_bias: torch.Tensor) -> torch.Tensor:
        """``key_bias`` (b, 1, n, 1) as for :class:`TriangleAttention`."""
        b, n, _ = s.shape
        h, c = self.num_heads, self.head_width
        a = layernorm(self.ln_s, s)
        q = linear(self.lin_Q, a).reshape(b, n, h, c).transpose(1, 2)
        k, v = (t.reshape(b, n, h, c).transpose(1, 2)
                for t in linear(self.lin_KV, a).chunk(2, dim=-1))
        bias = linear(self.lin_B, layernorm(self.ln_z, z)).permute(0, 3, 1, 2)
        bias = bias + key_bias.reshape(b, 1, 1, n)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        o = o.transpose(1, 2).reshape(b, n, h * c)
        return linear(self.lin_O, o * torch.sigmoid(linear(self.lin_G, a)))
