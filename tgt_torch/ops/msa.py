"""AlphaFold 2's MSA track (Jumper et al., Nature 596:583, 2021,
doi:10.1038/s41586-021-03819-2, Supplementary Algorithms 7, 8, 10 and 19),
for the Evoformer (``models/evoformer.py``). ``tgt_tpu`` has no
counterpart.

An MSA representation is (b, s, r, c): s sequences of r residues. Its mask
``msa_mask`` (b, s, r) is 1 at every real position, gaps included, and 0
at padding.

- :class:`MSARowAttentionWithPairBias` (Algorithm 7): gated self-attention
  along each sequence, ``softmax_j(q_si.k_sj / sqrt(c) + b_ij)``, with
  ``b_ij`` projected from the normalised pair. It runs through
  ``F.scaled_dot_product_attention`` with the (h, r, r) bias broadcast over
  the s rows (a stride-0 view: the forward never writes the bias per row).
  Keys past the structure's residues get -1e9; a padded sequence row
  attends like a real one and is masked wherever it would be read.
- :class:`MSAColumnAttention` (Algorithm 8): the same along each column,
  over the sequences, with no pair bias and keys masked by ``msa_mask``.
- :class:`MSAColumnGlobalAttention` (Algorithm 19): per column, one query
  per head, the masked mean over the sequences of the projected MSA, and
  one key and one value shared by every head; a sigmoid gate per sequence.
- :class:`OuterProductMeanUpdate` (Algorithm 10): LN, masked projections
  a, b (c each), then :class:`OuterProductMean`: ``sum_s a_si (x) b_sj``
  as one batched matrix product over s through cuBLAS, the output
  projection, and the division by ``1e-3 + sum_s mask_si mask_sj`` after
  it, as AlphaFold's code and OpenFold divide.

Head layouts: q, k, v, the gate and the output split their ``H * c``
channels as (h, c). On the card every attention's SDPA call is pinned to
the memory-efficient backend (``FUSED``), the fused one that takes an
additive mask and gives its gradient: a call it does not take raises,
instead of running the math backend's s * h * r^2 scores.

Counters (``CALLS``): the calls of each op by name (``row_attention``,
``column_attention``, ``global_column_attention``, ``outer_product_mean``)
and, for each SDPA call, the backend it took (``row_attention.<backend>``,
``column_attention.<backend>``), read by the benchmark's spans.
"""
from __future__ import annotations

from collections import Counter
from contextlib import nullcontext

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend, sdpa_kernel

from tgt_torch.ops.common import layernorm, linear

MASK_VALUE = -1e9
OPM_EPS = 1e-3          # Algorithm 10's 1e-3 beside the count of sequences
GLOBAL_EPS = 1e-10      # the masked mean's, as OpenFold's global attention

# the SDPA backend an MSA attention takes on the card: the fused one that
# takes an additive mask and gives its gradient
FUSED = (SDPBackend.EFFICIENT_ATTENTION,)

CALLS: Counter = Counter()


def _backend_name(q, k, v, mask) -> str:
    """The backend SDPA chooses for these inputs under the current pin."""
    return SDPBackend(torch._fused_sdp_choice(q, k, v, mask)).name.lower()


def attend(op: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """``F.scaled_dot_product_attention`` of (B, h, L, c) inputs with an
    additive ``mask`` broadcast to (B, h, L, L), pinned on the card to
    ``FUSED``; counts the backend under ``op``."""
    with (sdpa_kernel(list(FUSED)) if q.is_cuda else nullcontext()):
        CALLS[f"{op}.{_backend_name(q, k, v, mask)}"] += 1
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


class _GatedHeads(nn.Module):
    """q, k, v (bias-free), the gate and the output projection (both with
    biases) of Algorithms 7 and 8."""

    def __init__(self, width: int, num_heads: int, head_width: int,
                 device=None):
        super().__init__()
        self.num_heads, self.head_width = num_heads, head_width
        inner = num_heads * head_width
        self.lin_QKV = nn.Linear(width, 3 * inner, bias=False, device=device)
        self.lin_G = nn.Linear(width, inner, device=device)
        self.lin_O = nn.Linear(inner, width, device=device)

    def heads(self, x: torch.Tensor):
        """q, k, v of x (..., width), each (..., h, c); SDPA scales the
        logits by 1/sqrt(c)."""
        h, c = self.num_heads, self.head_width
        return tuple(t.unflatten(-1, (h, c))
                     for t in linear(self.lin_QKV, x).chunk(3, dim=-1))

    def out(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """The gated output projection of o (..., h, c) gated by x."""
        o = o.flatten(-2) * torch.sigmoid(linear(self.lin_G, x))
        return linear(self.lin_O, o)


class MSARowAttentionWithPairBias(_GatedHeads):
    def __init__(self, msa_width: int, pair_width: int, num_heads: int,
                 head_width: int, device=None):
        super().__init__(msa_width, num_heads, head_width, device=device)
        self.ln_m = nn.LayerNorm(msa_width, device=device)
        self.ln_z = nn.LayerNorm(pair_width, device=device)
        self.lin_B = nn.Linear(pair_width, num_heads, bias=False,
                               device=device)

    def forward(self, m: torch.Tensor, z: torch.Tensor,
                key_bias: torch.Tensor) -> torch.Tensor:
        """m (b, s, r, c_m), z (b, r, r, c_z); ``key_bias`` (b, r): 0 at a
        residue, -1e9 past the structure's residues, in m's dtype."""
        CALLS["row_attention"] += 1
        b, s, r, _ = m.shape
        x = layernorm(self.ln_m, m)
        q, k, v = (t.permute(0, 1, 3, 2, 4) for t in self.heads(x))
        bias = linear(self.lin_B, layernorm(self.ln_z, z)).permute(0, 3, 1, 2)
        # (b, h, r, r), contiguous: SDPA reads it through a stride-0 view
        bias = (bias + key_bias[:, None, None, :]).contiguous()
        o = torch.stack([
            attend("row_attention", q[i], k[i], v[i],
                   bias[i, None].expand(s, -1, -1, -1)) for i in range(b)])
        return self.out(x, o.permute(0, 1, 3, 2, 4))


class MSAColumnAttention(_GatedHeads):
    def __init__(self, msa_width: int, num_heads: int, head_width: int,
                 device=None):
        super().__init__(msa_width, num_heads, head_width, device=device)
        self.ln_m = nn.LayerNorm(msa_width, device=device)

    def forward(self, m: torch.Tensor, msa_mask: torch.Tensor
                ) -> torch.Tensor:
        """m (b, s, r, c_m); ``msa_mask`` (b, s, r) in m's dtype."""
        CALLS["column_attention"] += 1
        b, s, r, _ = m.shape
        h = self.num_heads
        x = layernorm(self.ln_m, m)
        # (b, s, r, h, c) -> (b r, h, s, c)
        q, k, v = (t.permute(0, 2, 3, 1, 4).reshape(b * r, h, s, -1)
                   for t in self.heads(x))
        # (b r, 1, 1, s), contiguous: the card's SDPA wants the mask's
        # last stride 1
        keys = ((1.0 - msa_mask) * MASK_VALUE).transpose(1, 2).contiguous()
        mask = keys.view(b * r, 1, 1, s).expand(-1, h, s, -1)
        o = attend("column_attention", q, k, v, mask)
        o = o.reshape(b, r, h, s, -1).permute(0, 3, 1, 2, 4)
        return self.out(x, o)


class MSAColumnGlobalAttention(nn.Module):
    def __init__(self, msa_width: int, num_heads: int, head_width: int,
                 device=None):
        super().__init__()
        self.num_heads, self.head_width = num_heads, head_width
        inner = num_heads * head_width
        self.ln_m = nn.LayerNorm(msa_width, device=device)
        self.lin_Q = nn.Linear(msa_width, inner, bias=False, device=device)
        self.lin_KV = nn.Linear(msa_width, 2 * head_width, bias=False,
                                device=device)
        self.lin_G = nn.Linear(msa_width, inner, device=device)
        self.lin_O = nn.Linear(inner, msa_width, device=device)

    def forward(self, m: torch.Tensor, msa_mask: torch.Tensor
                ) -> torch.Tensor:
        """m (b, s, r, c_e); ``msa_mask`` (b, s, r) in m's dtype."""
        CALLS["global_column_attention"] += 1
        h, c = self.num_heads, self.head_width
        x = layernorm(self.ln_m, m)
        mask = msa_mask[..., None]
        # the masked mean over the sequences, then the query's projection
        mean = (x * mask).sum(1) / (mask.sum(1) + GLOBAL_EPS)      # (b, r, .)
        q = linear(self.lin_Q, mean).unflatten(-1, (h, c)) * c ** -0.5
        k, v = linear(self.lin_KV, x).chunk(2, dim=-1)           # (b, s, r, c)
        logits = torch.einsum("brhc,bsrc->brhs", q, k)
        logits = logits + ((1.0 - msa_mask) * MASK_VALUE).transpose(
            1, 2)[:, :, None, :]
        o = torch.einsum("brhs,bsrc->brhc", torch.softmax(logits, dim=-1), v)
        g = torch.sigmoid(linear(self.lin_G, x)).unflatten(-1, (h, c))
        return linear(self.lin_O, (g * o[:, None]).flatten(-2))


class OuterProductMean(torch.autograd.Function):
    """``(Linear(flatten(sum_s a_si (x) b_sj)) + bias) / norm_ij`` with its
    gradient. a, b (B, s, r, c), already masked; ``weight`` (c_z, c * c),
    ``bias`` (c_z,); ``norm`` (B, r, r, 1) gets no gradient. The sum over s
    is one batched matrix product, (r c) x s x (r c) per structure; its
    (i, c, j, e) output is laid out as (i, j, c e) for the projection. The
    backward keeps that product instead of recomputing it."""

    @staticmethod
    def forward(ctx, a, b, weight, bias, norm):
        B, s, r, c = a.shape
        outer = torch.matmul(a.reshape(B, s, r * c).transpose(1, 2),
                             b.reshape(B, s, r * c))       # (B, (i c), (j e))
        outer = outer.view(B, r, c, r, c).transpose(2, 3).reshape(
            B, r, r, c * c)
        ctx.save_for_backward(a, b, weight, norm, outer)
        return F.linear(outer, weight, bias) / norm

    @staticmethod
    def backward(ctx, grad):
        a, b, weight, norm, outer = ctx.saved_tensors
        B, s, r, c = a.shape
        gy = grad / norm
        flat = gy.reshape(-1, gy.shape[-1])
        g_weight = flat.t() @ outer.reshape(-1, c * c)
        g_bias = flat.sum(0)
        g_outer = (gy @ weight).view(B, r, r, c, c).transpose(2, 3).reshape(
            B, r * c, r * c)                                  # ((i c), (j e))
        g_a = torch.matmul(b.reshape(B, s, r * c), g_outer.transpose(1, 2))
        g_b = torch.matmul(a.reshape(B, s, r * c), g_outer)
        return (g_a.view_as(a), g_b.view_as(b), g_weight, g_bias, None)


class OuterProductMeanUpdate(nn.Module):
    def __init__(self, msa_width: int, pair_width: int, hidden: int,
                 device=None):
        super().__init__()
        self.ln = nn.LayerNorm(msa_width, device=device)
        self.lin_ab = nn.Linear(msa_width, 2 * hidden, device=device)
        self.lin_out = nn.Linear(hidden * hidden, pair_width, device=device)

    def forward(self, m: torch.Tensor, msa_mask: torch.Tensor
                ) -> torch.Tensor:
        """The pair update (b, r, r, c_z) of m (b, s, r, c_m);
        ``msa_mask`` (b, s, r) in m's dtype."""
        CALLS["outer_product_mean"] += 1
        mask = msa_mask[..., None]
        a, b = (t * mask for t in
                linear(self.lin_ab, layernorm(self.ln, m)).chunk(2, dim=-1))
        count = msa_mask.float()
        norm = torch.einsum("bsi,bsj->bij", count, count)[..., None] + OPM_EPS
        weight, bias = (p.to(m.dtype) for p in (self.lin_out.weight,
                                                 self.lin_out.bias))
        return OuterProductMean.apply(a, b, weight, bias, norm.to(m.dtype))
