"""The bf16 forward body shared by the dense and the legacy triplet
attention forward (``tgt_torch/csrc/triplet_fwd_mma.cuh``): its plain
version on head-major panels, and how many blocks the wrappers launch.

The body takes q, k and v as (b, h, nj, n, dp) panels with a head width dp
of 16 or 32 (``pad_head_dim`` pads a narrower head with zero columns) and
splits the rows j of each (b, h) into chunks (``j_chunks`` with
FWD_BLOCKS_PER_SM) so that the card has enough blocks.
"""
from __future__ import annotations

from typing import Optional

import torch

# blocks of the forward body resident on one SM at n <= 48 (its shared
# memory, 30 KB at d = 16, gated, allows seven): the chunks of j fill about
# one wave of them. No sum crosses blocks, so more chunks cost only the
# restaging of bias and gate.
FWD_BLOCKS_PER_SM = 8


def panel_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, gate: Optional[torch.Tensor],
                        scale: float, keep: Optional[torch.Tensor] = None,
                        dense: bool = True) -> torch.Tensor:
    """Plain version of the body on head-major panels: q, k, v (b, h, nj,
    n, d), bias and gate (b, h, n, n) or ``gate=None``, ``keep`` the (b, h,
    nj, n, n) float keep mask or None. In f32 math with the max per row,
    rounded to q's dtype where the body rounds:

    - ``dense`` (the dense pair, ``_fwd_kernel``): the unnormalised weights
      exp(s - max) times sigmoid(gate) and ``keep`` are rounded before the
      product with V, which is then multiplied by 1 / max(sum, 1e-30);
    - else (the legacy pair): the normalised weights times sigmoid(gate)
      are rounded before the product, and the sum is not clamped.

    Returns the (b, h, nj, n, d) output in q's dtype."""
    s = (torch.einsum("bhjid,bhjkd->bhjik", q.float(), k.float()) * scale
         + bias.float()[:, :, None])
    e = torch.exp(s - s.amax(-1, keepdim=True))
    total = e.sum(-1, keepdim=True)
    a = e if dense else e * (1.0 / total)
    if gate is not None:
        a = a * torch.sigmoid(gate.float())[:, :, None]
    if keep is not None:
        a = a * keep
    dt = q.dtype
    out = torch.einsum("bhjik,bhjkd->bhjid", a.to(dt).float(), v.float())
    if dense:
        out = out * (1.0 / total.clamp_min(1e-30))
    return out.to(dt)
