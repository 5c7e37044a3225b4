"""Shared task math of the PCQM schemes (counterpart of
tgt_tpu/schemes/commons.py). Ported so far: ``coords2dist``; the losses and
bins decoding come with the training slice (ROADMAP.md items 1g, 1i)."""
from __future__ import annotations

import torch


def coords2dist(coords: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) -> (..., N, N) pairwise distances (reference
    commons.py:6-8; the 1e-24 keeps the sqrt's gradient finite at 0)."""
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    return torch.sqrt(torch.square(diff).sum(dim=-1) + 1e-24)
