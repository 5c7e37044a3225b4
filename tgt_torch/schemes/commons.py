"""Shared task math of the PCQM schemes (counterpart of
tgt_tpu/schemes/commons.py). Ported: ``coords2dist``, ``add_coords_noise``,
``discrete_dist`` and ``discrete_dist_loss``; ``bins2dist`` and
``masked_l1`` come with the gap schemes (ROADMAP.md item 1i)."""
from __future__ import annotations

import torch


def coords2dist(coords: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) -> (..., N, N) pairwise distances (reference
    commons.py:6-8; the 1e-24 keeps the sqrt's gradient finite at 0)."""
    diff = coords[..., :, None, :] - coords[..., None, :, :]
    return torch.sqrt(torch.square(diff).sum(dim=-1) + 1e-24)


def add_coords_noise(coords: torch.Tensor, edge_mask: torch.Tensor,
                     noise_level: float, noise_smoothing: float,
                     generator: torch.Generator) -> torch.Tensor:
    """Smooth coordinate noise (reference commons.py:10-16): Gaussian noise
    propagated through softmax(-D / tau) so that nearby atoms move
    together. The noise is drawn from ``generator``."""
    noise = torch.randn(coords.shape, generator=generator, device=coords.device,
                        dtype=coords.dtype) * noise_level
    dist = coords2dist(coords) + (1.0 - edge_mask.to(coords.dtype)) * 1e9
    smooth = torch.softmax(-dist / noise_smoothing, dim=-1)
    return coords + smooth @ noise


def discrete_dist(dist: torch.Tensor, num_bins: int,
                  range_bins: float) -> torch.Tensor:
    """bin = clamp(trunc(d * (B-1) / range), 0, B-1), int64."""
    d = dist * ((num_bins - 1) / range_bins)
    return d.to(torch.int32).clamp(0, num_bins - 1).long()


def discrete_dist_loss(dist_logits: torch.Tensor, dist_targ: torch.Tensor,
                       mask: torch.Tensor, num_bins: int, range_bins: float,
                       reduce: bool = True) -> torch.Tensor:
    """Masked cross-entropy over distance bins (reference commons.py:25-48).

    dist_logits (b, N, N, B), dist_targ float distances (b, N, N), mask
    (b, N, N). The log-softmax runs in f32. reduce=True -> scalar mean over
    the valid pairs of the batch; else per-graph (b,)."""
    b = dist_logits.shape[0]
    targ = discrete_dist(dist_targ, num_bins, range_bins)
    logp = torch.log_softmax(dist_logits.float(), dim=-1)
    xent = -torch.gather(logp, -1, targ[..., None])[..., 0].reshape(b, -1)
    m = mask.to(xent.dtype).reshape(b, -1)
    if reduce:
        return (xent * m).sum() / (m.sum() + 1e-9)
    return (xent * m).sum(dim=1) / (m.sum(dim=1) + 1e-9)
