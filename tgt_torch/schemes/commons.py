"""Shared task math of the PCQM schemes (counterpart of
tgt_tpu/schemes/commons.py): ``coords2dist``, ``add_coords_noise``,
``discrete_dist``, ``discrete_dist_loss``, ``bins2dist``, ``masked_l1``,
and ``stack_draws``, the feed of a draw-stacked MC forward."""
from __future__ import annotations

from typing import Dict, Optional

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
                       reduce: bool = True,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked cross-entropy over distance bins (reference commons.py:25-48).

    dist_logits (b, N, N, B), dist_targ float distances (b, N, N), mask
    (b, N, N). The log-softmax runs in f32. reduce=True -> scalar mean over
    the valid pairs of the batch, or the sum over them divided by ``count``
    (the valid pairs of every rank's batch: this rank's share of the
    global mean); else per-graph (b,)."""
    b = dist_logits.shape[0]
    targ = discrete_dist(dist_targ, num_bins, range_bins)
    logp = torch.log_softmax(dist_logits.float(), dim=-1)
    xent = -torch.gather(logp, -1, targ[..., None])[..., 0].reshape(b, -1)
    m = mask.to(xent.dtype).reshape(b, -1)
    if reduce:
        return (xent * m).sum() / ((m.sum() if count is None else count)
                                   + 1e-9)
    return (xent * m).sum(dim=1) / (m.sum(dim=1) + 1e-9)


def bins2dist(bins: torch.Tensor, num_bins: int, range_bins: float,
              shift_half: bool = True, zero_diag: bool = True) -> torch.Tensor:
    """Packed upper-triangle bins -> symmetric f32 distance matrix
    (reference commons.py:72-82): (bin [+0.5]) * range/(B-1), then d + d^T
    and a zero diagonal. ``bins`` (..., N, N) holds bin ids in its strict
    upper triangle."""
    bin_size = range_bins / (num_bins - 1)
    d = bins.float()
    if shift_half:
        d = d + 0.5
    d = d * bin_size
    d = d + d.transpose(-2, -1)
    if zero_diag:
        n = d.shape[-1]
        d = d * (1.0 - torch.eye(n, dtype=d.dtype, device=d.device))
    return d


def masked_l1(pred: torch.Tensor, target: torch.Tensor,
              sample_mask: Optional[torch.Tensor] = None,
              count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean |pred - target| over the valid samples (the L1 gap loss); with
    ``count`` (the valid samples of every rank's batch) the sum over them
    divided by it, this rank's share of the global mean."""
    err = torch.abs(pred - target)
    if sample_mask is None:
        return err.mean()
    m = sample_mask.to(err.dtype)
    return (err * m).sum() / ((m.sum() if count is None else count) + 1e-9)


def stack_draws(feed: Dict[str, torch.Tensor],
                draws: int) -> Dict[str, torch.Tensor]:
    """The feed of a draw-stacked forward of ``draws`` MC draws: every
    input repeated along the batch axis, draw-major (row ``s*b + r`` is
    draw s of molecule r)."""
    return {k: v.repeat(draws, *(1,) * (v.dim() - 1)) for k, v in feed.items()}
