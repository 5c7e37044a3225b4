"""3D distance embeddings: Gaussian basis and Fourier (counterpart of
tgt_tpu/ops/embed3d.py).

- Gaussian3DEmbed (reference lib/models/pcqm/layers.py:112-157): a per
  atom-pair-type affine ``mul * d + bias`` (mul and bias embedded per type
  id and summed over the two endpoints), 128 Gaussian basis functions with
  learned means and stds (std = |std| + 1e-2; the normal pdf uses the
  reference's literal pi, 3.14159), then a 2-layer exact-GELU MLP to
  edge_width. Submodule names follow the reference state_dict
  (``gbf.means``, ``gbf_proj.layer1``, ...).
- Fourier3DEmbed (layers.py:86-109): sin/cos at log-spaced wavelengths in
  [2*0.01, 2*20] Angstrom, then a linear projection.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tgt_torch.ops.common import embedding, linear, linear_init_

_REF_PI = 3.14159  # the reference's literal (layers.py:132); not math.pi


def gaussian_basis(x: torch.Tensor, mean: torch.Tensor,
                   std: torch.Tensor) -> torch.Tensor:
    a = (2.0 * _REF_PI) ** 0.5
    return torch.exp(-0.5 * torch.square((x - mean) / std)) / (a * std)


class _GaussianBasis(nn.Module):
    def __init__(self, num_edge_types: int, num_kernels: int, device=None):
        super().__init__()
        self.means = nn.Embedding(1, num_kernels, device=device)
        self.stds = nn.Embedding(1, num_kernels, device=device)
        self.mul = nn.Embedding(num_edge_types, 1, device=device)
        self.bias = nn.Embedding(num_edge_types, 1, device=device)


class _NonLinear(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out_dim: int, device=None):
        super().__init__()
        self.layer1 = nn.Linear(in_dim, hidden, device=device)
        self.layer2 = nn.Linear(hidden, out_dim, device=device)


class Gaussian3DEmbed(nn.Module):
    def __init__(self, edge_width: int, num_edge_types: int,
                 num_kernels: int = 128, device=None):
        super().__init__()
        self.gbf = _GaussianBasis(num_edge_types, num_kernels, device)
        self.gbf_proj = _NonLinear(num_kernels, num_kernels, edge_width, device)

    @torch.no_grad()
    def init_from_(self, generator: torch.Generator) -> None:
        self.gbf.means.weight.uniform_(0.0, 3.0, generator=generator)
        self.gbf.stds.weight.uniform_(0.0, 3.0, generator=generator)
        # torch init.constant_ overwrites the padding row too
        # (layers.py:147-148), so mul row 0 is 1.0, not 0
        self.gbf.mul.weight.fill_(1.0)
        self.gbf.bias.weight.fill_(0.0)
        linear_init_(self.gbf_proj.layer1, generator)
        linear_init_(self.gbf_proj.layer2, generator)

    def forward(self, dist: torch.Tensor,
                node_type_edge: torch.Tensor) -> torch.Tensor:
        """dist (b, N, N); node_type_edge int (b, N, N, 2) -> (b, N, N, W)."""
        mul = embedding(self.gbf.mul, node_type_edge).sum(dim=-2)    # (b,N,N,1)
        bias = embedding(self.gbf.bias, node_type_edge).sum(dim=-2)
        x = mul * dist[..., None] + bias
        mean = self.gbf.means.weight.reshape(-1).float()
        std = self.gbf.stds.weight.reshape(-1).float().abs() + 1e-2
        feat = gaussian_basis(x.float(), mean, std).to(dist.dtype)   # (b,N,N,K)
        y = F.gelu(linear(self.gbf_proj.layer1, feat))
        return linear(self.gbf_proj.layer2, y)


class Fourier3DEmbed(nn.Module):
    def __init__(self, edge_width: int, num_kernels: int = 128,
                 min_dist: float = 0.01, max_dist: float = 20.0, device=None):
        super().__init__()
        if num_kernels % 2:
            raise ValueError(f"num_kernels must be even, got {num_kernels}")
        wave_lengths = torch.exp(torch.linspace(
            math.log(2 * min_dist), math.log(2 * max_dist), num_kernels // 2,
            device=device))
        # a buffer, not trained; part of the state_dict like the reference's
        self.register_buffer("angular_freqs", 2.0 * math.pi / wave_lengths)
        self.proj = nn.Linear(num_kernels, edge_width, device=device)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        phase = dist[..., None] * self.angular_freqs.to(dist.dtype)
        sinusoids = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)
        return linear(self.proj, sinusoids)
