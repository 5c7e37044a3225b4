"""Task models (counterpart of tgt_tpu/models/heads.py).

Ported: the distance model (reference lib/models/pcqm/distance_predictor.py)
— embed -> encoder(node_ended=False, edge_ended=True) -> edge LN ->
Linear(edge_width, num_dist_bins) logits (b, N, N, bins). The gap and
multi models come later (ROADMAP.md item 1i).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tgt_torch.core.device import resolve_device
from tgt_torch.models.embedding import EmbedInput
from tgt_torch.models.encoder import TGTEncoder
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops.common import init_module_, layernorm, linear


class DistanceModel(nn.Module):
    def __init__(self, cfg: TGTConfig, device=None):
        super().__init__()
        cfg = cfg.replace(node_ended=False, edge_ended=True)
        self.cfg = cfg
        self.input_embed = EmbedInput(cfg, device=device)
        self.encoder = TGTEncoder(cfg, device=device)
        self.final_ln_edge = nn.LayerNorm(cfg.edge_width, device=device)
        self.dist_pred = nn.Linear(cfg.edge_width, cfg.num_dist_bins,
                                   device=device)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True,
                seed: Optional[int] = None) -> torch.Tensor:
        g = self.input_embed(batch)
        g = self.encoder(g, deterministic=deterministic, seed=seed)
        return linear(self.dist_pred, layernorm(self.final_ln_edge, g.e))


MODELS = {"distance": DistanceModel}


def make_model(name: str, cfg: TGTConfig, *, device=None,
               seed: int = 0) -> nn.Module:
    """Build task model ``name`` with weights initialised from ``seed``, on
    the card unless ``device`` names another device."""
    if name in ("gap", "multi"):
        raise NotImplementedError(
            f"the {name} model is not ported yet (ROADMAP.md item 1i)")
    if name not in MODELS:
        raise ValueError(f"unknown model '{name}'; available: {list(MODELS)}")
    device = resolve_device(device)
    model = MODELS[name](cfg, device=device)
    init_module_(model, torch.Generator(device=device).manual_seed(seed))
    return model
