"""Task models (counterpart of tgt_tpu/models/heads.py).

As the reference task heads
(lib/models/pcqm/{distance_predictor.py,gap_predictor.py,multitask.py}):
- distance: embed -> encoder(node_ended=False, edge_ended=True) -> edge LN
  -> Linear(edge_width, num_dist_bins) logits (b, N, N, bins);
- gap: embed -> encoder(node_ended=True, edge_ended=False) -> node LN ->
  masked mean pool -> Linear(node_width, 1), bias initialised to HL_MEAN;
  the last layer has no edge branch and no triplet sub-layer;
- multi: an encoder ended on both channels with both heads; returns
  (gap, dist_logits);
- pairformer: AlphaFold 3's Pairformer trunk and distogram head
  (``models/pairformer.py``), built from a ``PairformerConfig``;
- evoformer: AlphaFold 2's Evoformer trunk with its extra-MSA stack and
  its distogram and masked-MSA heads (``models/evoformer.py``), built from
  an ``EvoformerConfig``.

``seed`` is one seed, or a sequence of S seeds for a draw-stacked batch:
S MC draws of b molecules as one batch of S*b rows, row ``s*b + r`` draw s
of molecule r, each draw's masks those of the one-seed forward
(``models/encoder.py``).

Inside a ``pair_scope`` (``tgt_torch.parallel``) the models run on the
pair axis, under one seed: the embedding builds this rank's edge rows, the
encoder is ``encoder_pair_sharded``, the distance head returns the rows'
logits (b, N/P, N, bins) and the gap head pools the whole node state.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from tgt_torch.core.device import resolve_device
from tgt_torch.models import consts as C
from tgt_torch.models.embedding import EmbedInput
from tgt_torch.models.encoder import Seeds, TGTEncoder
from tgt_torch.models.evoformer import EvoformerModel
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.models.pairformer import PairformerModel
from tgt_torch.ops.common import init_module_, layernorm, linear
from tgt_torch.parallel.mesh import current_pair_axis
from tgt_torch.parallel.pair_layer import encoder_pair_sharded


def _pool_nodes(h: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Masked mean over the nodes in ``h``'s dtype (reference:
    gap_predictor.py:52-54)."""
    m = node_mask.to(h.dtype)[..., None]
    return (h * m).sum(dim=1) / (m.sum(dim=1) + 1e-9)


class _TaskModel(nn.Module):
    """Embedding and encoder ended as ``ENDS`` = (node_ended, edge_ended)."""

    ENDS: Tuple[bool, bool] = (True, True)

    def __init__(self, cfg: TGTConfig, device=None):
        super().__init__()
        node_ended, edge_ended = self.ENDS
        cfg = cfg.replace(node_ended=node_ended, edge_ended=edge_ended)
        self.cfg = cfg
        self.input_embed = EmbedInput(cfg, device=device)
        self.encoder = TGTEncoder(cfg, device=device)

    def _encode(self, batch: Dict[str, torch.Tensor], deterministic: bool,
                seed: Seeds):
        axis = current_pair_axis()
        if axis is None:
            g = self.input_embed(batch)
            return self.encoder(g, deterministic=deterministic, seed=seed)
        if isinstance(seed, (list, tuple)):
            raise ValueError("a draw-stacked forward (a sequence of seeds) "
                             "does not run on the pair axis")
        g = self.input_embed(batch, axis.rows(batch["node_mask"].shape[1]))
        return encoder_pair_sharded(self.encoder, g, axis,
                                    deterministic=deterministic, seed=seed)

    def _gap(self, g) -> torch.Tensor:
        h = layernorm(self.final_ln_node, g.h)
        return linear(self.pred, _pool_nodes(h, g.node_mask)).squeeze(-1)


class DistanceModel(_TaskModel):
    ENDS = (False, True)

    def __init__(self, cfg: TGTConfig, device=None):
        super().__init__(cfg, device)
        self.final_ln_edge = nn.LayerNorm(cfg.edge_width, device=device)
        self.dist_pred = nn.Linear(cfg.edge_width, cfg.num_dist_bins,
                                   device=device)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True,
                seed: Seeds = None) -> torch.Tensor:
        g = self._encode(batch, deterministic, seed)
        return linear(self.dist_pred, layernorm(self.final_ln_edge, g.e))


class GapModel(_TaskModel):
    ENDS = (True, False)

    def __init__(self, cfg: TGTConfig, device=None):
        super().__init__(cfg, device)
        self.final_ln_node = nn.LayerNorm(cfg.node_width, device=device)
        self.pred = nn.Linear(cfg.node_width, 1, device=device)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True,
                seed: Seeds = None) -> torch.Tensor:
        return self._gap(self._encode(batch, deterministic, seed))


class MultiModel(_TaskModel):
    ENDS = (True, True)

    def __init__(self, cfg: TGTConfig, device=None):
        super().__init__(cfg, device)
        self.final_ln_node = nn.LayerNorm(cfg.node_width, device=device)
        self.pred = nn.Linear(cfg.node_width, 1, device=device)
        self.final_ln_edge = nn.LayerNorm(cfg.edge_width, device=device)
        self.dist_pred = nn.Linear(cfg.edge_width, cfg.num_dist_bins,
                                   device=device)

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True, seed: Seeds = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        g = self._encode(batch, deterministic, seed)
        dist_logits = linear(self.dist_pred, layernorm(self.final_ln_edge, g.e))
        return self._gap(g), dist_logits


MODELS = {"distance": DistanceModel, "gap": GapModel, "multi": MultiModel,
          "pairformer": PairformerModel, "evoformer": EvoformerModel}


def make_model(name: str, cfg, *, device=None,
               seed: int = 0) -> nn.Module:
    """Build task model ``name`` with weights initialised from ``seed``, on
    the card unless ``device`` names another device: a ``TGTConfig`` for
    the TGT models, a ``PairformerConfig`` for ``pairformer``, an
    ``EvoformerConfig`` for ``evoformer``."""
    if name not in MODELS:
        raise ValueError(f"unknown model '{name}'; available: {list(MODELS)}")
    device = resolve_device(device)
    model = MODELS[name](cfg, device=device)
    init_module_(model, torch.Generator(device=device).manual_seed(seed))
    if name in ("gap", "multi"):   # the gap head starts at the mean gap
        with torch.no_grad():
            model.pred.bias.fill_(C.HL_MEAN)
    return model
