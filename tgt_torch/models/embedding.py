"""Input embedding: raw integer/float batch -> Graph (h, e, mask)
(counterpart of tgt_tpu/models/embedding.py).

Semantics of the reference EmbedInput (lib/models/pcqm/layers.py:11-83):
- node state: sum of per-feature embeddings of offset-encoded node features
  (vocab 9*128+1, padding_idx 0);
- edge state: hop-distance embedding (hops clamped to upto_hop+1) + sum of
  bond-feature embeddings (+ the Gaussian or Fourier 3D distance embedding;
  the Gaussian's atom-pair type ids take the first node feature, with the
  j side offset by 128);
- additive attention mask (1 - edge_mask) * MASK_VALUE in the compute dtype.

Batch keys: node_features (b, N, 9), distance_matrix (b, N, N),
feature_matrix (b, N, N, 3), node_mask (b, N), edge_mask (b, N, N), and
dist_input (b, N, N) when embed_3d_type is not 'none'.

On the pair axis (``rows``: this rank's i-rows) the edge state and the mask
are built for those rows only: the pair tensors (``PAIR_TENSOR_KEYS``) are
cut to them, and the atom-pair type ids pair row node i with every column
node j; the node state stays whole.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from tgt_torch.core.graph import MASK_VALUE, Graph
from tgt_torch.models import consts as C
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops.common import embedding
from tgt_torch.ops.embed3d import Fourier3DEmbed, Gaussian3DEmbed
from tgt_torch.parallel.mesh import PAIR_TENSOR_KEYS


class EmbedInput(nn.Module):
    def __init__(self, cfg: TGTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.nodef_embed = nn.Embedding(
            C.NUM_NODE_FEATURES * C.NODE_FEATURES_OFFSET + 1, cfg.node_width,
            padding_idx=0, device=device)
        self.dist_embed = nn.Embedding(cfg.upto_hop + 2, cfg.edge_width,
                                       device=device)
        self.featm_embed = nn.Embedding(
            C.NUM_EDGE_FEATURES * C.EDGE_FEATURES_OFFSET + 1, cfg.edge_width,
            padding_idx=0, device=device)
        if cfg.embed_3d_type == "gaussian":
            self.m3d_embed = Gaussian3DEmbed(
                cfg.edge_width, 2 * C.NODE_FEATURES_OFFSET + 1,
                cfg.num_3d_kernels, device=device)
        elif cfg.embed_3d_type == "fourier":
            self.m3d_embed = Fourier3DEmbed(cfg.edge_width, cfg.num_3d_kernels,
                                            device=device)
        elif cfg.embed_3d_type != "none":
            raise ValueError(f"invalid embed_3d_type: {cfg.embed_3d_type}")

    def forward(self, batch: Dict[str, torch.Tensor],
                rows: Optional[slice] = None) -> Graph:
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        if rows is not None:
            batch = {k: v[:, rows] if k in PAIR_TENSOR_KEYS else v
                     for k, v in batch.items()}

        nodef = batch["node_features"].long()                    # (b, N, 9)
        h = embedding(self.nodef_embed, nodef).sum(dim=2)        # (b, N, W_h)

        dm = batch["distance_matrix"].long().clamp(0, cfg.upto_hop + 1)
        featm = batch["feature_matrix"].long()                   # (b, N, N, 3)
        e = (embedding(self.dist_embed, dm)
             + embedding(self.featm_embed, featm).sum(dim=-2))   # (b, N, N, W_e)

        if cfg.embed_3d_type == "gaussian":
            b, n = nodef.shape[:2]
            nodes_i = nodef[:, :, 0]
            nodes_j = nodes_i + C.NODE_FEATURES_OFFSET
            if rows is not None:            # the rows' nodes, every column
                nodes_i = nodes_i[:, rows]
            n_i = nodes_i.shape[1]
            nodes_ij = torch.stack([nodes_i[:, :, None].expand(b, n_i, n),
                                    nodes_j[:, None, :].expand(b, n_i, n)],
                                   dim=-1)                       # (b, N, N, 2)
            e = e + self.m3d_embed(batch["dist_input"].to(dtype), nodes_ij)
        elif cfg.embed_3d_type == "fourier":
            e = e + self.m3d_embed(batch["dist_input"].to(dtype))

        edge_mask = batch["edge_mask"].to(dtype)[..., None]      # (b, N, N, 1)
        mask = (1.0 - edge_mask) * MASK_VALUE
        return Graph(h=h.to(dtype), e=e.to(dtype), mask=mask,
                     node_mask=batch["node_mask"])
