"""Graph batch container (counterpart of tgt_tpu/core/graph.py).

The encoder stack passes node states ``h``, edge states ``e`` and an
additive attention ``mask`` from layer to layer (reference:
lib/tgt/encoder.py:7-21). Arrays are padded to the bucket size; validity is
carried by ``node_mask`` and the pair mask.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass
class Graph:
    """Inter-layer state of the TGT encoder stack.

    Attributes:
      h: node channel states, float (b, N, node_width).
      e: edge channel states, float (b, N, N, edge_width).
      mask: additive attention mask, float (b, N, N, 1); 0 where the pair
        (i, j) is valid, MASK_VALUE where it is not.
      node_mask: validity of each node slot (b, N).
    """

    h: torch.Tensor
    e: torch.Tensor
    mask: torch.Tensor
    node_mask: torch.Tensor

    def copy(self, **updates: Any) -> "Graph":
        return dataclasses.replace(self, **updates)


# Additive mask value. The reference uses torch.finfo(dtype).min
# (lib/models/pcqm/layers.py:78-80); tgt_tpu fixed it at -1e9, which behaves
# the same through softmax in f32 and bf16, and the port keeps -1e9.
MASK_VALUE = -1e9

