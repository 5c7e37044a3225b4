"""TGT encoder stack: pre-LN residual layers over the Graph (h, e, mask)
state (counterpart of tgt_tpu/models/encoder.py).

As the reference TGT_Layer / TGT_Encoder (lib/tgt/layers/layers.py:180-302,
lib/tgt/encoder.py:24-90):
- per layer: pairwise attention update (node + edge) -> residual; the
  triplet sub-layer on the edge channel -> residual; node and edge FFNs ->
  residuals; per-sample drop-path on every residual branch;
- a linear stochastic-depth ramp drop_path * i / (H-1) across the stack;
- ``layer_multiplier`` applies each layer k times (weight sharing);
- ``node_ended`` / ``edge_ended`` drop the unused update of the last layer
  (a QK-only EdgeUpdate when the node update is off); ``egt_simple`` turns
  every edge update off.

The layers run as a Python loop. Randomness: one seed gives a table of
per-layer seeds, drawn in layer order; each layer application gets its own
``torch.Generator`` on the device and draws its dropout masks from it in
forward order. A sequence of S seeds runs a draw-stacked batch (S MC draws
of b molecules as S*b rows, draw-major; tgt_tpu's ``vmap`` over the draws'
keys): S tables, and S generators per layer application, row block s
drawing from generator s (``ops/common.py``), so that draw s equals the
forward of b rows under seed s.

Per-layer configs (IndivConfig, tgt_tpu/models/encoder.py:262-296): layer
i is built from ``cfg.layer_cfg(i)``, so layers may differ in triplet
variant, heads, activation and rates; its drop-path rate is
``cfg.drop_path_rate(i)``.

``cfg.remat`` (tgt_tpu: ``jax.checkpoint`` around the scanned inner layers,
tgt_tpu/models/encoder.py:238-258) wraps each of the first
``model_height - 1`` layer applications in ``torch.utils.checkpoint``; the
last layer keeps its activations. Under IndivConfig every layer is
wrapped, as tgt_tpu's unrolled path wraps them. ``cfg.remat_policy`` says
what the checkpoint saves besides the layer's inputs (``ops/remat.py``: a
selective-checkpoint policy for ``dots``; for the named policies a cache
per checkpointed call, entered inside the checkpointed function, so that
the replay takes back what the forward named). The backward replays a layer's
forward, and ``checkpoint`` replays only the global RNG, not an explicit
generator: so each layer's generator is created and seeded inside the
checkpointed function, and the replay draws the same dropout,
source-dropout and drop-path masks as the forward did. No policy saves the
output of a random op.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tgt_torch.core.graph import Graph
from tgt_torch.models.model_config import TGTConfig
from tgt_torch.ops.attention import EdgeUpdate, EGTAttention
from tgt_torch.ops import remat as remat_policies
from tgt_torch.ops.common import Generators, residual
from tgt_torch.ops.ffn import FFN
from tgt_torch.ops.triplet import get_triplet_module

# one seed, or one per draw of a draw-stacked batch
Seeds = Union[int, Sequence[int], None]


class TGTLayer(nn.Module):
    def __init__(self, cfg: TGTConfig, node_update: bool, edge_update: bool,
                 device=None):
        super().__init__()
        self.cfg = cfg
        self.node_update = node_update
        self.edge_update = edge_update
        if node_update:
            self.update = EGTAttention(cfg.node_width, cfg.edge_width,
                                       cfg.num_heads, edge_update=edge_update,
                                       device=device)
            self.node_ffn = FFN(cfg.node_width, cfg.node_ffn_multiplier,
                                cfg.activation, device=device)
        elif edge_update:
            self.update = EdgeUpdate(cfg.node_width, cfg.edge_width,
                                     cfg.num_heads, device=device)
        else:
            raise ValueError("at least one of node_update/edge_update must "
                             "be True")
        if edge_update:
            if cfg.triplet_enabled:
                self.tria = get_triplet_module(cfg.triplet_type)(
                    cfg.edge_width, cfg.triplet_heads, device=device)
            self.edge_ffn = FFN(cfg.edge_width, cfg.edge_ffn_multiplier,
                                cfg.activation, device=device)

    def forward(self, g: Graph, *, drop_path_rate: float = 0.0,
                deterministic: bool = True,
                generator: Generators = None) -> Graph:
        """One TGT layer (reference forward: layers.py:262-294)."""
        cfg = self.cfg
        h, e, mask = g.h, g.e, g.mask

        def add(x, update):
            # x + drop_path(update), the mask drawn after the update's own
            return residual(x, update, drop_path_rate, deterministic,
                            generator)

        if self.node_update:
            h_up, e_up = self.update(
                h, e, mask, scale_degree=cfg.scale_degree,
                source_dropout=cfg.source_dropout,
                deterministic=deterministic, generator=generator)
            h = add(h, h_up)
            h = add(h, self.node_ffn(h, act_dropout=cfg.node_act_dropout,
                                     deterministic=deterministic,
                                     generator=generator))
        else:
            _, e_up = self.update(h, e, mask)

        if self.edge_update:
            e = add(e, e_up)
            if cfg.triplet_enabled:
                tri = self.tria(e, mask, attention_dropout=cfg.triplet_dropout,
                                deterministic=deterministic,
                                generator=generator,
                                use_pallas=cfg.use_pallas)
                e = add(e, tri)
            e = add(e, self.edge_ffn(e, act_dropout=cfg.edge_act_dropout,
                                     deterministic=deterministic,
                                     generator=generator))
        return g.copy(h=h, e=e)


class TGTEncoder(nn.Module):
    def __init__(self, cfg: TGTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        remat_policies.context_fn(cfg.remat_policy)   # raises if unknown
        self.TGT_layers = nn.ModuleList(
            TGTLayer(cfg.layer_cfg(i), *cfg.layer_updates(i), device=device)
            for i in range(cfg.model_height))

    def forward(self, g: Graph, *, deterministic: bool = True,
                seed: Seeds = None) -> Graph:
        cfg = self.cfg
        reps = cfg.layer_multiplier
        seeds = None
        if not deterministic:
            if seed is None:
                raise ValueError("a stochastic forward needs a seed")
            seeds = seed_table(seed, cfg.model_height * reps)
        remat = cfg.remat and torch.is_grad_enabled()
        # tgt_tpu's unrolled (IndivConfig) path remats every layer
        n_remat = len(self.TGT_layers) - (not cfg.has_indiv)
        context_fn = remat_policies.context_fn(cfg.remat_policy)
        policy = {} if context_fn is None else {"context_fn": context_fn}
        for i, layer in enumerate(self.TGT_layers):
            args = (layer, g, cfg.drop_path_rate(i), deterministic,
                    None if seeds is None else seeds[i * reps:(i + 1) * reps])
            if remat and i < n_remat:
                # the layer draws only from the generators it creates, so
                # the global RNG state needs no replay
                g = checkpoint(_apply_layer, *args,
                               remat_policies.cache_for(cfg.remat_policy),
                               use_reentrant=False, preserve_rng_state=False,
                               **policy)
            else:
                g = _apply_layer(*args)
        return g


def seed_table(seed: Union[int, Sequence[int]], count: int) -> list:
    """The ``count`` per-layer-application seeds of one seed, drawn in
    layer order; for a sequence of S seeds, one S-tuple per application,
    entry s from seed s's table."""
    if isinstance(seed, (list, tuple)):
        return list(zip(*(seed_table(s, count) for s in seed)))
    return torch.randint(0, 2**62, (count,),
                         generator=torch.Generator().manual_seed(seed)).tolist()


def make_generator(seed: Union[int, tuple], device) -> Generators:
    """A generator on ``device`` seeded with ``seed``, or a tuple of them
    for a tuple of per-draw seeds."""
    if isinstance(seed, tuple):
        return tuple(make_generator(s, device) for s in seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _apply_layer(layer: TGTLayer, g: Graph, drop_path_rate: float,
                 deterministic: bool, seeds: Optional[Sequence],
                 cache: Optional[remat_policies.RematCache] = None) -> Graph:
    """``layer_multiplier`` applications of one layer, each with a generator
    (or one per draw) made here from its seed (so that a remat replay draws
    the same masks); the values the remat policy names go to ``cache``."""
    with remat_policies.policy_scope(cache):
        for m in range(layer.cfg.layer_multiplier):
            gen = None
            if seeds is not None:
                gen = make_generator(seeds[m], g.e.device)
            g = layer(g, drop_path_rate=drop_path_rate,
                      deterministic=deterministic, generator=gen)
    return g
