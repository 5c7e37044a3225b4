"""Pair-sharded TGT layers: the whole encoder with the edge channel sharded
over the pair axis (counterpart of tgt_tpu/parallel/pair_layer.py).

The edge channel ``e``, O(N^2) with O(N^3) interactions, lives i-row-sharded
over the pair axis for the whole forward (``mesh.PairAxis``: rank ``p`` of
``P`` holds rows ``[p N/P, (p+1) N/P)``); the node states ``h``, (b, N,
W_h), travel whole on every rank of the pair group. Per layer:

- EGT attention: each rank computes the H_hat rows of its i-block from the
  whole ``h`` and its ``e`` rows; the softmax over the source nodes m is
  row-local; the node update's row blocks are all-gathered back to the
  whole ``h`` (``ring._gather_rows``);
- the triplet interaction: the ring and all-to-all path of ``ring.py``;
- FFNs, layer norms, residuals: row-local, no communication.

The functions take the port's own modules (``TGTLayer``, ``TGTEncoder``)
and read their parameters, so the weights, their ``state_dict`` names and
the weight bridge are those of the unsharded model. Beyond tgt_tpu's
uniform both-ended stack (``encoder_pair_sharded``), they run what
tgt_tpu's Trainer pair-shards through GSPMD: ``cfg.layer_updates(i)``, the
distance model's edge-only last layer (``EdgeUpdate``: H_hat rows from the
whole ``h`` and the local ``e`` rows), the gap model's node-only last
layer, IndivConfig, ``layer_multiplier``, drop-path and remat.
``triangular_update`` and ``axial_attention`` raise, as tgt_tpu's do.

Randomness: a layer application draws what the whole ``h`` and the
per-sample masks need (drop-path, source dropout, the node FFN's dropout)
from ``generator``, the same seed on every rank of the pair group, so the
ranks' ``h`` stay equal; the edge FFN's activation dropout and the triplet
dropout draw from ``edge_generator``, its seed folded with the pair index
(tgt_tpu: ``fold_in(rng, axis_index)``). Both are made inside the
checkpointed function, so that a remat replay draws the same masks. The
bits differ from the unsharded layer's (and from tgt_tpu's, whose RNG is
another), the distribution does not.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from tgt_torch.core.graph import MASK_VALUE, Graph
from tgt_torch.ops import remat as remat_policies
from tgt_torch.ops.attention import EGTAttention
from tgt_torch.ops.common import drop_path, layernorm, linear
from tgt_torch.ops.triplet import TripletAggregate, TripletAttention
from tgt_torch.parallel.mesh import PairAxis
from tgt_torch.parallel.ring import (_gather_rows, triplet_aggregate_ring,
                                     triplet_attention_ring)

PAIR_TRIPLET_TYPES = ("attention", "attention_ungated", "aggregate",
                      "aggregate_ungated")


def check_pair_config(cfg) -> None:
    """Raise for a layer whose triplet variant has no pair-sharded path
    (tgt_tpu/parallel/pair_layer.py:168-170)."""
    for i in range(cfg.model_height):
        layer = cfg.layer_cfg(i)
        if layer.triplet_enabled and layer.triplet_type not in \
                PAIR_TRIPLET_TYPES:
            raise NotImplementedError(
                "pair-sharded path supports the attention/aggregate triplet "
                f"variants, not {layer.triplet_type}")


def _egt_attention_rows(module, h_full: torch.Tensor, e_local: torch.Tensor,
                        mask_local: torch.Tensor, axis: PairAxis, *,
                        scale_degree: bool = True,
                        source_dropout: float = 0.0,
                        deterministic: bool = True,
                        generator: Optional[torch.Generator] = None):
    """EGT attention (``EGTAttention``) or the QK-only ``EdgeUpdate`` with
    i-row-sharded ``e``: ``(h rows of this rank's i-block or None, e_out
    rows or None)``. Source dropout drops whole source columns (the m axis,
    not sharded) with the same draw on every pair rank."""
    b, n, node_width = h_full.shape
    heads = module.num_heads
    d = node_width // heads
    scale = d ** -0.5
    rows = axis.rows(n)
    i_loc = rows.stop - rows.start
    node_update = isinstance(module, EGTAttention)

    h_ln = layernorm(module.mha_ln_h, h_full)
    e_ln = layernorm(module.mha_ln_e, e_local)
    if node_update:
        q, k, v = linear(module.lin_QKV, h_ln).chunk(3, dim=-1)
        e_b, g_b = linear(module.lin_EG, e_ln).chunk(2, dim=-1)
    else:
        q, k = linear(module.lin_QK, h_ln).chunk(2, dim=-1)
        e_b = linear(module.lin_E, e_ln)
    # this rank's i-block of query rows
    q_rows = q[:, rows].reshape(b, i_loc, d, heads) * scale
    k = k.reshape(b, n, d, heads)
    h_hat = torch.einsum("bldh,bmdh->blmh", q_rows, k) + e_b
    e_out = (linear(module.lin_O_e, h_hat)
             if not node_update or module.edge_update else None)
    if not node_update:
        return None, e_out

    if source_dropout > 0.0 and not deterministic:
        drop = torch.rand((b, 1, n, 1), generator=generator,
                          device=h_full.device) < source_dropout
        mask_local = mask_local + drop.to(mask_local.dtype) * MASK_VALUE
    v = v.reshape(b, n, d, heads)
    gates = torch.sigmoid(g_b + mask_local)
    a = torch.softmax(h_hat + mask_local, dim=2) * gates
    v_att = torch.einsum("blmh,bmdh->bldh", a, v)
    if scale_degree:
        v_att = v_att * torch.log1p(gates.sum(dim=2, keepdim=True))
    h_rows = linear(module.lin_O_h, v_att.reshape(b, i_loc, node_width))
    return h_rows, e_out


def tgt_layer_pair_sharded(layer, g: Graph, axis: PairAxis, *,
                           drop_path_rate: float = 0.0,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None,
                           edge_generator: Optional[torch.Generator] = None
                           ) -> Graph:
    """One application of ``layer`` (a ``TGTLayer``) with row-sharded e:
    ``g.h`` (b, N, Wh) whole, ``g.e`` (b, N/P, N, We) and ``g.mask``
    (b, N/P, N, 1) this rank's rows. Returns the updated Graph, the same
    layout; gathered, it is ``layer(g)``'s."""
    cfg = layer.cfg
    h, e, mask = g.h, g.e, g.mask

    def dp(x):
        return drop_path(x, drop_path_rate, deterministic, generator)

    h_rows, e_up = _egt_attention_rows(
        layer.update, h, e, mask, axis, scale_degree=cfg.scale_degree,
        source_dropout=cfg.source_dropout, deterministic=deterministic,
        generator=generator)
    if layer.node_update:
        h = h + dp(_gather_rows(h_rows, axis))
        h = h + dp(layer.node_ffn(h, act_dropout=cfg.node_act_dropout,
                                  deterministic=deterministic,
                                  generator=generator))
    if layer.edge_update:
        e = e + dp(e_up)
        if cfg.triplet_enabled:
            if isinstance(layer.tria, TripletAttention):
                ring = triplet_attention_ring
            elif isinstance(layer.tria, TripletAggregate):
                ring = triplet_aggregate_ring
            else:
                raise NotImplementedError(
                    "pair-sharded path supports the attention/aggregate "
                    f"triplet variants, not {cfg.triplet_type}")
            tri = ring(layer.tria, e, mask, axis,
                       attention_dropout=cfg.triplet_dropout,
                       deterministic=deterministic, generator=edge_generator)
            e = e + dp(tri)
        e = e + dp(layer.edge_ffn(e, act_dropout=cfg.edge_act_dropout,
                                  deterministic=deterministic,
                                  generator=edge_generator))
    return g.copy(h=h, e=e)


def _apply_layer_pair(layer, g: Graph, axis: PairAxis,
                      drop_path_rate: float, deterministic: bool,
                      seeds: Optional[Sequence[int]],
                      cache: Optional[remat_policies.RematCache] = None
                      ) -> Graph:
    """``layer_multiplier`` pair-sharded applications of one layer, each
    with its two generators made here from its seed (so that a remat replay
    draws the same masks)."""
    # imported here: the harness imports this module
    from tgt_torch.training.harness import derive_seed

    with remat_policies.policy_scope(cache):
        for m in range(layer.cfg.layer_multiplier):
            gen = edge_gen = None
            if seeds is not None:
                gen = torch.Generator(device=g.e.device)
                gen.manual_seed(seeds[m])
                edge_gen = torch.Generator(device=g.e.device)
                edge_gen.manual_seed(derive_seed(seeds[m], axis.index))
            g = tgt_layer_pair_sharded(
                layer, g, axis, drop_path_rate=drop_path_rate,
                deterministic=deterministic, generator=gen,
                edge_generator=edge_gen)
    return g


def encoder_pair_sharded(encoder, g: Graph, axis: PairAxis, *,
                         deterministic: bool = True,
                         seed: Optional[int] = None) -> Graph:
    """``encoder`` (a ``TGTEncoder``) with the edge channel sharded over
    ``axis``: its seeds, drop-path ramp, per-layer updates and remat are
    the unsharded forward's (``TGTEncoder.forward``); ``g.e`` and
    ``g.mask`` hold this rank's rows."""
    cfg = encoder.cfg
    reps = cfg.layer_multiplier
    seeds = None
    if not deterministic:
        if seed is None:
            raise ValueError("a stochastic forward needs a seed")
        seeds = torch.randint(
            0, 2**62, (cfg.model_height * reps,),
            generator=torch.Generator().manual_seed(seed)).tolist()
    remat = cfg.remat and torch.is_grad_enabled()
    n_remat = len(encoder.TGT_layers) - (not cfg.has_indiv)
    context_fn = remat_policies.context_fn(cfg.remat_policy)
    policy = {} if context_fn is None else {"context_fn": context_fn}
    for i, layer in enumerate(encoder.TGT_layers):
        args = (layer, g, axis, cfg.drop_path_rate(i), deterministic,
                None if seeds is None else seeds[i * reps:(i + 1) * reps])
        if remat and i < n_remat:
            g = checkpoint(_apply_layer_pair, *args,
                           remat_policies.cache_for(cfg.remat_policy),
                           use_reentrant=False, preserve_rng_state=False,
                           **policy)
        else:
            g = _apply_layer_pair(*args)
    return g
