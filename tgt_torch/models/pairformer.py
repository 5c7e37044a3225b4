"""AlphaFold 3's Pairformer trunk with its distogram head (Abramson et al.,
Nature 630:493, 2024, doi:10.1038/s41586-024-07487-w, Supplementary
section 3.6, Algorithm 17; open implementations of the same widths: Boltz-1
and Protenix). ``tgt_tpu`` has no counterpart.

- Input embedder, cut down from Algorithms 1-3: ``s = LinearNoBias(onehot(
  restype))`` over ``num_residue_types`` types; ``z_ij = LinearNoBias(s_i)
  + LinearNoBias(s_j) + LinearNoBias(onehot(d_ij))``, with the relative
  position of Algorithm 3, ``d_ij = clip(r_i - r_j + r_max, 0, 2 r_max)``
  within a chain and ``2 r_max + 1`` across chains (``r_max`` =
  ``max_relative_offset``).
- Each block, in order (Algorithm 17): triangle multiplication outgoing,
  then incoming; triangle attention around the starting node, then the
  ending node; a SwiGLU pair transition; single attention with pair bias;
  a SwiGLU single transition. Each is a residual update; the four triangle
  updates pass through dropout at ``pair_dropout``, row-wise (one mask for
  every row i: shape (b, 1, n, c_z)) and, for the ending node,
  column-wise ((b, n, 1, c_z)).
- Distogram head: ``LinearNoBias(z_ij + z_ji)`` to ``num_dist_bins``
  logits (b, n, n, bins).

Randomness, as in the TGT encoder (``models/encoder.py``): a forward seed
gives a table of per-block seeds (``seed_table``); each block draws its
four masks, in the order above, from a generator on the device that it
creates from its seed, so that a remat replay draws the same masks.

``remat`` wraps every block in ``torch.utils.checkpoint`` when gradients
are on, with ``remat_policy`` naming what it keeps (``ops/remat.py``).
``compute_dtype`` is the dtype of the two tracks; layer norms normalise in
f32. ``use_pallas='dense'`` runs triangle attention on the dense triplet
kernels.

Spans (``utils/tracing.py``, recorded while torch's profiler runs):
``pairformer.tri_mul`` (``direction`` outgoing or incoming),
``pairformer.tri_att`` (starting or ending), ``pairformer.transition``
(pair or single) and ``pairformer.single``, each with ``tokens``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tgt_torch.models.encoder import Seeds, make_generator, seed_table
from tgt_torch.ops import remat as remat_policies
from tgt_torch.ops.common import Generators, dropout, linear
from tgt_torch.ops.ffn import Transition
from tgt_torch.ops.triangle import (MASK_VALUE, AttentionPairBias,
                                    TriangleAttention, TriangleMultiplication)
from tgt_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class PairformerConfig:
    num_blocks: int = 48
    single_width: int = 384           # c_s
    pair_width: int = 128             # c_z
    tri_mul_width: int = 128          # the triangle multiplications' hidden
    tri_att_heads: int = 4
    tri_att_head_width: int = 32
    single_heads: int = 16
    single_head_width: int = 24
    transition_multiplier: int = 4
    pair_dropout: float = 0.25
    num_residue_types: int = 32
    max_relative_offset: int = 32     # r_max
    num_dist_bins: int = 64
    compute_dtype: str = "float32"    # 'float32' | 'bfloat16'
    remat: bool = False
    remat_policy: str = "none"
    use_pallas: object = False


class PairformerBlock(nn.Module):
    def __init__(self, cfg: PairformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        cz, cs = cfg.pair_width, cfg.single_width
        self.tri_mul_out = TriangleMultiplication(cz, cfg.tri_mul_width, True,
                                                  device=device)
        self.tri_mul_in = TriangleMultiplication(cz, cfg.tri_mul_width, False,
                                                 device=device)
        self.tri_att_start = TriangleAttention(cz, cfg.tri_att_heads,
                                               cfg.tri_att_head_width, True,
                                               device=device)
        self.tri_att_end = TriangleAttention(cz, cfg.tri_att_heads,
                                             cfg.tri_att_head_width, False,
                                             device=device)
        self.pair_transition = Transition(cz, cfg.transition_multiplier,
                                          device=device)
        self.single_att = AttentionPairBias(cs, cz, cfg.single_heads,
                                            cfg.single_head_width,
                                            device=device)
        self.single_transition = Transition(cs, cfg.transition_multiplier,
                                            device=device)

    def forward(self, s: torch.Tensor, z: torch.Tensor,
                pair_mask: torch.Tensor, key_bias: torch.Tensor,
                generator: Generators = None):
        cfg = self.cfg
        b, n, _, cz = z.shape
        off, rate = generator is None, cfg.pair_dropout
        rows, cols = (b, 1, n, cz), (b, n, 1, cz)
        for mod, name in ((self.tri_mul_out, "outgoing"),
                          (self.tri_mul_in, "incoming")):
            with tracing.span("pairformer.tri_mul") as row:
                if row is not None:
                    row.update(tokens=n, direction=name)
                z = z + dropout(mod(z, pair_mask), rate, off, generator, rows)
        for mod, name, shape in ((self.tri_att_start, "starting", rows),
                                 (self.tri_att_end, "ending", cols)):
            with tracing.span("pairformer.tri_att") as row:
                if row is not None:
                    row.update(tokens=n, direction=name)
                z = z + dropout(mod(z, key_bias, use_pallas=cfg.use_pallas),
                                rate, off, generator, shape)
        with tracing.span("pairformer.transition") as row:
            if row is not None:
                row.update(tokens=n, direction="pair")
            z = z + self.pair_transition(z)
        with tracing.span("pairformer.single") as row:
            if row is not None:
                row.update(tokens=n)
            s = s + self.single_att(s, z, key_bias)
        with tracing.span("pairformer.transition") as row:
            if row is not None:
                row.update(tokens=n, direction="single")
            s = s + self.single_transition(s)
        return s, z


def _apply_block(block: PairformerBlock, s, z, pair_mask, key_bias,
                 seed: Optional[int],
                 cache: Optional[remat_policies.RematCache] = None):
    """One block, with its generator made here from its seed, so that a
    remat replay draws the same masks."""
    with remat_policies.policy_scope(cache):
        gen = None if seed is None else make_generator(seed, z.device)
        return block(s, z, pair_mask, key_bias, gen)


class PairformerModel(nn.Module):
    """Input embedder, ``num_blocks`` Pairformer blocks and the distogram
    head. ``batch``: ``restype``, ``residue_index``, ``asym_id`` (b, n)
    integers and ``node_mask`` (b, n)."""

    def __init__(self, cfg: PairformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        remat_policies.context_fn(cfg.remat_policy)   # raises if unknown
        cs, cz = cfg.single_width, cfg.pair_width
        self.embed_s = nn.Linear(cfg.num_residue_types, cs, bias=False,
                                 device=device)
        self.embed_zi = nn.Linear(cs, cz, bias=False, device=device)
        self.embed_zj = nn.Linear(cs, cz, bias=False, device=device)
        self.embed_rel = nn.Linear(2 * cfg.max_relative_offset + 2, cz,
                                   bias=False, device=device)
        self.blocks = nn.ModuleList(PairformerBlock(cfg, device=device)
                                    for _ in range(cfg.num_blocks))
        self.distogram = nn.Linear(cz, cfg.num_dist_bins, bias=False,
                                   device=device)

    def relative_position(self, batch: Dict[str, torch.Tensor]
                          ) -> torch.Tensor:
        """(b, n, n) bins of Algorithm 3's relative residue position."""
        r_max = self.cfg.max_relative_offset
        res = batch["residue_index"].long()
        chain = batch["asym_id"].long()
        d = torch.clamp(res[:, :, None] - res[:, None, :] + r_max, 0,
                        2 * r_max)
        same = chain[:, :, None] == chain[:, None, :]
        return torch.where(same, d, torch.full_like(d, 2 * r_max + 1))

    def embed(self, batch: Dict[str, torch.Tensor]):
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        onehot = F.one_hot(batch["restype"].long().clamp(
            0, cfg.num_residue_types - 1), cfg.num_residue_types).to(dtype)
        s = linear(self.embed_s, onehot)
        rel = F.one_hot(self.relative_position(batch),
                        2 * cfg.max_relative_offset + 2).to(dtype)
        z = (linear(self.embed_zi, s)[:, :, None]
             + linear(self.embed_zj, s)[:, None] + linear(self.embed_rel, rel))
        nm = batch["node_mask"].to(dtype)
        pair_mask = (nm[:, :, None] * nm[:, None, :])[..., None]
        key_bias = ((1.0 - nm) * MASK_VALUE)[:, None, :, None]
        return s, z, pair_mask, key_bias

    def trunk(self, batch: Dict[str, torch.Tensor], *,
              deterministic: bool = True, seed: Seeds = None):
        """The single (b, n, c_s) and pair (b, n, n, c_z) representations
        after the last block."""
        cfg = self.cfg
        s, z, pair_mask, key_bias = self.embed(batch)
        seeds = [None] * cfg.num_blocks
        if not deterministic:
            if seed is None:
                raise ValueError("a stochastic forward needs a seed")
            seeds = seed_table(seed, cfg.num_blocks)
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = remat_policies.context_fn(cfg.remat_policy)
        policy = {} if context_fn is None else {"context_fn": context_fn}
        for block, block_seed in zip(self.blocks, seeds):
            args = (block, s, z, pair_mask, key_bias, block_seed)
            if remat:
                s, z = checkpoint(_apply_block, *args,
                                  remat_policies.cache_for(cfg.remat_policy),
                                  use_reentrant=False,
                                  preserve_rng_state=False, **policy)
            else:
                s, z = _apply_block(*args)
        return s, z

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True,
                seed: Seeds = None) -> torch.Tensor:
        """Distogram logits (b, n, n, bins)."""
        _, z = self.trunk(batch, deterministic=deterministic, seed=seed)
        return linear(self.distogram, z + z.transpose(1, 2))
