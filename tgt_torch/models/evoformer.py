"""AlphaFold 2's Evoformer trunk with its extra-MSA stack, its input
embedder and its distogram and masked-MSA heads (Jumper et al., Nature
596:583, 2021, doi:10.1038/s41586-021-03819-2, Supplementary sections 1.5
and 1.6, Algorithms 3, 4, 6-15, 18 and 19; widths as OpenFold's). ``tgt_tpu``
has no counterpart.

- Input embedder (Algorithms 3, 4): ``z_ij = Linear(tf_i) + Linear(tf_j) +
  Linear(onehot(clip(r_i - r_j, -r_max, r_max)))`` over ``2 r_max + 1``
  bins, ``m_si = Linear(msa_feat_si) + Linear(tf_i)``, and the extra MSA
  ``e_si = Linear(extra_msa_feat_si)``; every projection with a bias. No
  recycling embedder and no template stack.
- Each block (Algorithm 6), each step a residual update: MSA row attention
  with pair bias (dropout ``msa_dropout`` row-wise, one mask (b, 1, r, c)
  for every sequence); MSA column attention, or in the extra-MSA stack
  (Algorithm 18) global column attention (Algorithm 19); the MSA
  transition; the outer product mean into the pair; triangle
  multiplication outgoing, then incoming; triangle attention around the
  starting node, then the ending node (the four at ``pair_dropout``,
  row-wise (b, 1, r, c_z), the last column-wise (b, r, 1, c_z)); the pair
  transition. The transitions are LN, Linear to 4x, ReLU, Linear
  (``ops/ffn.FFN``); the MSA ops are ``ops/msa.py``'s, the triangle ops
  ``ops/triangle.py``'s with AlphaFold 2's biases (``bias=True``).
- The extra-MSA stack (``num_extra_blocks`` at ``extra_msa_width``) runs
  first and hands on z alone; then ``num_blocks`` blocks at ``msa_width``.
- Heads: the distogram ``Linear(z_ij) + Linear(z_ji)`` (``num_dist_bins``
  logits) and the masked MSA ``Linear(m_si)`` (``MSA_CLASSES``).

Batch: ``target_feat`` (b, r, 22), ``residue_index`` (b, r), ``msa_feat``
(b, s, r, 49), ``msa_mask`` (b, s, r), ``extra_msa_feat`` (b, S, r, 25),
``extra_msa_mask`` (b, S, r) and ``node_mask`` (b, r). Row attention masks
its keys by ``node_mask`` alone; a padded sequence row is masked wherever
it is read (column attention's keys, the outer product mean, the loss).

Randomness, as in the Pairformer (``models/pairformer.py``): a forward seed
gives a table of per-block seeds, the extra-MSA blocks' first; each block
draws its five masks, in the order above, from a generator on the device
made from its seed, so that a remat replay draws the same masks. ``remat``
wraps every block in ``torch.utils.checkpoint`` when gradients are on.
``compute_dtype`` is the dtype of the three tracks; layer norms normalise
in f32. ``use_pallas='dense'`` runs triangle attention on the dense triplet
kernels.

Spans (``utils/tracing.py``, recorded while torch's profiler runs), each
with ``tokens`` (r), ``sequences`` (s) and ``stack`` (main or extra):
``evoformer.msa_row``, ``evoformer.msa_col`` (``kind`` column or global),
``evoformer.msa_transition``, ``evoformer.opm``, ``evoformer.tri_mul``
(``direction`` outgoing or incoming), ``evoformer.tri_att`` (starting or
ending) and ``evoformer.pair_transition``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tgt_torch.models.encoder import Seeds, make_generator, seed_table
from tgt_torch.ops import remat as remat_policies
from tgt_torch.ops.common import Generators, dropout, linear
from tgt_torch.ops.ffn import FFN
from tgt_torch.ops.msa import (MASK_VALUE, MSAColumnAttention,
                               MSAColumnGlobalAttention,
                               MSARowAttentionWithPairBias,
                               OuterProductMeanUpdate)
from tgt_torch.ops.triangle import TriangleAttention, TriangleMultiplication
from tgt_torch.utils import tracing

# AlphaFold 2's input feature widths (Supplementary Table 1) and the masked
# MSA's classes: 20 amino acids, unknown, gap and the mask token
TARGET_FEAT, MSA_FEAT, EXTRA_MSA_FEAT, MSA_CLASSES = 22, 49, 25, 23


@dataclasses.dataclass(frozen=True)
class EvoformerConfig:
    num_blocks: int = 48
    num_extra_blocks: int = 4
    msa_width: int = 256              # c_m
    extra_msa_width: int = 64         # c_e
    pair_width: int = 128             # c_z
    msa_heads: int = 8
    msa_head_width: int = 32
    extra_msa_heads: int = 8
    extra_msa_head_width: int = 8
    opm_width: int = 32               # the outer product mean's c
    tri_mul_width: int = 128
    tri_att_heads: int = 4
    tri_att_head_width: int = 32
    transition_multiplier: int = 4
    msa_dropout: float = 0.15
    pair_dropout: float = 0.25
    max_relative_offset: int = 32     # r_max
    num_dist_bins: int = 64
    compute_dtype: str = "float32"    # 'float32' | 'bfloat16'
    remat: bool = False
    remat_policy: str = "none"
    use_pallas: object = False


@contextlib.contextmanager
def _traced(name: str, attrs: Dict):
    with tracing.span(name) as row:
        if row is not None:
            row.update(attrs)
        yield


class EvoformerBlock(nn.Module):
    """One block of the main stack, or with ``extra`` of the extra-MSA
    stack (its widths and global column attention)."""

    def __init__(self, cfg: EvoformerConfig, extra: bool = False,
                 device=None):
        super().__init__()
        self.cfg, self.stack = cfg, "extra" if extra else "main"
        cz = cfg.pair_width
        if extra:
            cm, heads, hw = (cfg.extra_msa_width, cfg.extra_msa_heads,
                             cfg.extra_msa_head_width)
        else:
            cm, heads, hw = (cfg.msa_width, cfg.msa_heads,
                             cfg.msa_head_width)
        col = MSAColumnGlobalAttention if extra else MSAColumnAttention
        mult = cfg.transition_multiplier
        self.msa_row = MSARowAttentionWithPairBias(cm, cz, heads, hw,
                                                   device=device)
        self.msa_col = col(cm, heads, hw, device=device)
        self.msa_transition = FFN(cm, mult, "relu", device=device)
        self.opm = OuterProductMeanUpdate(cm, cz, cfg.opm_width,
                                          device=device)
        self.tri_mul_out = TriangleMultiplication(
            cz, cfg.tri_mul_width, True, bias=True, device=device)
        self.tri_mul_in = TriangleMultiplication(
            cz, cfg.tri_mul_width, False, bias=True, device=device)
        self.tri_att_start = TriangleAttention(
            cz, cfg.tri_att_heads, cfg.tri_att_head_width, True, bias=True,
            device=device)
        self.tri_att_end = TriangleAttention(
            cz, cfg.tri_att_heads, cfg.tri_att_head_width, False, bias=True,
            device=device)
        self.pair_transition = FFN(cz, mult, "relu", device=device)

    def forward(self, m: torch.Tensor, z: torch.Tensor,
                msa_mask: torch.Tensor, pair_mask: torch.Tensor,
                row_bias: torch.Tensor, key_bias: torch.Tensor,
                generator: Generators = None):
        cfg = self.cfg
        b, s, r, cm = m.shape
        cz = z.shape[-1]
        off = generator is None
        at = {"tokens": r, "sequences": s, "stack": self.stack}
        rows, cols = (b, 1, r, cz), (b, r, 1, cz)
        with _traced("evoformer.msa_row", at):
            m = m + dropout(self.msa_row(m, z, row_bias), cfg.msa_dropout,
                            off, generator, (b, 1, r, cm))
        kind = "global" if self.stack == "extra" else "column"
        with _traced("evoformer.msa_col", dict(at, kind=kind)):
            m = m + self.msa_col(m, msa_mask)
        with _traced("evoformer.msa_transition", at):
            m = m + self.msa_transition(m)
        with _traced("evoformer.opm", at):
            z = z + self.opm(m, msa_mask)
        for mod, name in ((self.tri_mul_out, "outgoing"),
                          (self.tri_mul_in, "incoming")):
            with _traced("evoformer.tri_mul", dict(at, direction=name)):
                z = z + dropout(mod(z, pair_mask), cfg.pair_dropout, off,
                                generator, rows)
        for mod, name, shape in ((self.tri_att_start, "starting", rows),
                                 (self.tri_att_end, "ending", cols)):
            with _traced("evoformer.tri_att", dict(at, direction=name)):
                z = z + dropout(mod(z, key_bias, use_pallas=cfg.use_pallas),
                                cfg.pair_dropout, off, generator, shape)
        with _traced("evoformer.pair_transition", at):
            z = z + self.pair_transition(z)
        return m, z


def _apply_block(block: EvoformerBlock, m, z, msa_mask, pair_mask, row_bias,
                 key_bias, seed: Optional[int],
                 cache: Optional[remat_policies.RematCache] = None):
    """One block, with its generator made here from its seed, so that a
    remat replay draws the same masks."""
    with remat_policies.policy_scope(cache):
        gen = None if seed is None else make_generator(seed, z.device)
        return block(m, z, msa_mask, pair_mask, row_bias, key_bias, gen)


class EvoformerModel(nn.Module):
    """Input embedder, the extra-MSA stack, the Evoformer stack and the two
    heads (see the module note for the batch)."""

    def __init__(self, cfg: EvoformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        remat_policies.context_fn(cfg.remat_policy)   # raises if unknown
        cm, cz, tf = cfg.msa_width, cfg.pair_width, TARGET_FEAT
        self.embed_tf_zi = nn.Linear(tf, cz, device=device)
        self.embed_tf_zj = nn.Linear(tf, cz, device=device)
        self.embed_tf_m = nn.Linear(tf, cm, device=device)
        self.embed_msa = nn.Linear(MSA_FEAT, cm, device=device)
        self.embed_relpos = nn.Linear(2 * cfg.max_relative_offset + 1, cz,
                                      device=device)
        self.embed_extra = nn.Linear(EXTRA_MSA_FEAT, cfg.extra_msa_width,
                                     device=device)
        self.extra_blocks = nn.ModuleList(
            EvoformerBlock(cfg, extra=True, device=device)
            for _ in range(cfg.num_extra_blocks))
        self.blocks = nn.ModuleList(EvoformerBlock(cfg, device=device)
                                    for _ in range(cfg.num_blocks))
        self.distogram = nn.Linear(cz, cfg.num_dist_bins, device=device)
        self.masked_msa = nn.Linear(cm, MSA_CLASSES, device=device)

    def relative_position(self, batch: Dict[str, torch.Tensor]
                          ) -> torch.Tensor:
        """(b, r, r) bins of Algorithm 4's clipped residue offset."""
        r_max = self.cfg.max_relative_offset
        res = batch["residue_index"].long()
        return torch.clamp(res[:, :, None] - res[:, None, :], -r_max,
                           r_max) + r_max

    def embed(self, batch: Dict[str, torch.Tensor]):
        """m (b, s, r, c_m), e (b, S, r, c_e), z (b, r, r, c_z) and the
        masks, in the compute dtype."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        tf = batch["target_feat"].to(dtype)
        rel = F.one_hot(self.relative_position(batch),
                        2 * cfg.max_relative_offset + 1).to(dtype)
        z = (linear(self.embed_tf_zi, tf)[:, :, None]
             + linear(self.embed_tf_zj, tf)[:, None]
             + linear(self.embed_relpos, rel))
        m = (linear(self.embed_msa, batch["msa_feat"].to(dtype))
             + linear(self.embed_tf_m, tf)[:, None])
        e = linear(self.embed_extra, batch["extra_msa_feat"].to(dtype))
        nm = batch["node_mask"].to(dtype)
        masks = {"msa": batch["msa_mask"].to(dtype),
                 "extra": batch["extra_msa_mask"].to(dtype),
                 "pair": (nm[:, :, None] * nm[:, None, :])[..., None],
                 "row": (1.0 - nm) * MASK_VALUE}
        masks["key"] = masks["row"][:, None, :, None]
        return m, e, z, masks

    def _stack(self, blocks, m, z, msa_mask, masks, seeds):
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        context_fn = remat_policies.context_fn(cfg.remat_policy)
        policy = {} if context_fn is None else {"context_fn": context_fn}
        for block, block_seed in zip(blocks, seeds):
            args = (block, m, z, msa_mask, masks["pair"], masks["row"],
                    masks["key"], block_seed)
            if remat:
                m, z = checkpoint(_apply_block, *args,
                                  remat_policies.cache_for(cfg.remat_policy),
                                  use_reentrant=False,
                                  preserve_rng_state=False, **policy)
            else:
                m, z = _apply_block(*args)
        return m, z

    def trunk(self, batch: Dict[str, torch.Tensor], *,
              deterministic: bool = True, seed: Seeds = None):
        """The MSA (b, s, r, c_m) and pair (b, r, r, c_z) representations
        after the last block."""
        cfg = self.cfg
        m, e, z, masks = self.embed(batch)
        count = cfg.num_extra_blocks + cfg.num_blocks
        seeds = [None] * count
        if not deterministic:
            if seed is None:
                raise ValueError("a stochastic forward needs a seed")
            seeds = seed_table(seed, count)
        extra = cfg.num_extra_blocks
        _, z = self._stack(self.extra_blocks, e, z, masks["extra"], masks,
                           seeds[:extra])
        return self._stack(self.blocks, m, z, masks["msa"], masks,
                           seeds[extra:])

    def forward(self, batch: Dict[str, torch.Tensor], *,
                deterministic: bool = True, seed: Seeds = None):
        """Distogram logits (b, r, r, bins) and masked-MSA logits (b, s, r,
        classes)."""
        m, z = self.trunk(batch, deterministic=deterministic, seed=seed)
        d = linear(self.distogram, z)
        return d + d.transpose(1, 2), linear(self.masked_msa, m)
