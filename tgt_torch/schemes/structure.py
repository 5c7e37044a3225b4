"""The distogram scheme of AlphaFold 3's Pairformer trunk
(``structure.distogram``; ``models/pairformer.py``) and the scheme of AlphaFold
2's Evoformer (``structure.evoformer``; ``models/evoformer.py``). ``tgt_tpu``
has no counterpart.

A structure is one chain of tokens with ``restype``, ``residue_index``,
``asym_id``, its representative atoms' ``coords`` and ``node_mask``; the
synthetic source (``dataset_source: synthetic``) draws them
(``data/synthetic.py``: ``SyntheticStructures``). The loss is the
cross-entropy of the distogram logits against the binned distances of the
representative atoms, averaged over the valid pairs: ``num_dist_bins``
bins on [``dist_min``, ``dist_max``] A, whose ``num_dist_bins - 1`` edges
are evenly spaced from ``dist_min`` to ``dist_max`` (a distance's bin is
the count of edges below it). Evaluation reports the same cross-entropy
per structure, with dropout off.

The optimizer takes the published Adam (``adam_beta1``, ``adam_beta2``,
``adam_eps``) through the Trainer's ``make_optimizer``, and
``lr_schedule: warmup_linear`` gives the published linear warm-up to a
constant rate.

The Evoformer's structures carry an MSA and AlphaFold 2's features
(``data/synthetic.py``: ``SyntheticMSAStructures``, the masked MSA included).
Its loss is ``DISTOGRAM_WEIGHT`` times the distogram's (AlphaFold 2's 64
bins, 63 edges from 2.3125 to 21.6875 A) plus ``MASKED_MSA_WEIGHT`` times
the masked MSA's: the mean cross-entropy of the masked-MSA logits against
the MSA before masking, over the replaced positions (Supplementary sections
1.9.8, 1.9.9; weights 0.3 and 2.0). Its defaults hold the published Adam
(0.9, 0.999, 1e-6), rate (1e-3 after 1,000 warm-up steps) and global-norm
clip (0.1).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from tgt_torch.core.config import Config
from tgt_torch.data.synthetic import (SyntheticMSAStructures,
                                      SyntheticStructures)
from tgt_torch.models.evoformer import EvoformerConfig
from tgt_torch.models.pairformer import PairformerConfig
from tgt_torch.schemes.base import TGTScheme, default_scheme_config
from tgt_torch.schemes.commons import coords2dist
from tgt_torch.training.harness import derive_seed


def distogram_bins(dist: torch.Tensor, num_bins: int, lo: float,
                   hi: float) -> torch.Tensor:
    """The bin of each distance: the count of the ``num_bins - 1`` evenly
    spaced edges from ``lo`` to ``hi`` that lie below it."""
    edges = torch.linspace(lo, hi, num_bins - 1, device=dist.device,
                           dtype=torch.float32)
    return (dist.float()[..., None] > edges).sum(-1)


class DistogramScheme(TGTScheme):
    NAME = "distogram"
    MODEL = "pairformer"
    DEVICE_KEYS = ("restype", "residue_index", "asym_id", "coords",
                   "node_mask")

    def default_config(self, command: str) -> Config:
        c = default_scheme_config()
        for key, value in dict(
                save_path_prefix="models/structure",
                dataset_source="synthetic",
                num_blocks=48, single_width=384, pair_width=128,
                tri_mul_width=128, tri_att_heads=4, tri_att_head_width=32,
                single_heads=16, single_head_width=24,
                transition_multiplier=4, pair_dropout=0.25,
                num_residue_types=32, max_relative_offset=32,
                num_dist_bins=64, dist_min=2.0, dist_max=22.0,
                adam_beta1=0.9, adam_beta2=0.95, adam_eps=1e-8,
                max_lr=1.8e-3, lr_schedule="warmup_linear",
                lr_warmup_steps=1000, batch_size=1,
                synth_min_tokens=16, synth_max_tokens=32,
                buckets=[32]).items():
            c[key] = value
        return c

    def build_model_cfg(self) -> PairformerConfig:
        c = self.cfg
        return PairformerConfig(
            num_blocks=c.num_blocks, single_width=c.single_width,
            pair_width=c.pair_width, tri_mul_width=c.tri_mul_width,
            tri_att_heads=c.tri_att_heads,
            tri_att_head_width=c.tri_att_head_width,
            single_heads=c.single_heads,
            single_head_width=c.single_head_width,
            transition_multiplier=c.transition_multiplier,
            pair_dropout=c.pair_dropout,
            num_residue_types=c.num_residue_types,
            max_relative_offset=c.max_relative_offset,
            num_dist_bins=c.num_dist_bins, compute_dtype=c.compute_dtype,
            remat=c.remat, remat_policy=c.remat_policy or "none",
            use_pallas=c.use_pallas)

    def get_dataset(self, split: str, rank: int = 0, world_size: int = 1):
        if split in self._datasets:
            return self._datasets[split]
        if self.cfg.dataset_source != "synthetic":
            raise ValueError(f"the distogram scheme reads synthetic "
                             f"structures only, not {self.cfg.dataset_source!r}")
        n = (self.cfg.synth_train_samples if split == "train"
             else self.cfg.synth_val_samples)
        ds = SyntheticStructures(
            num_samples=n, min_tokens=self.cfg.synth_min_tokens,
            max_tokens=self.cfg.synth_max_tokens,
            seed={"train": 0, "val": 1, "test": 2}[split])
        self._datasets[split] = ds
        return ds

    def extra_columns(self, split: str) -> List:
        return []

    def targets(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(b, n, n) distogram bins of the representative atoms."""
        c = self.cfg
        return distogram_bins(coords2dist(batch["coords"].float()),
                              c.num_dist_bins, c.dist_min, c.dist_max)

    def _xent(self, logits, batch):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1, self.targets(batch)[..., None])[..., 0]

    def loss_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        """The masked mean cross-entropy of one stochastic forward;
        ``seed`` fixes every dropout mask of the model."""
        mask = self.edge_mask_of(batch)
        logits = model(batch, deterministic=False, seed=derive_seed(seed, 1))
        count = batch.get("pair_count", mask.sum())
        return (self._xent(logits, batch) * mask).sum() / (count + 1e-9), {}

    @torch.no_grad()
    def eval_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        """Per-structure mean cross-entropy over its valid pairs, dropout
        off."""
        mask = self.edge_mask_of(batch)
        xent = self._xent(model(batch, deterministic=True), batch)
        return {"loss": (xent * mask).sum((1, 2))
                / mask.sum((1, 2)).clamp_min(1.0)}

    def evaluate_predictions(self, preds: Dict[str, np.ndarray]
                             ) -> Dict[str, float]:
        return {"loss": float(np.mean(preds["loss"]))}


class EvoformerScheme(DistogramScheme):
    NAME = "evoformer"
    MODEL = "evoformer"
    # the first training stage's loss weights (Supplementary section 1.9)
    DISTOGRAM_WEIGHT, MASKED_MSA_WEIGHT = 0.3, 2.0
    DEVICE_KEYS = ("target_feat", "residue_index", "msa_feat", "msa_mask",
                   "extra_msa_feat", "extra_msa_mask", "true_msa",
                   "bert_mask", "coords", "node_mask")

    def default_config(self, command: str) -> Config:
        c = default_scheme_config()
        for key, value in dict(
                save_path_prefix="models/structure",
                dataset_source="synthetic",
                num_blocks=48, num_extra_blocks=4, msa_width=256,
                extra_msa_width=64, pair_width=128, msa_heads=8,
                msa_head_width=32, extra_msa_heads=8, extra_msa_head_width=8,
                opm_width=32, tri_mul_width=128, tri_att_heads=4,
                tri_att_head_width=32, transition_multiplier=4,
                msa_dropout=0.15, pair_dropout=0.25, max_relative_offset=32,
                num_dist_bins=64, dist_min=2.3125, dist_max=21.6875,
                adam_beta1=0.9, adam_beta2=0.999, adam_eps=1e-6,
                max_lr=1e-3, lr_schedule="warmup_linear",
                lr_warmup_steps=1000, clip_grad_norm=0.1, batch_size=1,
                synth_min_tokens=16, synth_max_tokens=32,
                synth_msa_clusters=8, synth_msa_extra=16,
                buckets=[32]).items():
            c[key] = value
        return c

    def build_model_cfg(self) -> EvoformerConfig:
        c = self.cfg
        return EvoformerConfig(
            num_blocks=c.num_blocks, num_extra_blocks=c.num_extra_blocks,
            msa_width=c.msa_width, extra_msa_width=c.extra_msa_width,
            pair_width=c.pair_width, msa_heads=c.msa_heads,
            msa_head_width=c.msa_head_width,
            extra_msa_heads=c.extra_msa_heads,
            extra_msa_head_width=c.extra_msa_head_width,
            opm_width=c.opm_width, tri_mul_width=c.tri_mul_width,
            tri_att_heads=c.tri_att_heads,
            tri_att_head_width=c.tri_att_head_width,
            transition_multiplier=c.transition_multiplier,
            msa_dropout=c.msa_dropout, pair_dropout=c.pair_dropout,
            max_relative_offset=c.max_relative_offset,
            num_dist_bins=c.num_dist_bins, compute_dtype=c.compute_dtype,
            remat=c.remat, remat_policy=c.remat_policy or "none",
            use_pallas=c.use_pallas)

    def get_dataset(self, split: str, rank: int = 0, world_size: int = 1):
        if split in self._datasets:
            return self._datasets[split]
        c = self.cfg
        if c.dataset_source != "synthetic":
            raise ValueError(f"the evoformer scheme reads synthetic "
                             f"structures only, not {c.dataset_source!r}")
        ds = SyntheticMSAStructures(
            num_samples=(c.synth_train_samples if split == "train"
                         else c.synth_val_samples),
            min_tokens=c.synth_min_tokens, max_tokens=c.synth_max_tokens,
            num_clusters=c.synth_msa_clusters, num_extra=c.synth_msa_extra,
            seed={"train": 0, "val": 1, "test": 2}[split])
        self._datasets[split] = ds
        return ds

    @staticmethod
    def bert_mask_of(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(b, s, r): the masked MSA's replaced positions of the real
        samples."""
        return (batch["bert_mask"].float() * batch["msa_mask"].float()
                * batch["sample_mask"].float()[:, None, None])

    def loss_counts(self, batch: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        counts = super().loss_counts(batch)
        counts["bert_count"] = self.bert_mask_of(batch).sum()
        return counts

    @staticmethod
    def _msa_xent(logits, batch):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.gather(logp, -1,
                             batch["true_msa"].long()[..., None])[..., 0]

    def loss_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        """``DISTOGRAM_WEIGHT`` x the distogram's masked mean cross-entropy
        plus ``MASKED_MSA_WEIGHT`` x the masked MSA's, of one stochastic
        forward; ``seed`` fixes every dropout mask of the model."""
        pairs, bert = self.edge_mask_of(batch), self.bert_mask_of(batch)
        dist_logits, msa_logits = model(batch, deterministic=False,
                                        seed=derive_seed(seed, 1))
        dist = ((self._xent(dist_logits, batch) * pairs).sum()
                / (batch.get("pair_count", pairs.sum()) + 1e-9))
        msa = ((self._msa_xent(msa_logits, batch) * bert).sum()
               / (batch.get("bert_count", bert.sum()) + 1e-8))
        loss = self.DISTOGRAM_WEIGHT * dist + self.MASKED_MSA_WEIGHT * msa
        return loss, {"distogram": dist.detach(), "masked_msa": msa.detach()}

    @torch.no_grad()
    def eval_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        """Per-structure weighted loss over its valid pairs and replaced
        positions, dropout off."""
        pairs, bert = self.edge_mask_of(batch), self.bert_mask_of(batch)
        dist_logits, msa_logits = model(batch, deterministic=True)
        dist = ((self._xent(dist_logits, batch) * pairs).sum((1, 2))
                / pairs.sum((1, 2)).clamp_min(1.0))
        msa = ((self._msa_xent(msa_logits, batch) * bert).sum((1, 2))
               / bert.sum((1, 2)).clamp_min(1.0))
        return {"loss": self.DISTOGRAM_WEIGHT * dist
                + self.MASKED_MSA_WEIGHT * msa}
