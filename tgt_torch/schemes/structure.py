"""The distogram scheme of AlphaFold 3's Pairformer trunk
(``structure.distogram``; ``models/pairformer.py``). ``tgt_tpu`` has no
counterpart.

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
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from tgt_torch.core.config import Config
from tgt_torch.data.synthetic import SyntheticStructures
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
