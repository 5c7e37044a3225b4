"""Stage 3 — gap finetuning on predicted distance bins (counterpart of
tgt_tpu/schemes/finetune.py).

As the reference (lib/training_schemes/pcqm/finetune/scheme.py):
- model: the multi model, started from the stage-2 checkpoint
  (``pretrained_weights_file``, loaded non-strictly by the Trainer);
- input distances: the stage-1 bins through ``bins2dist`` (+0.5,
  symmetrised, zero diagonal); a training batch reads bins sample
  ``current_epoch % S`` (the Trainer sets ``current_epoch`` each epoch),
  evaluation draw i reads sample ``i % S``;
- loss: L1 of the gap plus the ``dist_loss_weight`` cross-entropy against
  the DFT distances.

The bins come from ``bins_input_path`` (the ``bins{S}`` directory that
dist_pred's predict writes), or, on the synthetic dataset, from the
molecules' own coordinates with noise (``_attach_synthetic_bins``).
Evaluation draw i runs under ``derive_seed(seed, i)``; a non-finite draw
is dropped on the device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from tgt_torch.core.config import Config
from tgt_torch.schemes.base import TGTScheme, default_scheme_config
from tgt_torch.schemes.commons import (bins2dist, coords2dist,
                                       discrete_dist_loss, masked_l1)
from tgt_torch.training.harness import derive_seed


class FinetuneScheme(TGTScheme):
    NAME = "finetune"
    MODEL = "multi"

    def __init__(self, overrides=None, command="train"):
        super().__init__(overrides, command)
        self.current_epoch = 0
        self._bins_meta = None

    def _load_bins_meta(self):
        if self._bins_meta is None:
            if self.cfg.bins_input_path:
                from tgt_torch.data.pcqm import read_bins_meta
                m = read_bins_meta(self.cfg.bins_input_path)
                self._bins_meta = (m["num_samples"], m["num_bins"],
                                   m["range_bins"])
            else:       # synthetic: the dataset makes its own bins
                self._bins_meta = (self.cfg.synth_bins_samples,
                                   self.cfg.num_dist_bins,
                                   self.cfg.range_dist_bins)
        return self._bins_meta

    @property
    def bins_num_samples(self):
        return self._load_bins_meta()[0]

    @property
    def bins_num_bins(self):
        return self._load_bins_meta()[1]

    @property
    def bins_range(self):
        return self._load_bins_meta()[2]

    def default_config(self, command: str) -> Config:
        c = default_scheme_config()
        c["save_path_prefix"] = "models/pcqm/finetune"
        c["num_dist_bins"] = 256
        c["range_dist_bins"] = 8.0
        c["dist_loss_weight"] = 0.1
        c["bins_input_path"] = None
        c["bins_shift_half"] = True
        c["bins_zero_diag"] = True
        c["synth_bins_samples"] = 4
        return c

    def extra_columns(self, split: str) -> List:
        from tgt_torch.data.pcqm import Bins, Coords
        cols = [Bins(self.cfg.bins_input_path, self.bins_num_samples)]
        if split == "train" and self.command == "train":
            cols.append(Coords("dft"))
        return cols

    def get_dataset(self, split: str, rank: int = 0, world_size: int = 1):
        ds = super().get_dataset(split, rank, world_size)
        if self.cfg.dataset_source == "synthetic":
            self._attach_synthetic_bins(ds)
        return ds

    def _attach_synthetic_bins(self, ds):
        """Stand-in 'predicted' bins from the synthetic coordinates, so the
        path runs without a stage-1 model: the binned distances plus a
        random shift in [-2, 2] per sample, clipped, upper triangle."""
        ds = getattr(ds, "dataset", ds)      # unwrap a trial-run Subset
        if getattr(ds, "_bins_attached", False):
            return
        rs = np.random.RandomState(7)
        bin_size = self.bins_range / (self.bins_num_bins - 1)
        for row in ds._cache:
            d = np.linalg.norm(row["dft_coords"][:, None]
                               - row["dft_coords"][None, :], axis=-1)
            bins = np.clip((d / bin_size), 0, self.bins_num_bins - 1)
            s = self.bins_num_samples
            noisy = bins[None] + rs.randint(-2, 3, (s,) + bins.shape)
            noisy = np.clip(noisy, 0, self.bins_num_bins - 1)
            row["dist_bins"] = np.triu(noisy, k=1).astype(np.float32)
        ds._bins_attached = True

    def device_keys(self, training: bool = True):
        keys = ["node_features", "distance_matrix", "feature_matrix",
                "node_mask", "target", "dist_bins"]
        if training:
            keys.append("dft_coords")
        return keys

    def device_batch(self, batch, training: bool = True):
        out = super().device_batch(batch, training)
        if training:
            out["bins_sample"] = np.asarray(
                self.current_epoch % self.bins_num_samples, np.int32)
        return out

    def _feed_from_bins(self, batch: Dict[str, torch.Tensor],
                        edge_mask: torch.Tensor, bins: torch.Tensor):
        feed = {k: batch[k] for k in ("node_features", "distance_matrix",
                                      "feature_matrix", "node_mask")}
        feed["edge_mask"] = edge_mask
        feed["dist_input"] = bins2dist(bins, self.bins_num_bins,
                                       self.bins_range,
                                       self.cfg.bins_shift_half,
                                       self.cfg.bins_zero_diag)
        return feed

    @staticmethod
    def _gap_of(out) -> torch.Tensor:
        """The gap of the multi model's (gap, dist_logits) or the gap
        model's output."""
        return out[0] if isinstance(out, tuple) else out

    def loss_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        edge_mask = self.edge_mask_of(batch)
        # the epoch's bins sample, picked on the device (a 0-d index that
        # the Trainer passes to every micro-batch whole)
        sample = batch["bins_sample"].reshape(1).long()
        bins = batch["dist_bins"].index_select(1, sample)[:, 0]
        gap, dist_logits = model(self._feed_from_bins(batch, edge_mask, bins),
                                 deterministic=False, seed=seed)
        prim = masked_l1(gap.float(), batch["target"].float(),
                         self.own_samples(batch), batch.get("sample_count"))
        dist_targ = coords2dist(batch["dft_coords"].float())
        dloss = discrete_dist_loss(dist_logits, self.pair_rows(dist_targ),
                                   self.pair_rows(edge_mask),
                                   self.cfg.num_dist_bins,
                                   self.cfg.range_dist_bins,
                                   count=batch.get("pair_count"))
        loss = prim + self.cfg.dist_loss_weight * dloss
        return loss, {"gap_loss": prim, "dist_loss": dloss}

    def _bins_draws(self, model, batch: Dict[str, torch.Tensor], seed: int):
        """``nb_draw_samples`` gap draws, draw i on stored bins sample
        i % S under ``derive_seed(seed, i)``: (sum of the finite draws in
        f32, their count, every draw's gap)."""
        edge_mask = self.edge_mask_of(batch)
        all_bins = batch["dist_bins"]                  # (b, S, N, N)
        s_avail = all_bins.shape[1]
        acc = torch.zeros(all_bins.shape[0], dtype=torch.float32,
                          device=all_bins.device)
        valid = torch.zeros((), dtype=torch.int32, device=all_bins.device)
        gaps = []
        for i in range(self.nb_draw_samples):
            feed = self._feed_from_bins(batch, edge_mask,
                                        all_bins[:, i % s_avail])
            gap = self._gap_of(model(
                feed, deterministic=not self.cfg.predict_in_train,
                seed=derive_seed(seed, i))).float()
            finite = torch.isfinite(gap).all()
            acc = torch.where(finite, acc + gap, acc)
            valid = valid + finite.to(torch.int32)
            gaps.append(gap)
        return acc, valid, gaps

    @torch.no_grad()
    def eval_fn(self, model, batch: Dict[str, torch.Tensor], seed: int):
        acc, valid, _ = self._bins_draws(model, batch, seed)
        gap = acc / torch.clamp(valid, min=1).float()
        return {"gap_loss": torch.abs(gap - batch["target"].float()),
                "valid_samples": valid}

    def evaluate_predictions(self, preds: Dict[str, np.ndarray]
                             ) -> Dict[str, float]:
        return {"loss": float(np.mean(preds["gap_loss"]))}
